"""A cell driven end to end at a tiny size on the CPU through the harness
(skipping only its look for a card), the command's refusal without a card,
and the faults and the control the check must catch."""
import json
import math
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import check, harness
from benchmark.tests.tiny import CHECKOUT, tiny_cell

CELLS = [w["name"] for w in harness.load_bench(CHECKOUT)["workloads"]]
SEED = 3_000_000_019  # over 2**31


def _execute(cell, trace, **overrides):
    return harness.execute(cell, seed=SEED, seconds=0.5, trace=trace, device="cpu", t_start=time.time(),
                           checkout=CHECKOUT, driver_overrides=overrides or None)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_line(name, trace):
    cell = tiny_cell(name)
    r = _execute(cell, trace)
    numbers = r.pop("_numbers")
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(r) == keys
    assert r["correct"] is True, (r["checks"], numbers)
    assert r["attempted"] > 0 and r["failed"] == 0
    wanted = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(r["metrics"]) <= wanted
    if not trace:
        assert set(r["metrics"]) == wanted
    assert set(r["checks"]) == set(cell.limits)
    json.dumps(r)


FAULTS = [(name, fault) for name in CELLS for fault in harness.load_driver(tiny_cell(name).mix).FAULTS]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_faults_come_out_not_correct(name, fault):
    """The run with the timed path broken underneath: ``correct`` is false."""
    r = _execute(tiny_cell(name), False, fault=fault)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_comes_out_not_correct(name):
    """The reference one precision down (fp8 MLP operands, bf16 features)
    in the program's place fails the cell's limits."""
    cell = tiny_cell(name)
    numbers = harness.load_driver(cell.mix).readings(cell, SEED, "control", "cpu", CHECKOUT / "build" / "benchmark")
    assert not check.verdict(numbers, cell.limits), numbers


def test_command_refuses_without_a_card():
    """With no card visible the command exits non-zero and prints nothing."""
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True,
                       timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_fails_without_the_program(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ alone cannot run."""
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import time, sys; from pathlib import Path; from benchmark import harness; "
            "from benchmark.tests.tiny import tiny_cell; "
            f"harness.execute(tiny_cell({CELLS[0]!r}), 1, 0.1, False, 'cpu', time.time(), Path.cwd())")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert p.returncode != 0 and "loner_tpu_torch" in p.stderr


def test_no_jax_after_a_run():
    """A tiny cell's set-up and window in a process of its own load no
    module named jax, jaxlib, flax or loner_tpu (top-level names whole)."""
    code = ("import time, sys, torch; torch.set_num_threads(2); from benchmark import harness; "
            "from benchmark.tests.tiny import tiny_cell, CHECKOUT; "
            f"harness.execute(tiny_cell({CELLS[0]!r}), 5, 0.1, False, 'cpu', time.time(), CHECKOUT); "
            "print(harness.forbidden_loaded()); print('loner_tpu_torch' in sys.modules)")
    p = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split("\n")[-3:-1] == ["[]", "True"]


def test_reference_imports_nothing_of_the_program():
    import ast

    paths = sorted((CHECKOUT / "benchmark" / "reference").rglob("*.py"))
    assert any(p.parent.name == "encoders" for p in paths)
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("loner_tpu_torch", "loner_tpu", "jax", "jaxlib", "flax"), (path, n)


def test_gaps_of_a_missing_reading_are_infinite():
    from benchmark.reference.train import Readings

    ref = Readings({0: 1.0}, {"sigma.a": 1.0, "poses": 1.0}, {"sigma.a": 1.0, "poses": 1.0}, {"poses": 1.0},
                   {"poses": [1]})
    numbers = check.compare(Readings(), ref)
    assert all(math.isinf(numbers[k]) for k in check.NUMBERS)
