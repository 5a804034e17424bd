"""Fields by name: a field block that the modules cannot build is refused at
set-up with its configuration named, a cell whose modules bring no CPU cut
fails, and a new configuration goes in as new files and entries alone."""
import copy
import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest

from benchmark import fields, harness
from benchmark.tests.tiny import CHECKOUT, cut_of, tiny_cell

SEED = 3_000_000_019


@pytest.mark.parametrize("cell_name,change,message", [
    ("triad_cp.nc_quad_online", {"hash_levels": 1}, "hash_levels 1"),
    ("hashgrid.nc_quad_online", {"encoder": "cell"}, "benchmark/fields/cell.py"),
    ("hashgrid.nc_quad_online", {"table_gradient": "strided"}, "table_gradient 'strided'"),
    ("triad_cp.nc_quad_online", {"encoder": "nonesuch"}, "benchmark/fields/nonesuch.py"),
    ("hashgrid.nc_quad_online", {"hash_log2_cells": 17}, "hash_log2_cells 17"),
    ("hashgrid.nc_quad_online", {"intensity_levels": 16}, "reads no ['intensity_levels']"),
    ("triad_cp.nc_quad_render", {"hash_levels": 1}, "hash_levels 1"),
    ("triad_cp.hpk_offline_w16", {"hash_levels": 1}, "hash_levels 1"),
])
def test_a_field_it_cannot_build_is_refused_at_set_up(cell_name, change, message):
    cell = tiny_cell(cell_name)
    cell.config["field"].update(change)
    with pytest.raises(fields.FieldError) as e:
        harness.execute(cell, seed=SEED, seconds=0.1, trace=False, device="cpu", t_start=time.time(),
                        checkout=CHECKOUT)
    assert f"configuration {cell.config['name']!r}" in str(e.value) and message in str(e.value), str(e.value)


def test_a_reference_module_is_needed_too(monkeypatch, tmp_path):
    """A program module with no reference encoder beside it is refused, the
    missing file named."""
    monkeypatch.setattr(fields, "HERE", tmp_path)
    (tmp_path / "cell.py").write_text("")
    config = {"name": "x", "field": {"encoder": "cell"}}
    with pytest.raises(fields.FieldError, match="benchmark/reference/encoders/cell.py"):
        fields.load(config)


def test_a_module_without_a_cut_fails():
    mod = types.ModuleType("benchmark.drivers.uncut")
    mod.__file__ = str(CHECKOUT / "benchmark" / "drivers" / "uncut.py")
    with pytest.raises(LookupError, match="benchmark/drivers/uncut.py brings no CPU cut"):
        cut_of(mod)


_ALIAS = {"fields/fused_again.py": "benchmark.fields.fused",
          "reference/encoders/fused_again.py": "benchmark.reference.encoders.fused"}


def test_a_configuration_is_files_and_entries(tmp_path):
    """In a copy of BENCHMARK.json and benchmark/: a field module and a
    reference encoder that re-export ``fused`` under another name, a
    configuration file naming it, its limits, a configuration entry and a
    cell entry, and the cell appended to ``map_steps_per_s``. No file the
    benchmark has changes, and the new cell's tiny run comes out correct,
    with the hash cell's numbers."""
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    root = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    for rel, module in _ALIAS.items():
        (root / rel).write_text(f'"""{module} under another name."""\nfrom {module} import *  # noqa: F401,F403\n')
    cfg = json.loads((root / "configs" / "loner_hashgrid.json").read_text())
    cfg["name"] = "loner_hashgrid_again"
    cfg["field"]["encoder"] = "fused_again"
    (root / "configs" / "loner_hashgrid_again.json").write_text(json.dumps(cfg))
    limits = root / "limits"
    shutil.copy(limits / "hashgrid.nc_quad_online.json", limits / "hashgrid_again.nc_quad_online.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    entry = copy.deepcopy(next(c for c in bench["configs"] if c["name"] == "loner_hashgrid"))
    entry.update(name="loner_hashgrid_again", file="benchmark/configs/loner_hashgrid_again.json")
    bench["configs"].append(entry)
    bench["workloads"].append({"name": "hashgrid_again.nc_quad_online", "config": "loner_hashgrid_again",
                               "traffic": "nc_quad_online", "chips": 1, "why": "the hash cell under another name"})
    next(m for m in bench["end_to_end"] if m["name"] == "map_steps_per_s")["workloads"].append(
        "hashgrid_again.nc_quad_online")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    assert all(p.read_bytes() == b for p, b in before.items())

    code = ("import json, time, torch; from pathlib import Path; torch.set_num_threads(2); "
            "from benchmark import harness; from benchmark.tests.tiny import tiny_cell; "
            f"r = harness.execute(tiny_cell('hashgrid_again.nc_quad_online'), {SEED}, 0.3, False, 'cpu', "
            "time.time(), Path.cwd()); "
            "print(json.dumps({'correct': r['correct'], 'metrics': sorted(r['metrics']), "
            "'numbers': r['_numbers'], 'file': harness.__file__}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(CHECKOUT)])})
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["file"].startswith(str(tmp_path))
    assert r["correct"] is True and r["metrics"] == ["map_steps_per_s", "setup_s"], r
    same = harness.execute(tiny_cell("hashgrid.nc_quad_online"), SEED, 0.3, False, "cpu", time.time(), CHECKOUT)
    assert r["numbers"] == same["_numbers"]
