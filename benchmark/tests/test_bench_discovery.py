"""BENCHMARK.json: every cell, configuration, field, mix, metric, limit and
CPU cut is found by name, and the file keeps the benchmark's contract."""
import json
import re

import pytest

from benchmark import fields
from benchmark.harness import ROOT, load_bench, load_cell, load_driver, load_reader
from benchmark.tests.tiny import CHECKOUT, cut_of

BENCH = load_bench(CHECKOUT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_found_by_name(cell):
    c = load_cell(CHECKOUT, cell)
    assert c.chips == 1
    assert c.limits, f"limits/{cell}.json"
    assert (ROOT / "drivers" / f"{c.mix['driver']}.py").exists()
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(load_reader(m["name"]))
    cut_of(load_driver(c.mix))  # the driver's and the field module's CPU cuts are there
    cut_of(fields.load(c.config))


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert "bound" not in m and 1 <= len(m["layer"]) <= 200
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (ROOT / "traffic" / f"{w['traffic']}.json").exists()


def test_config_files():
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        cfg = json.loads((CHECKOUT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        blocks = [b for k, b in cfg.items() if isinstance(b, dict) and k not in ("published", "why_reduced")]
        for key in c["reduced"]:
            held = [b[key] for b in blocks if key in b]
            assert key in cfg["published"] and held and all(v != cfg["published"][key] for v in held), key
        assert cfg["field"]["compute_dtype"] == cfg["compute_dtype"] == "bfloat16"
        assert cfg["assumed"]
