"""The benchmark harness: finds a cell by name and runs it.

Everything is found by name from ``BENCHMARK.json`` at the checkout's root:
the cell's configuration file, its traffic mix (``traffic/<mix>.json``,
whose ``driver`` names the general driver in ``drivers/`` that reads it),
its limits (``limits/<cell>.json``) and one reader per per-layer metric
(``metrics/<metric>.py``, or ``metrics/<quantity>.py`` for a metric
``<quantity>.<split>``: a function ``read(ctx)`` returning the number in the
metric's unit, or None where it finds nothing to read). Below them, the
configuration's field is found by its encoder (``fields/<encoder>.py``,
``reference/encoders/<encoder>.py``) and each kernel's counts by its name
(``roofline/kernels/<kernel>.py``). Adding a cell, a configuration, a
field, a kernel, a mix or a metric adds files and entries; nothing here
changes.

A run prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each compared number
with its limit, which also end standard error.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from benchmark import check

ROOT = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "loner_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Optional[dict]


@dataclass
class LayerContext:
    """What the per-layer readers read."""

    config: dict
    mix: dict
    trace: object = None  # trace.TraceSummary of the traced stretch, or None
    traced_steps: int = 0
    # kernel -> [(points a launch takes, launches)] in the traced stretch
    launches: Dict[str, List[Tuple[int, int]]] = field(default_factory=dict)
    window_steps: int = 0
    window_s: float = 0.0
    host_step_s: List[float] = field(default_factory=list)  # host seconds inside each step call
    step_span: str = "loner.step"  # the program's span around each step, its stages named under it
    peak_window_bytes: int = 0
    flops_per_step: float = 0.0


@dataclass
class Outcome:
    """What a driver hands back."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    numbers: Dict[str, float]  # compared numbers (and their per-leaf parts)
    memory_peak_bytes: int
    layer: LayerContext


def load_bench(checkout: Path) -> dict:
    return json.loads((checkout / "BENCHMARK.json").read_text())


def load_cell(checkout: Path, name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or load_bench(checkout)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((checkout / cfg_entry["file"]).read_text())
    mix = json.loads((ROOT / "traffic" / f"{w['traffic']}.json").read_text())

    def applies(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    limits_path = ROOT / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text())["limits"] if limits_path.exists() else None
    return Cell(name, w["chips"], config, mix, e2e, layer, limits)


def load_reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``, or where there is none, that of the
    quantity the name splits (``metrics/idle_share.py`` for ``idle_share.map``
    and ``idle_share.render``)."""
    path = ROOT / "metrics" / f"{name}.py"
    if not path.exists():
        path = ROOT / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_driver(mix: dict):
    return importlib.import_module(f"benchmark.drivers.{mix['driver']}")


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
            checkout: Path, driver_overrides: Optional[dict] = None) -> dict:
    """Run the cell and return its result object (not yet printed)."""
    driver = load_driver(cell.mix)
    out: Outcome = driver.run(cell, seed=seed, seconds=seconds, trace=trace, device=device, t_start=t_start,
                              work_dir=checkout / "build" / "benchmark", **(driver_overrides or {}))
    limits = cell.limits or {}
    checks = {k: {"value": float(out.numbers.get(k, math.inf)), "limit": v} for k, v in limits.items()}
    correct = check.verdict(out.numbers, limits) and out.failed == 0
    device_info = device_record(device, out.memory_peak_bytes)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = load_reader(m["name"])(out.layer)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        summary = out.layer.trace
        device_info["busy_s"] = summary.busy_s if summary is not None else 0.0
        device_info["window_s"] = summary.window_s if summary is not None else 0.0
    else:
        metrics = {m["name"]: {"value": float(out.end_to_end[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in out.end_to_end}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
              "device": device_info}
    if trace and out.layer.trace is not None:
        result["breakdown"] = out.layer.trace.breakdown()
    if not limits:
        checks["limits"] = {"value": "missing", "limit": f"limits/{cell.name}.json"}
    result["checks"] = checks
    result["_numbers"] = out.numbers
    return result


def device_record(device: str, peak: int) -> dict:
    import torch

    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def forbidden_loaded() -> List[str]:
    """Modules whose top-level name is one of :data:`FORBIDDEN_MODULES`."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def set_cache_dirs(checkout: Path) -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    cache = checkout / "build" / "benchmark" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv: Optional[List[str]], t_start: float) -> int:
    args = _parser().parse_args(argv)
    checkout = Path.cwd()
    bench = load_bench(checkout)
    cell = load_cell(checkout, args.workload, bench)
    set_cache_dirs(checkout)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[bench] {args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result", file=sys.stderr)
        return 2
    t_torch = time.time() - t_start
    torch.zeros(1, device="cuda")
    print(f"[bench] set-up: torch imported at {t_torch:.2f} s, CUDA context at {time.time() - t_start:.2f} s",
          file=sys.stderr)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start, checkout)
    bad = forbidden_loaded()
    if bad:
        print(f"[bench] modules of JAX or the JAX package were loaded: {bad}: no result", file=sys.stderr)
        return 3
    numbers = result.pop("_numbers")
    for k in sorted(numbers):
        print(f"[bench] reading {k} = {numbers[k]!r}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
