"""Per-configuration tables of many runs: the port of ``examples/summarize_results.py``.

Walks an output tree of run directories (``config_*/trial_*`` as
``run_slam --overrides ... --num-repeats N`` writes them), collects each
run's ``ate.yaml``, ``runtime.txt`` and ``l1_history.json``, groups the
trials of a configuration, and prints each metric's mean and standard
deviation (and writes them as CSV with ``--csv``):

    python -m loner_tpu_torch.summarize_results <output tree> [--csv summary.csv]

Host only: it needs no card.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import yaml

_RUN_FILES = ("ate.yaml", "runtime.txt", "l1_history.json")


def collect_run(run_dir: str) -> Dict[str, float]:
    """A run directory's ATE rmse, runtime (s) and final L1, where present."""
    out = {}
    ate = os.path.join(run_dir, "ate.yaml")
    if os.path.exists(ate):
        with open(ate) as f:
            out["ate_rmse"] = yaml.safe_load(f)["rmse"]
    rt = os.path.join(run_dir, "runtime.txt")
    if os.path.exists(rt):
        with open(rt) as f:
            out["runtime_s"] = float(f.read().strip())
    l1 = os.path.join(run_dir, "l1_history.json")
    if os.path.exists(l1):
        with open(l1) as f:
            hist = json.load(f)
        if hist:
            out["l1_final"] = hist[-1]
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m loner_tpu_torch.summarize_results")
    ap.add_argument("root", help="output tree root")
    ap.add_argument("--csv", help="write csv here")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, tuple]]:
    """{configuration: {metric: (mean, std)}} over the tree's runs; a run
    directory ``.../trial_<n>`` counts as a trial of its parent."""
    args = _parser().parse_args(argv)
    groups: Dict[str, List[dict]] = {}
    for dirpath, _, filenames in os.walk(args.root):
        if any(f in filenames for f in _RUN_FILES):
            metrics = collect_run(dirpath)
            if metrics:
                rel = os.path.relpath(dirpath, args.root)
                cfg = os.path.dirname(rel) if os.path.basename(rel).startswith("trial_") else rel
                groups.setdefault(cfg, []).append(metrics)

    keys = sorted({k for trials in groups.values() for m in trials for k in m})
    print(f"{'config':40s} " + " ".join(f"{k:>18s}" for k in keys))
    lines = ["config," + ",".join(f"{k}_mean,{k}_std" for k in keys)]
    summary = {}
    for cfg in sorted(groups):
        cells, csv_cells, summary[cfg] = [], [cfg], {}
        for k in keys:
            vals = [t[k] for t in groups[cfg] if k in t]
            if vals:
                m, s = float(np.mean(vals)), float(np.std(vals))
                summary[cfg][k] = (m, s)
                cells.append(f"{m:>10.4f}+-{s:<6.4f}")
                csv_cells += [f"{m:.6f}", f"{s:.6f}"]
            else:
                cells.append(f"{'-':>18s}")
                csv_cells += ["", ""]
        print(f"{cfg:40s} " + " ".join(cells))
        lines.append(",".join(csv_cells))
    if args.csv:
        with open(args.csv, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"\nwrote {args.csv}")
    return summary


if __name__ == "__main__":
    main()
