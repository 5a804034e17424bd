"""Readings that set a training cell's limits, for its chip runs.

    python -m benchmark.readings --workload <cell> --mode <mode> --seeds <a,b,...> --out <file.json>

Modes: ``program`` (the cell's set-up and the check, with the shortest
window: the program's gaps from the reference, the lower reading of each
number), ``control`` (the reference one precision down put in the
program's place) and each of the driver's ``FAULTS`` planted in the
program. Each seed's numbers go to the output file and standard output. The
benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from benchmark.harness import load_cell, load_driver, set_cache_dirs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m benchmark.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True, help="program, control, or one of the driver's FAULTS")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    checkout = Path.cwd()
    set_cache_dirs(checkout)
    cell = load_cell(checkout, args.workload)
    driver = load_driver(cell.mix)
    if not torch.cuda.is_available():
        raise SystemExit("readings are taken on a CUDA device")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = json.loads(out.read_text()) if out.exists() else []
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.time()
        numbers = driver.readings(cell, seed, args.mode, "cuda", checkout / "build" / "benchmark")
        row = {"workload": args.workload, "mode": args.mode, "seed": seed, "seconds": time.time() - t0,
               "numbers": numbers}
        rows.append(row)
        out.write_text(json.dumps(rows, indent=1))
        print(json.dumps({k: row[k] for k in ("mode", "seed", "seconds")} |
                         {k: v for k, v in numbers.items() if "." not in k}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
