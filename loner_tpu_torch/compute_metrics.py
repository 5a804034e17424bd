"""Trajectory and map metrics of a run: the port of ``examples/compute_metrics.py``.

    python -m loner_tpu_torch.compute_metrics traj --est <run>/trajectory/estimated_trajectory.txt \\
        --gt <run>/trajectory/groundtruth.txt [--out ate.yaml]
    python -m loner_tpu_torch.compute_metrics map --est est_cloud.pcd --gt gt_cloud.npy [--threshold 0.1]

``traj`` gives the ATE (after timestamp association and SE(3) alignment)
and the RPE; ``map`` the accuracy, completion, chamfer distance, precision,
recall and F-score of a cloud (``.npy`` or ASCII PCD) against a reference
cloud, after an ICP re-alignment unless ``--no-realign``. Host numpy and
scipy only: it needs no card.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import yaml


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m loner_tpu_torch.compute_metrics")
    sub = ap.add_subparsers(dest="mode", required=True)
    t = sub.add_parser("traj")
    t.add_argument("--est", required=True)
    t.add_argument("--gt", required=True)
    t.add_argument("--t-max-diff", type=float, default=0.1)
    t.add_argument("--rpe-delta", type=int, default=1)
    t.add_argument("--out")
    m = sub.add_parser("map")
    m.add_argument("--est", required=True, help=".npy (N, 3) or ASCII PCD")
    m.add_argument("--gt", required=True)
    m.add_argument("--threshold", type=float, default=0.1)
    m.add_argument("--no-realign", action="store_true")
    m.add_argument("--out")
    return ap


def load_cloud(path: str) -> np.ndarray:
    """An (N, 3) cloud from a ``.npy`` file or an ASCII PCD file."""
    if path.endswith(".npy"):
        return np.load(path)
    with open(path) as f:
        lines = f.read().splitlines()
    return np.loadtxt(lines[lines.index("DATA ascii") + 1:])


def main(argv: Optional[List[str]] = None) -> dict:
    """The metrics of ``mode``, printed and written to ``--out`` as yaml."""
    args = _parser().parse_args(argv)
    from loner_tpu_torch.analysis.metrics import ate_rmse, map_metrics, rpe
    from loner_tpu_torch.runtime.trajectory_logger import load_tum

    if args.mode == "traj":
        est, est_t = load_tum(args.est)
        gt, gt_t = load_tum(args.gt)
        result = {"ate": ate_rmse(est, gt, est_t, gt_t, args.t_max_diff), "rpe": rpe(est, gt, args.rpe_delta)}
    else:
        result = map_metrics(load_cloud(args.est), load_cloud(args.gt), f_score_threshold=args.threshold,
                             realign=not args.no_realign)
    print(yaml.safe_dump(result, default_flow_style=False))
    if args.out:
        with open(args.out, "w") as f:
            yaml.safe_dump(result, f)
    return result


if __name__ == "__main__":
    main()
