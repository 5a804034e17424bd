"""Keyframe trajectory plots of runs: the port of ``examples/plot_poses.py``.

Reads each run directory's per-keyframe pose states
(``checkpoints/kf_poses.npz``), plots the XY tracks (ground truth and
optimized; with ``--plot-tracked`` the ICP-tracked ones beside) with the
translation RMSE, and writes ``poses.png`` into the run directory or to
``--out``:

    python -m loner_tpu_torch.plot_poses RUN_DIR [RUN_DIR ...] [--plot-tracked] [--title T] [--out poses.png]

Host numpy and matplotlib only: it needs no card.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np


def load_pose_states(run_dir: str):
    """(timestamps, tracked (K, 4, 4), optimized (K, 4, 4), ground truth
    (K, 4, 4) or None) of a run directory's keyframes."""
    path = os.path.join(run_dir, "checkpoints", "kf_poses.npz")
    if not os.path.exists(path):
        path = os.path.join(run_dir, "kf_poses.npz")
    d = np.load(path)
    gt = d["gt"] if bool(np.all(d["has_gt"])) and len(d["gt"]) else None
    return d["timestamps"], d["tracked"], d["optimized"], gt


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Translation RMSE (m) of two pose sequences, without alignment."""
    return float(np.sqrt(np.mean(np.sum((a[:, :3, 3] - b[:, :3, 3]) ** 2, axis=1))))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m loner_tpu_torch.plot_poses")
    ap.add_argument("run_dirs", nargs="+")
    ap.add_argument("--plot-tracked", action="store_true", help="side-by-side ICP-tracked and optimized panels")
    ap.add_argument("--title", default=None)
    ap.add_argument("--out", default=None, help="default: RUN_DIR/poses.png")
    return ap


def _panel(ax, track, gt, name, title):
    def xy(P):
        return P[:, 0, 3], P[:, 1, 3]

    ax.set_aspect("equal")
    if gt is not None:
        ax.plot(*xy(gt), label="Ground Truth")
    ax.plot(*xy(track), label=name)
    start = gt if gt is not None else track
    ax.scatter(*xy(start[:1]), s=20, color="red", label="Start Point")
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Y (m)")
    if title:
        ax.set_title(title)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """One plot a run; returns each run's keyframes, optimized RMSE (None
    without ground truth) and plot path."""
    args = _parser().parse_args(argv)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    results = []
    for run_dir in args.run_dirs:
        ts, tracked, opt, gt = load_pose_states(run_dir)
        if args.plot_tracked:
            fig, axes = plt.subplots(1, 2, figsize=(10, 5))
            for ax, (track, name) in zip(axes, [(tracked, "Tracked"), (opt, "Optimized")]):
                _panel(ax, track, gt, name, name + (f" (RMSE {rmse(track, gt):.3f} m)" if gt is not None else ""))
                ax.legend(loc="upper right", fontsize=7)
        else:
            fig = plt.figure(figsize=(6, 6))
            ax = plt.gca()
            _panel(ax, opt, gt, "Optimized", f"RMSE {rmse(opt, gt):.3f} m" if gt is not None else None)
            ax.legend(loc="upper right")
        if args.title:
            fig.suptitle(args.title)
        plt.tight_layout()
        out = args.out or os.path.join(run_dir, "poses.png")
        plt.savefig(out, dpi=200)
        plt.close(fig)
        err = rmse(opt, gt) if gt is not None else None
        msg = f"[plot_poses] {len(ts)} keyframes -> {out}"
        if err is not None:
            msg += f"  (optimized RMSE {err:.3f} m)"
        print(msg)
        results.append({"run": run_dir, "keyframes": len(ts), "rmse": err, "plot": out})
    return results


if __name__ == "__main__":
    main()
