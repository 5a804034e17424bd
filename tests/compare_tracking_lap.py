"""Both packages' trackers on the CPU over one synthetic lap, frame by frame.

The lap and settings of chip_smoke.py's loop-closure leg: 126 scans of one
31 m lap at 10 Hz (radius 5 m, period 12.6 s, 32 x 512 returns, noise 0.01),
cfg/defaults.yaml with ray range (1, 40), scan budget 16384, motion
compensation off and loop closure on. Each package's ``Tracker`` (ICP frame
to frame, chained) tracks the scans its frame synthesis accepts, as
``LonerSLAM.process_scan`` does; the mapper is not run, since the tracked
poses do not depend on it. Prints per-frame pose differences, the first
frame where the tracks part by more than ``--part`` metres, both
tracking-only ATEs against the ground truth, and one JSON line last.

    JAX_PLATFORMS=cpu python tests/compare_tracking_lap.py [--frames 126] [--out result.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

OVERRIDES = {
    "data": {"ray_range": [1, 40], "scan_points_budget": 16384},
    "system": {"loop_closure": {"enabled": True}},
    "tracker": {"motion_compensation": {"enabled": False}},
    "mapper": {"keyframe_manager": {"keyframe_selection": {"temporal": {"time_diff_seconds": 0.75}}}},
}


def track(pkg: str, seq: str, n_frames: int):
    """(timestamps, (N, 4, 4) tracked poses, seconds) of one package's tracker."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if pkg == "jax":
        from loner_tpu.config.build import build_slam_config
        from loner_tpu.config.settings import load_settings
        from loner_tpu.data.dataset import SequenceDataset
        from loner_tpu.geometry.world_cube import compute_world_cube
        from loner_tpu.tracking.frame_synthesis import FrameSynthesis
        from loner_tpu.tracking.tracker import Tracker
        kw = {}
    else:
        from loner_tpu_torch.config.build import build_slam_config
        from loner_tpu_torch.config.settings import load_settings
        from loner_tpu_torch.data.dataset import SequenceDataset
        from loner_tpu_torch.geometry.world_cube import compute_world_cube
        from loner_tpu_torch.tracking.frame_synthesis import FrameSynthesis
        from loner_tpu_torch.tracking.tracker import Tracker
        kw = {"device": "cpu"}
    settings = load_settings(os.path.join(repo, "cfg", "defaults.yaml"), overrides=OVERRIDES)
    dataset = SequenceDataset(seq, pad_to=16384)
    cube = compute_world_cube(dataset.gt_poses, tuple(settings.data.ray_range))
    cfg = build_slam_config(settings, float(cube.scale_factor))
    tracker = Tracker(cfg.tracker, **kw)
    synth = FrameSynthesis(cfg.frame_synthesis)
    times, poses = [], []
    t0 = time.perf_counter()
    for i, (scan, ts) in enumerate(dataset):
        if i >= n_frames:
            break
        if not synth.accepts(ts):
            continue
        result = tracker.track(scan, ts)
        times.append(ts)
        poses.append(np.asarray(result.pose, np.float64))
    return np.asarray(times), np.stack(poses), time.perf_counter() - t0, dataset


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=126)
    ap.add_argument("--part", type=float, default=0.01, help="metres: where the tracks part")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from loner_tpu_torch.analysis.metrics import ate_rmse
    from loner_tpu_torch.data.dataset import write_synthetic_dataset

    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        seq = os.path.join(tmp, "lap")
        write_synthetic_dataset(seq, n_poses=126, radius=5.0, period=12.6, n_channels=32, n_azimuth=512,
                                noise_std=0.01)
        tj, pj, sj, dataset = track("jax", seq, args.frames)
        tt, pt, st, _ = track("torch", seq, args.frames)
    assert np.array_equal(tj, tt), "the two frame syntheses kept other frames"
    gt_rel = np.linalg.inv(dataset.gt_poses[0])[None] @ dataset.gt_poses
    ate = {k: float(ate_rmse(p, gt_rel, tj, dataset.gt_times)["rmse"]) for k, p in (("jax", pj), ("torch", pt))}
    d_trans = np.linalg.norm(pj[:, :3, 3] - pt[:, :3, 3], axis=1)
    d_rot = np.abs(pj[:, :3, :3] - pt[:, :3, :3]).max(axis=(1, 2))
    # the frame-to-frame steps: where the relative motions differ
    rel_j = np.linalg.inv(pj[:-1]) @ pj[1:]
    rel_t = np.linalg.inv(pt[:-1]) @ pt[1:]
    d_step = np.linalg.norm(rel_j[:, :3, 3] - rel_t[:, :3, 3], axis=1)
    parted = np.flatnonzero(d_trans > args.part)
    for i in range(len(tj)):
        step = f"{d_step[i - 1]:.3e}" if i else "-"
        print(f"frame {i:3d} t {tj[i]:7.3f}: |dt| {d_trans[i]:.3e} m, max |dR| {d_rot[i]:.3e}, step diff {step} m")
    res = {"frames": len(tj), "ate_tracking_only_m": ate, "max_trans_diff_m": float(d_trans.max()),
           "max_step_diff_m": float(d_step.max()), "first_parted_frame": int(parted[0]) if len(parted) else None,
           "part_threshold_m": args.part, "seconds": {"jax": sj, "torch": st}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**res, "d_trans": d_trans.tolist(), "d_step": d_step.tolist()}, f)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
