"""End-to-end quality record at the reference operating point: the port of
``scripts/exp_quality_flagship.py``. One ONLINE synthetic run through the
full ``cfg/defaults.yaml`` budgets (window 8, 512 + 64 rays, 512 samples,
1000 iterations on the first keyframe then 50 a keyframe, TEMPORAL
keyframes, 5 Hz decimation) with loop closure, reporting the tracking-only
and the refined (estimated) ATE, the mapper's median its/s (against the
real-time budget of 16.7) and the wall time; and the OFFLINE held-out L1 at
full budgets (the FDT gate, L1 < 1.05 m): the ``triad`` run of
:mod:`loner_tpu_torch.experiments.exp_encoder_flagship`, in-process.

    python -m loner_tpu_torch.experiments.exp_quality_flagship [--device cuda]
        [--out outputs/exp_quality_flagship.json] [--run-dir outputs/quality_flagship_run] [--n-poses 126]
        [--skip-offline] [--skip-online] [--small]

``--small`` is a harness check: 8 x 64 returns, ``cfg/synthetic_tiny.yaml``'s
model and budgets with its keyframe schedule cut, and the offline half at
the encoder experiment's ``--small --kfs 8 --max-epochs 1``.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from loner_tpu_torch.bench import REALTIME_FLOOR_ITS_PER_SEC
from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.experiments import exp_encoder_flagship, platform
from loner_tpu_torch.probes.timing import counts, launches

REPO = Path(__file__).resolve().parents[2]
# the script's changes to cfg/defaults.yaml
ONLINE_OVERRIDES = {
    "data": {"ray_range": [1, 40], "scan_points_budget": 16384},
    "system": {"loop_closure": {"enabled": True}},
    # the synthetic scans are instantaneous (simulated from a static pose,
    # nominal per-point stamps): per-point motion compensation would warp
    # rigid geometry; it stays on for real sequences
    "tracker": {"motion_compensation": {"enabled": False}},
    "mapper": {"keyframe_manager": {"keyframe_selection": {"temporal": {"time_diff_seconds": 1.5}}}},
}
# --small: the tiny config's budgets, its keyframe schedule cut
SMALL_OVERRIDES = {
    "data": {"scan_points_budget": 4096},
    "mapper": {"optimizer": {"keyframe_schedule": [
        {"num_keyframes": 1, "iteration_schedule": [
            {"num_iterations": 6, "freeze_poses": True, "freeze_sigma_mlp": False, "freeze_rgb_mlp": True}]},
        {"num_keyframes": -1, "iteration_schedule": [
            {"num_iterations": 3, "freeze_poses": False, "freeze_sigma_mlp": False, "freeze_rgb_mlp": True}]},
    ]}},
}


def online_settings(small: bool = False, overrides: Optional[dict] = None):
    """``cfg/defaults.yaml`` (``--small``: ``cfg/synthetic_tiny.yaml`` with
    its schedule cut) with the script's changes, then ``overrides``."""
    from loner_tpu_torch.config.settings import load_settings

    cfg = REPO / "cfg" / ("synthetic_tiny.yaml" if small else "defaults.yaml")
    settings = load_settings(str(cfg), overrides=ONLINE_OVERRIDES)
    for extra in (SMALL_OVERRIDES if small else None, overrides):
        if extra:
            settings = settings.augment(extra)
    return settings


def run_online(run_dir: str, n_poses: int = 126, device="cuda", small: bool = False,
               overrides: Optional[dict] = None) -> dict:
    """The full-budget online run on the synthetic loop through the cfg tier
    (``run_slam.run_trial``, the path a user runs): one 31 m lap of
    ``n_poses`` scans at 10 Hz (radius 5 m, 32 x 512 returns, noise 0.01),
    written under ``run_dir``/seq once, the run in ``run_dir``/run.
    ``overrides`` go over the script's changes (a caller's keyframe spacing,
    for one)."""
    from loner_tpu_torch import run_slam
    from loner_tpu_torch.analysis.metrics import ate_rmse
    from loner_tpu_torch.data import synthetic
    from loner_tpu_torch.data.dataset import SequenceDataset, write_synthetic_dataset
    from loner_tpu_torch.runtime.trajectory_logger import load_tum

    dev = resolve_device(device)
    root = os.path.join(run_dir, "seq")
    if not os.path.isdir(os.path.join(root, "scans")):
        # a 31 m loop at 10 Hz (decimated to 5 Hz: about 0.5 m a processed
        # frame); write_synthetic_dataset runs one lap over ``period`` s
        write_synthetic_dataset(root, scene=synthetic.Scene.default(), n_poses=n_poses, radius=5.0,
                                period=n_poses / 10.0, n_channels=8 if small else 32,
                                n_azimuth=64 if small else 512, noise_std=0.01)
    settings = online_settings(small, overrides)
    dataset = SequenceDataset(root, pad_to=int(settings.data.scan_points_budget))
    out = os.path.join(run_dir, "run")
    before = counts(exp_encoder_flagship.KERNELS)
    t0 = time.time()
    ate_est = run_slam.run_trial(settings, dataset, out, use_gt=False, device=dev)
    wall = time.time() - t0

    gt_rel = np.linalg.inv(dataset.gt_poses[0])[None] @ dataset.gt_poses
    track, t_track = load_tum(os.path.join(out, "trajectory", "tracking_only.txt"))
    ate_track = ate_rmse(track, gt_rel, t_track, dataset.gt_times)["rmse"]
    with open(os.path.join(out, "timing.csv")) as f:
        its_per_sec = [float(row["its_per_sec"]) for row in csv.DictReader(f)]
    ba_info = None
    ba_path = os.path.join(out, "ba_info.json")
    if os.path.exists(ba_path):
        with open(ba_path) as f:
            ba_info = json.load(f)
    median = float(np.median(its_per_sec)) if its_per_sec else None
    return {
        "n_scans": len(dataset),
        "wall_time_s": wall,
        "ate_tracking_only_m": float(ate_track),
        "ate_estimated_m": float(ate_est),
        "ba": ba_info,
        "median_its_per_sec": median,
        "realtime_its_per_sec": REALTIME_FLOOR_ITS_PER_SEC,
        "keyframe_spacing_s": float(settings.mapper.keyframe_manager.keyframe_selection.temporal.time_diff_seconds),
        "launches": launches(exp_encoder_flagship.KERNELS, before),
    }


def run_offline(device="cuda", small: bool = False) -> dict:
    """The flagship offline forest run of the default-protocol ``triad``
    encoder, as the encoder experiment runs it."""
    dev = resolve_device(device)
    enc = exp_encoder_flagship
    kfs = 8 if small else 40
    keyframes, cube = enc.forest_keyframes(kfs=kfs, small=small)
    cfg = enc.mapper_config("triad", cube, kfs, small)
    record, _ = enc.run_encoder(cfg, cube, keyframes, enc.offline_config(1 if small else 8), dev,
                                log_fn=lambda s: print(f"[triad] {s}", flush=True))
    return record


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("outputs", "exp_quality_flagship.json"))
    ap.add_argument("--run-dir", default=os.path.join("outputs", "quality_flagship_run"))
    ap.add_argument("--n-poses", type=int, default=126,
                    help="one 12.6 s lap at 10 Hz: about 0.5 m a processed (5 Hz) frame, inside ICP's "
                         "identity-init capture range")
    ap.add_argument("--skip-offline", action="store_true")
    ap.add_argument("--skip-online", action="store_true")
    ap.add_argument("--small", action="store_true", help="tiny shapes (harness check)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    payload = {"experiment": "online SLAM + offline FDT at the reference operating point"
               + (", SMALL harness check" if args.small else ""), "platform": platform(dev)}
    if not args.skip_online:
        payload["online"] = run_online(args.run_dir, args.n_poses, dev, args.small)
        print(json.dumps({"online": payload["online"]}), flush=True)
    if not args.skip_offline:
        payload["offline"] = run_offline(dev, args.small)
        print(json.dumps({"offline": payload["offline"]}), flush=True)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print("wrote", args.out)
    return payload


if __name__ == "__main__":
    main()
