"""Offline implicit-map optimization from ground-truth poses (the FDT
workload): the port of ``examples/optimize_implicit_map.py``.

Builds a keyframe from every scan of a sequence with its slerp-interpolated
ground-truth pose, trains the sigma field in epochs with the held-out L1
early stop, and writes ``checkpoints/``, ``world_cube.yaml``,
``full_config.pkl`` and ``l1_history.json`` under ``--out`` (with
``--submaps``: one directory per submap and the submap index).

    python -m loner_tpu_torch.optimize_implicit_map cfg/defaults.yaml --dataset <dir> \\
        [--out outputs/map] [--epochs 8] [--window 16] [--submaps]

It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import numpy as np
import yaml

from loner_tpu_torch.device import resolve_device


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m loner_tpu_torch.optimize_implicit_map")
    ap.add_argument("config")
    ap.add_argument("--dataset", required=False)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--out", default="outputs/implicit_map")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--its-per-window", type=int, default=32)
    ap.add_argument("--l1-threshold", type=float, default=1.05)
    ap.add_argument("--submaps", action="store_true", help="segment + per-submap optimization")
    ap.add_argument("--segment-length", type=float, default=50.0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None):
    """The OfflineResult, or with ``--submaps`` (SubmapCollection, results)."""
    args = _parser().parse_args(argv)
    from loner_tpu_torch.config.build import build_mapper_config
    from loner_tpu_torch.config.settings import load_settings
    from loner_tpu_torch.data.dataset import SequenceDataset, interpolate_gt_poses, write_synthetic_dataset
    from loner_tpu_torch.data.scan import sky_scan
    from loner_tpu_torch.geometry.world_cube import compute_world_cube
    from loner_tpu_torch.mapping.keyframe import KeyFrame
    from loner_tpu_torch.mapping.offline import OfflineConfig, optimize_implicit_map
    from loner_tpu_torch.mapping.submaps import segment_and_optimize_submaps
    from loner_tpu_torch.runtime.checkpoints import save_checkpoint

    device = resolve_device(args.device)
    settings = load_settings(args.config)
    if args.synthetic:
        root = args.dataset or os.path.join(tempfile.gettempdir(), "loner_tpu_torch_synth")
        if not os.path.isdir(os.path.join(root, "scans")):
            write_synthetic_dataset(root)
        args.dataset = root
    if not args.dataset:
        raise SystemExit("--dataset or --synthetic required")
    dataset = SequenceDataset(args.dataset, pad_to=settings.data.get("scan_points_budget"))
    if dataset.gt_poses is None:
        raise SystemExit("offline optimization needs the sequence's poses_gt.tum")

    ray_range = tuple(settings.data.ray_range)
    cube = compute_world_cube(dataset.gt_poses, ray_range, rebase_to_first_pose=False)
    cfg = build_mapper_config(settings, cube.scale_factor)
    cfg = cfg._replace(max_keyframes=max(cfg.max_keyframes, len(dataset) + 8))

    keyframes = []
    sky_budget = settings.data.get("sky_points_budget", 4096)
    for i in range(len(dataset)):
        scan, ts = dataset.load_scan(i)
        gt = interpolate_gt_poses(dataset.gt_poses, dataset.gt_times, np.asarray([ts]))[0]
        sky_dirs = dataset.sky_directions(i)
        sky = None if sky_dirs is None else sky_scan(sky_dirs[:sky_budget], ray_range[1] + 1.0, ts, pad_to=sky_budget)
        keyframes.append(KeyFrame(scan=scan, timestamp=ts, pose_index=i, tracked_pose=gt, gt_pose=gt, sky=sky))

    os.makedirs(args.out, exist_ok=True)
    offline = OfflineConfig(window_size=args.window, iterations_per_window=args.its_per_window,
                            max_epochs=args.epochs, l1_stop_threshold=args.l1_threshold, log_dir=args.out)

    if args.submaps:
        collection, results = segment_and_optimize_submaps(
            cfg, keyframes, segment_length_m=args.segment_length, offline=offline, out_dir=args.out, cube=cube,
            device=device)
        for name, res in zip(collection.names, results):
            save_checkpoint(os.path.join(args.out, name, "checkpoints"), res.iterations, res.state)
            print(f"[{name}] L1 history: {[round(x, 3) for x in res.l1_history]}")
        return collection, results

    result = optimize_implicit_map(cfg, cube, keyframes, offline, device=device)
    save_checkpoint(os.path.join(args.out, "checkpoints"), result.iterations, result.state)
    with open(os.path.join(args.out, "world_cube.yaml"), "w") as f:
        yaml.safe_dump(cube.as_dict(), f)
    settings.dump_pickle(os.path.join(args.out, "full_config.pkl"))
    print(f"[optimize_implicit_map] epochs={result.epochs_run} "
          f"L1 history={[round(x, 3) for x in result.l1_history]} wall={result.wall_time_s:.0f}s")
    return result


if __name__ == "__main__":
    main()
