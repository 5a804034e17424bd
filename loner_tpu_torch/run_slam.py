"""Online SLAM over an on-disk sequence: the port of ``examples/run_slam.py``.

Loads the YAML settings (a baseline, the sequence's changes, optional
ablation overrides), computes the world cube, streams the scans through
``LonerSLAM`` and writes the run directory: ``full_config.yaml`` and
``.pkl``, ``world_cube.yaml``, ``trajectory/``, the timing CSVs,
``runtime.txt``, and ``ate.yaml`` when the sequence has ground truth.

    python -m loner_tpu_torch.run_slam cfg/defaults.yaml --dataset <dir> [--out outputs/run]
    python -m loner_tpu_torch.run_slam cfg/synthetic_tiny.yaml --synthetic --device cpu
    python -m loner_tpu_torch.run_slam ... --overrides cfg/ablation_study.yaml --num-repeats 3

It runs on the card unless ``--device cpu`` is given. ``--parallel N``
farms the trials of an ablation grid to N spawned worker processes on the
CPU, and so needs ``--device cpu``.
"""
from __future__ import annotations

import argparse
import datetime
import os
import tempfile
import time
from typing import List, Optional

import numpy as np
import yaml

from loner_tpu_torch.device import resolve_device


def run_trial(settings, dataset, out_dir: str, use_gt: bool, profile: bool = False, device="cuda") -> Optional[float]:
    """One SLAM run over ``dataset`` into ``out_dir``; the ATE rmse (m)
    against the sequence's ground truth, or None without one."""
    from loner_tpu_torch.analysis.metrics import ate_rmse
    from loner_tpu_torch.config.build import build_slam_config
    from loner_tpu_torch.geometry.world_cube import compute_world_cube
    from loner_tpu_torch.runtime.profiling import maybe_trace
    from loner_tpu_torch.runtime.trajectory_logger import load_tum
    from loner_tpu_torch.slam import LonerSLAM

    dev = resolve_device(device)
    t_start = time.time()
    os.makedirs(out_dir, exist_ok=True)

    ray_range = tuple(settings.data.ray_range)
    if dataset.gt_poses is not None and settings.system.world_cube.compute_from_groundtruth:
        cube = compute_world_cube(dataset.gt_poses, ray_range)
    else:
        cube = compute_world_cube(None, ray_range, traj_bounding_box=settings.system.world_cube.trajectory_bounding_box)

    slam_cfg = build_slam_config(settings, cube.scale_factor)
    slam_cfg.use_groundtruth_poses = use_gt
    slam = LonerSLAM(slam_cfg, cube, out_dir=out_dir, device=dev)

    settings.dump_yaml(os.path.join(out_dir, "full_config.yaml"))
    settings.dump_pickle(os.path.join(out_dir, "full_config.pkl"))
    with open(os.path.join(out_dir, "world_cube.yaml"), "w") as f:
        yaml.safe_dump(cube.as_dict(), f)

    gt0_inv = None
    n = 0
    with maybe_trace(out_dir, enabled=profile):
        for scan, ts in dataset:
            gt = dataset.gt_pose_at(ts)
            if gt is not None:
                if gt0_inv is None:
                    gt0_inv = np.linalg.inv(gt)
                gt = gt0_inv @ gt  # the tracker's frame is anchored at the first scan
            slam.process_scan(scan, ts, gt_pose=gt)
            n += 1
        slam.stop(out_dir)

    wall = time.time() - t_start
    with open(os.path.join(out_dir, "runtime.txt"), "w") as f:
        f.write(f"{wall:.3f}\n")
    print(f"[run_slam] {n} scans in {wall:.1f}s -> {out_dir}")

    if dataset.gt_poses is None:
        return None
    est, est_t = load_tum(os.path.join(out_dir, "trajectory", "estimated_trajectory.txt"))
    gt_rel = np.linalg.inv(dataset.gt_poses[0])[None] @ dataset.gt_poses
    m = ate_rmse(est, gt_rel, est_t, dataset.gt_times)
    print(f"[run_slam] ATE rmse={m['rmse']:.4f} m over {m['n']} poses")
    with open(os.path.join(out_dir, "ate.yaml"), "w") as f:
        yaml.safe_dump(m, f)
    return m["rmse"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m loner_tpu_torch.run_slam")
    ap.add_argument("config", help="settings yaml (baseline or sequence file)")
    ap.add_argument("--dataset", help="sequence directory (scans/*.npz)")
    ap.add_argument("--synthetic", action="store_true", help="write (once) and run the synthetic sequence")
    ap.add_argument("--out", default=None)
    ap.add_argument("--gt-poses", action="store_true", help="map with ground-truth poses (debug)")
    ap.add_argument("--overrides", help="ablation overrides yaml (dotted path -> list)")
    ap.add_argument("--run-all-combos", action="store_true")
    ap.add_argument("--num-repeats", type=int, default=1)
    ap.add_argument("--profile", action="store_true", help="write a torch.profiler trace under <out>/profile")
    ap.add_argument("--parallel", type=int, default=1,
                    help="worker processes for the trials (ablation grid x repeats), on the CPU: needs --device cpu")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> List[Optional[float]]:
    """Run every trial; returns their ATE rmse (m), in job order."""
    args = _parser().parse_args(argv)
    from loner_tpu_torch.config.settings import generate_options_spec, load_settings
    from loner_tpu_torch.data.dataset import SequenceDataset, write_synthetic_dataset

    if args.parallel > 1 and args.device != "cpu":
        raise SystemExit("--parallel runs the trials on CPU workers: pass --device cpu with it")
    device = resolve_device(args.device)
    settings = load_settings(args.config)
    if args.synthetic:
        root = args.dataset or os.path.join(tempfile.gettempdir(), "loner_tpu_torch_synth")
        if not os.path.isdir(os.path.join(root, "scans")):
            write_synthetic_dataset(root)
        args.dataset = root
    if not args.dataset:
        raise SystemExit("--dataset or --synthetic required")
    pad_to = settings.data.get("scan_points_budget")
    dataset = SequenceDataset(args.dataset, pad_to=pad_to)

    stamp = datetime.datetime.now().strftime("%m%d%y_%H%M%S")
    base_out = args.out or os.path.join(settings.system.get("log_dir_prefix", "outputs/"),
                                        f"{dataset.meta.name}_{stamp}")

    if args.overrides:
        with open(args.overrides) as f:
            overrides = yaml.safe_load(f)
        options = generate_options_spec(settings, overrides, args.run_all_combos)
    else:
        options = [(settings, "baseline")]

    jobs = []
    for ci, (cfg_i, desc) in enumerate(options):
        for trial in range(args.num_repeats):
            out = base_out
            if len(options) > 1:
                out = os.path.join(out, f"config_{ci}_{desc.replace('=', '_')}")
            if args.num_repeats > 1:
                out = os.path.join(out, f"trial_{trial}")
            jobs.append((ci, desc, trial, cfg_i, out))

    if args.parallel <= 1 or len(jobs) <= 1:
        results = []
        for ci, desc, trial, cfg_i, out in jobs:
            print(f"[run_slam] config {ci} ({desc}) trial {trial} -> {out}")
            results.append(run_trial(cfg_i, dataset, out, args.gt_poses, profile=args.profile, device=device))
        return results

    # the trial farm: each trial holds a whole mapper state, and one card
    # cannot be shared, so the workers run on the CPU
    import concurrent.futures as cf
    import multiprocessing as mp

    print(f"[run_slam] farming {len(jobs)} trials over {args.parallel} CPU workers")
    with cf.ProcessPoolExecutor(max_workers=args.parallel, mp_context=mp.get_context("spawn")) as pool:
        futs = [pool.submit(_parallel_worker, cfg_i.to_dict(), args.dataset, pad_to, out, args.gt_poses)
                for _, _, _, cfg_i, out in jobs]
        for (ci, desc, trial, _, _), fut in zip(jobs, futs):
            err = fut.exception()
            print(f"[run_slam] config {ci} ({desc}) trial {trial} done "
                  f"({f'FAILED: {err}' if err else f'ate={fut.result()}'})")
        return [None if f.exception() else f.result() for f in futs]


def _parallel_worker(settings_dict, dataset_path, pad_to, out_dir, use_gt):
    """One farmed trial in a fresh (spawned) process, on the CPU with one
    intra-op thread: the workers' default thread pools would oversubscribe
    the cores."""
    import torch

    from loner_tpu_torch.config.settings import Settings
    from loner_tpu_torch.data.dataset import SequenceDataset

    torch.set_num_threads(1)
    dataset = SequenceDataset(dataset_path, pad_to=pad_to)
    return run_trial(Settings(settings_dict), dataset, out_dir, use_gt, device="cpu")


if __name__ == "__main__":
    main()
