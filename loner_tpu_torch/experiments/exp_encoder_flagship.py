"""Flagship-scale encoder experiment: the port of
``scripts/exp_encoder_flagship.py``. Offline optimization
(``mapping/offline.py::optimize_implicit_map``) on a full-extent synthetic
forest at the reference operating point (window 16, 512 + 64 rays a
keyframe, 512 samples, MASK trunk-band sampling, the held-out L1 early stop
at 1.05 m, ``examples/fdt_optimize_implicit_map.py``'s budgets), one run per
encoder spec:

  triad          the shipped triad: CP lines + Fourier (``TriadConfig``'s
                 defaults: no hash level)
  triad_nohash   the triad with its hash level forced off (``hash=0``)
  triad:hash=1   the triad with its fat-row hash level
  fused          the 16-level FusedHash
  cell, packed   the cell-packed and packed hash grids
  <other>        any ``encoding_impl`` (e.g. ``exact``)

A spec may carry triad knobs after a colon: ``triad:hash=1``,
``triad:cp=bf16,hash=0``, ``triad_nohash:fourier=8``, ``triad:hlog2=14``
(``cp=`` the lines' dtype, ``hash=`` levels, ``fourier=`` frequencies,
``cpf=`` features a line, ``hlog2=`` the hash level's log2 cells).

Writes the script's record (per-encoder L1 history, epochs, iterations, wall
time; also the training ms a step, the gate and the kernels' launches) after
every encoder:

    python -m loner_tpu_torch.experiments.exp_encoder_flagship [--device cuda] [--trees 80] [--kfs 40]
        [--encoders triad,fused,cell] [--max-epochs 8] [--small] [--out outputs/exp_encoder_flagship.json]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from loner_tpu_torch.data import synthetic
from loner_tpu_torch.data.scan import make_lidar_scan, sky_scan
from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.experiments import platform
from loner_tpu_torch.geometry.world_cube import compute_world_cube
from loner_tpu_torch.mapping.keyframe import KeyFrame
from loner_tpu_torch.mapping.offline import OfflineConfig, OfflineResult, optimize_implicit_map
from loner_tpu_torch.mapping.optimizer import MapperConfig
from loner_tpu_torch.ops import cp_kernel, fused_encoder, pdf_kernel
from loner_tpu_torch.probes.timing import counts, launches

RAY_RANGE = (2.5, 45.0)  # the Haveri forest operating point
GATE_M = 1.05  # the FDT protocol's held-out L1 (examples/fdt_optimize_implicit_map.py:74)
# (scan channels, azimuths, scan pad, sky pad, rays a keyframe, sky rays, samples a ray)
FULL = (32, 512, 16384, 1024, 512, 64, 512)
SMALL = (8, 128, 2048, 128, 64, 8, 64)
# the kernels an offline run may launch (B1-B5); a record counts each
KERNELS = (cp_kernel.cp_fwd, cp_kernel.cp_bwd, pdf_kernel.pdf_sample, fused_encoder.interp_fwd,
           fused_encoder.interp_dpts)


def forest_keyframes(trees: int = 80, kfs: int = 40, extent: float = 40.0, small: bool = False):
    """(keyframes, cube): the forest of ``trees`` trees over ``extent`` m,
    ``kfs`` ground-truth poses on two circles (radius 0.45 and 0.22 of the
    extent, 1.8 m up), each scan ray-cast on the host (noise 0.01 m) with its
    MASK trunk band."""
    n_channels, n_azimuth, pad, spad = (SMALL if small else FULL)[:4]
    scene = synthetic.Scene.forest(seed=1, extent=extent, n_trees=trees)
    poses_a, ts_a = synthetic.circular_trajectory(n_poses=kfs // 2, radius=extent * 0.45, z=1.8, period=kfs / 2.0)
    poses_b, ts_b = synthetic.circular_trajectory(n_poses=kfs - kfs // 2, radius=extent * 0.22, z=1.8,
                                                  period=kfs / 2.0)
    poses = np.concatenate([poses_a, poses_b])
    ts = np.concatenate([ts_a, ts_b + ts_a[-1] + 1.0])
    cube = compute_world_cube(poses, ray_range=RAY_RANGE, rebase_to_first_pose=False)
    keyframes = []
    rng = np.random.default_rng(0)
    for i, (T, t0) in enumerate(zip(poses, ts)):
        dirs, dists, stamps, hit = synthetic.simulate_scan(scene, T, t0, n_channels=n_channels, n_azimuth=n_azimuth,
                                                           max_range=RAY_RANGE[1], rng=rng, noise_std=0.01)
        scan = make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=pad)
        sky = sky_scan(dirs[~hit][:spad], RAY_RANGE[1] + 1.0, t0, pad_to=spad)
        kf = KeyFrame(scan=scan, timestamp=t0, pose_index=i, tracked_pose=T, gt_pose=T, sky=sky)
        kf.compute_band_indices()  # MASK trunk-band sampling (forest)
        keyframes.append(kf)
    return keyframes, cube


def split_specs(encoders: str) -> List[str]:
    """``--encoders`` as specs: split on commas, a ``knob=value`` piece
    joining the spec before it (``triad:cp=bf16,hash=0,fused`` is two
    specs)."""
    specs = []
    for piece in encoders.split(","):
        if specs and "=" in piece and ":" not in piece:
            specs[-1] += "," + piece
        else:
            specs.append(piece)
    return specs


def mapper_config(spec: str, cube, kfs: int = 40, small: bool = False, point_chunks: int = 2) -> MapperConfig:
    """The mapper of one encoder ``spec`` (the module docstring's forms);
    raises on an unknown knob."""
    rays, sky_rays, samples = (SMALL if small else FULL)[4:]
    cfg = MapperConfig(ray_range=RAY_RANGE, world_scale=float(cube.scale_factor), window_size=16,
                       max_keyframes=max(64, kfs), rays_per_kf=rays, sky_rays_per_kf=sky_rays,
                       n_samples_train=samples, n_samples_test=samples * 2, rays_strategy="MASK",
                       train_point_chunks=point_chunks)
    impl, _, knobs = spec.partition(":")
    triad = cfg.nerf.triad
    if impl == "triad_nohash":
        impl, knobs = "triad", (knobs + ",hash=0").strip(",")
    for kv in filter(None, knobs.split(",")):
        k, v = kv.split("=")
        if k == "cp":
            triad = triad._replace(cp_dtype=v)
        elif k == "hash":
            triad = triad._replace(hash_levels=int(v))
        elif k == "fourier":
            triad = triad._replace(fourier_freqs=int(v))
        elif k == "cpf":
            triad = triad._replace(cp_features=int(v))
        elif k == "hlog2":
            # the triad's hash_log2_cells is the branch encoding's log2_hashmap_size - 2
            enc = cfg.nerf.pos_encoding_sigma._replace(log2_hashmap_size=int(v) + 2)
            cfg = cfg._replace(nerf=cfg.nerf._replace(pos_encoding_sigma=enc))
        else:
            raise ValueError(f"unknown triad knob {k!r}")
    return cfg._replace(nerf=cfg.nerf._replace(encoding_impl=impl, num_colors=1, triad=triad))


def offline_config(max_epochs: int = 8) -> OfflineConfig:
    """The FDT protocol: windows of 16, 32 iterations a window, 6 held-out
    scans of 1024 rays, the exact occupancy update."""
    return OfflineConfig(window_size=16, iterations_per_window=32, max_epochs=max_epochs, n_eval_scans=6,
                         eval_rays_per_scan=1024)


def run_encoder(cfg: MapperConfig, cube, keyframes: List[KeyFrame], offline: OfflineConfig, device,
                log_fn: Callable[[str], None] = print):
    """(record, result): one offline run and its record (the script's keys,
    and the training and eval seconds, the training ms a step, the gate,
    each kernel's launches: 0 on the CPU, where the plain versions run)."""
    dev = resolve_device(device)
    before = counts(KERNELS)
    t0 = time.time()
    res: OfflineResult = optimize_implicit_map(cfg, cube, list(keyframes), offline, log_fn=log_fn, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    train_s = res.wall_time_s - res.eval_time_s
    final = res.l1_history[-1] if res.l1_history else None
    record = {
        "l1_history_m": list(res.l1_history),
        "final_l1_m": final,
        "epochs": res.epochs_run,
        "iterations": res.iterations,
        "wall_time_s": wall,
        "train_s": train_s,
        "eval_s": res.eval_time_s,
        "train_ms_per_step": train_s / res.iterations * 1e3 if res.iterations else None,
        "gate_1p05m": None if final is None else ("PASS" if final < GATE_M else "FAIL"),
        "launches": launches(KERNELS, before),
    }
    return record, res


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trees", type=int, default=80)
    ap.add_argument("--kfs", type=int, default=40)
    ap.add_argument("--extent", type=float, default=40.0)
    ap.add_argument("--encoders", default="triad,fused,cell")
    ap.add_argument("--max-epochs", type=int, default=8)
    ap.add_argument("--point-chunks", type=int, default=2, help="sequential point chunks of a window-16 step")
    ap.add_argument("--small", action="store_true", help="tiny shapes (harness check)")
    ap.add_argument("--out", default=os.path.join("outputs", "exp_encoder_flagship.json"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    specs = split_specs(args.encoders)
    cfgs = {}
    keyframes, cube = forest_keyframes(args.trees, args.kfs, args.extent, args.small)
    for enc in specs:  # every spec parses before the first run
        cfgs[enc] = mapper_config(enc, cube, args.kfs, args.small, args.point_chunks)
    payload = {
        "experiment": "offline forest, SMALL harness check" if args.small
        else "offline forest, flagship operating point",
        "scene": {"trees": args.trees, "extent_m": args.extent, "kfs": args.kfs},
        "ray_range": list(RAY_RANGE),
        "platform": platform(dev),
        "results": {},
    }
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    for enc in specs:
        record, _ = run_encoder(cfgs[enc], cube, keyframes, offline_config(args.max_epochs), dev,
                                log_fn=lambda s, e=enc: print(f"[{e}] {s}", flush=True))
        payload["results"][enc] = record
        print(json.dumps({enc: record}), flush=True)
        with open(args.out, "w") as f:  # after every encoder: a partial record beats none
            json.dump(payload, f, indent=1)
    print("wrote", args.out)
    return payload


if __name__ == "__main__":
    main()
