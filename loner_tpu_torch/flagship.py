"""The mapper at the flagship operating point, built from a seed.

The counterpart of ``__graft_entry__._flagship``: a window of 8 keyframes on
the synthetic courtyard (a circle of radius 6 m at 1.5 m height), scans of
32 x 512 returns padded to 16384 points plus 1024 sky directions, and the
default ``MapperConfig`` (8 x (512 lidar + 64 sky) rays x 512 samples,
TriadField CP lines at res (16, 32, 64, 128) x 16 + 6 Fourier frequencies,
a 64 x 1 bf16 sigma MLP, OGM sampling, a 100^3 occupancy grid with the
stochastic update). The sizes are arguments so that a test can build it
small; the weights are random, from ``seed``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from loner_tpu_torch.data import synthetic
from loner_tpu_torch.data.scan import make_lidar_scan, sky_scan
from loner_tpu_torch.geometry import se3
from loner_tpu_torch.geometry.world_cube import compute_world_cube
from loner_tpu_torch.mapping.keyframe import KeyFrame, stack_window
from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.mapping.optimizer import MapperConfig, init_mapper_state


def flagship(
    device="cuda",
    seed: int = 0,
    cfg: Optional[MapperConfig] = None,
    n_keyframes: int = 8,
    n_channels: int = 32,
    n_azimuth: int = 512,
    pad_to: int = 16384,
    n_sky: int = 1024,
):
    """(cfg, cube, state, window). ``cfg`` defaults to ``MapperConfig()``;
    its ``world_scale`` and ``ray_range`` are set from the scene."""
    dev = resolve_device(device)
    ray_range = (1.0, 40.0)
    scene = synthetic.Scene.default()
    poses, ts = synthetic.circular_trajectory(n_poses=n_keyframes, radius=6.0, z=1.5)
    cube = compute_world_cube(poses, ray_range=ray_range, rebase_to_first_pose=False)
    cfg = (cfg or MapperConfig())._replace(world_scale=cube.scale_factor, ray_range=ray_range)

    kfs = []
    for i, (T, t0) in enumerate(zip(poses, ts)):
        dirs, dists, stamps, hit = synthetic.simulate_scan(
            scene, T, t0, n_channels=n_channels, n_azimuth=n_azimuth, max_range=ray_range[1]
        )
        scan = make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=pad_to)
        sky = sky_scan(dirs[~hit][:n_sky], ray_range[1] + 1.0, t0, pad_to=n_sky)
        kfs.append(KeyFrame(scan=scan, timestamp=t0, pose_index=i, tracked_pose=T, gt_pose=T, sky=sky))

    window = stack_window(kfs, n_sky_pad=n_sky, device=dev)
    pose6 = se3.matrix_to_pose(torch.as_tensor(np.stack(poses), dtype=torch.float32, device=dev))
    state = init_mapper_state(torch.Generator(device=dev).manual_seed(seed), cfg, dev)
    poses_t = state.poses.clone()
    poses_t[: len(kfs)] = pose6
    return cfg, cube, state._replace(poses=poses_t), window
