"""The multi-device dry run: the port of ``__graft_entry__.dryrun_multichip``.

One train step of a tiny mapper over an n-device mesh with the window's
keyframes data-parallel (DP), and, when n >= 4 and even, one step over an
(n / 2, 2) mesh with the hash tables split over "model" (DP x TP). The
tiny config keeps the triad's hash level on so that DP x TP has a table
(whose 2^10 cells stay whole, under the 4096-cell rule, as in the JAX
package's dry run).

    python -m loner_tpu_torch.multichip [N] [--device cuda:0]

runs it over the first N cards (8 by default), or over ``--device``
repeated N times (``cpu`` off the card).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Run the dry run over ``devices`` (``n_devices`` of them, repeats
    allowed), or over the first ``n_devices`` cards when None; print one
    line per leg and return their losses (``{"dp": ..., "dp_tp": ...}``)."""
    from loner_tpu_torch.data import synthetic
    from loner_tpu_torch.data.scan import make_lidar_scan, sky_scan
    from loner_tpu_torch.geometry import se3
    from loner_tpu_torch.geometry.world_cube import compute_world_cube
    from loner_tpu_torch.mapping.keyframe import KeyFrame, stack_window
    from loner_tpu_torch.mapping.optimizer import MapperConfig, TrainStepFlags, init_mapper_state
    from loner_tpu_torch.models.hash_encoding import HashEncodingConfig
    from loner_tpu_torch.models.nerf import NeRFConfig
    from loner_tpu_torch.models.occupancy_grid import OccGridConfig
    from loner_tpu_torch.parallel.sharding import Mesh, make_mesh, make_sharded_train_step
    from loner_tpu_torch.parallel.tp import make_tp_train_step

    if devices is None:
        mesh = make_mesh(n_devices)
    else:
        if len(devices) != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) given {len(devices)} devices")
        mesh = Mesh(list(devices), ("data",))
    dev = mesh.first_device

    scene = synthetic.Scene.default()
    poses, ts = synthetic.circular_trajectory(n_poses=n_devices, radius=6.0, z=1.5)
    cube = compute_world_cube(poses, ray_range=(1.0, 40.0), rebase_to_first_pose=False)
    nerf = NeRFConfig(
        num_colors=1,
        pos_encoding_sigma=HashEncodingConfig(n_levels=4, log2_hashmap_size=12),
        pos_encoding_intensity=HashEncodingConfig(n_levels=2, log2_hashmap_size=10),
        sigma_hidden_dim=16,
        intensity_hidden_dim=16,
        intensity_hidden_layers=1,
    )
    nerf = nerf._replace(triad=nerf.triad._replace(hash_levels=1))
    cfg = MapperConfig(
        nerf=nerf,
        occ=OccGridConfig(voxel_size=16),
        ray_range=(1.0, 40.0),
        world_scale=float(cube.scale_factor),
        window_size=n_devices,
        max_keyframes=max(16, n_devices),
        rays_per_kf=64,
        sky_rays_per_kf=8,
        n_samples_train=32,
        n_samples_test=32,
    )

    kfs = []
    for i, (T, t0) in enumerate(zip(poses, ts)):
        dirs, dists, stamps, hit = synthetic.simulate_scan(scene, T, t0, n_channels=4, n_azimuth=64, max_range=40.0)
        scan = make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=256)
        sky = sky_scan(dirs[~hit][:16], cfg.ray_range[1] + 1.0, t0, pad_to=16)
        kfs.append(KeyFrame(scan=scan, timestamp=t0, pose_index=i, tracked_pose=T, gt_pose=T, sky=sky))
    window = stack_window(kfs, n_sky_pad=16, device=dev)
    state = init_mapper_state(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    pose6 = se3.matrix_to_pose(torch.as_tensor(np.stack(poses), dtype=torch.float32, device=dev))
    p = state.poses.clone()
    p[: len(kfs)] = pose6
    state = state._replace(poses=p)

    flags = TrainStepFlags(freeze_sigma=False, freeze_rgb=True, freeze_poses=False, do_occ_update=True)
    pose_mask = torch.ones((cfg.max_keyframes,), device=dev)
    step = make_sharded_train_step(cfg, cube, mesh, generator=torch.Generator(device=dev).manual_seed(1))
    _, aux = step(state, window, flags, pose_mask, 0)
    losses = {"dp": float(aux["loss"])}
    if not np.isfinite(losses["dp"]):
        raise AssertionError(f"non-finite loss in multichip dryrun: {losses['dp']}")
    print(f"dryrun_multichip({n_devices}): DP OK, loss={losses['dp']:.4f}")

    # DP x TP: hash tables over "model" (cell axis), keyframes over "data"
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2 = Mesh(mesh.devices.reshape(n_devices // 2, 2), ("data", "model"))
        tp_step = make_tp_train_step(cfg, cube, mesh2, generator=torch.Generator(device=dev).manual_seed(1))
        _, tp_aux = tp_step(state, window, flags, pose_mask, 0)
        losses["dp_tp"] = float(tp_aux["loss"])
        if not np.isfinite(losses["dp_tp"]):
            raise AssertionError(f"non-finite loss in TP dryrun: {losses['dp_tp']}")
        print(f"dryrun_multichip({n_devices}): DPxTP OK, loss={losses['dp_tp']:.4f}")
    return losses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m loner_tpu_torch.multichip")
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None,
                    help="run over this device repeated N times (cuda:0, cpu); default: the first N cards")
    args = ap.parse_args(argv)
    devices = None if args.device is None else [args.device] * args.n_devices
    return dryrun_multichip(args.n_devices, devices)


if __name__ == "__main__":
    main()
