"""The CellHash field of the PyTorch port trains: the convergence check of
tests/test_cell_hash.py (TestConvergenceParity) on the port, on the CPU.
The tiny mapper of tests/test_train_step.py (8 levels of 2^15 vertices for
sigma, 128 samples a ray, 4 keyframes of 16 x 256 returns) with
``encoding_impl="cell"`` (its default level1 table gradient with corner
sampling) takes 300 pose-frozen steps, the occupancy grid updated every
10th; the depth L1 at a keyframe's pose must halve and end under 3.5 m."""
import numpy as np
import torch

from loner_tpu_torch.data import synthetic
from loner_tpu_torch.data.scan import make_lidar_scan, sky_scan
from loner_tpu_torch.geometry import se3
from loner_tpu_torch.geometry.rays import build_lidar_rays
from loner_tpu_torch.geometry.world_cube import compute_world_cube
from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.mapping.keyframe import KeyFrame, stack_window
from loner_tpu_torch.models.hash_encoding import HashEncodingConfig
from loner_tpu_torch.models.losses import LossConfig
from loner_tpu_torch.models.nerf import NeRFConfig
from loner_tpu_torch.models.occupancy_grid import OccGridConfig

from torch_parity import two_threads  # noqa: F401

RAY_RANGE = (1.0, 40.0)


def _tiny_cell_config(world_scale: float) -> topt.MapperConfig:
    """tests/test_train_step.py::tiny_mapper_config with the CellHash field."""
    return topt.MapperConfig(
        nerf=NeRFConfig(num_colors=1, pos_encoding_sigma=HashEncodingConfig(n_levels=8, log2_hashmap_size=15),
                        pos_encoding_intensity=HashEncodingConfig(n_levels=4, log2_hashmap_size=12),
                        sigma_hidden_dim=32, intensity_hidden_dim=16, intensity_hidden_layers=2,
                        encoding_impl="cell"),
        loss=LossConfig(), occ=OccGridConfig(voxel_size=32), ray_range=RAY_RANGE, world_scale=world_scale,
        window_size=4, max_keyframes=16, rays_per_kf=256, sky_rays_per_kf=32, n_samples_train=128,
        n_samples_test=256)


def _eval_l1_depth(cfg, cube, state, scene, pose, n_rays=512, seed=1) -> float:
    """tests/test_train_step.py::eval_l1_depth: rendered against ray-cast
    depths at ``pose``, returns clipped by the ray range left out."""
    rng = np.random.default_rng(seed)
    dirs, dists, _, hit = synthetic.simulate_scan(scene, pose, 0.0, n_channels=16, n_azimuth=128, max_range=40.0)
    sel = rng.choice(np.flatnonzero(hit), size=min(n_rays, int(hit.sum())), replace=False)
    bundle = build_lidar_rays(torch.as_tensor(dirs[sel]), torch.as_tensor(dists[sel]),
                              torch.as_tensor(pose, dtype=torch.float32), cube, cfg.ray_range)
    render = topt.make_render_fn(cfg, device="cpu")(state.params, state.occ_grid, bundle,
                                                    generator=torch.Generator().manual_seed(7))
    scale = float(cube.scale_factor)
    pred, gt = render.depth.numpy() * scale, bundle.depth.numpy() * scale
    keep = bundle.valid.numpy() & (gt > cfg.ray_range[0]) & (gt < cfg.ray_range[1] - 0.25)
    return float(np.mean(np.abs(pred[keep] - gt[keep])))


def test_cell_field_trains_on_synthetic_scene():
    scene = synthetic.Scene.default()
    poses, ts = synthetic.circular_trajectory(n_poses=4, radius=6.0, z=1.5)
    cube = compute_world_cube(poses, ray_range=RAY_RANGE, rebase_to_first_pose=False)
    cfg = _tiny_cell_config(float(cube.scale_factor))
    kfs = []
    for i, (T, t0) in enumerate(zip(poses, ts)):
        dirs, dists, stamps, hit = synthetic.simulate_scan(scene, T, t0, n_channels=16, n_azimuth=256,
                                                           max_range=40.0)
        kfs.append(KeyFrame(scan=make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=4096), timestamp=t0,
                            pose_index=i, tracked_pose=T, gt_pose=T,
                            sky=sky_scan(dirs[~hit][:512], 41.0, t0, pad_to=512)))
    window = stack_window(kfs, n_sky_pad=512, device="cpu")
    state = topt.init_mapper_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    pose6 = se3.matrix_to_pose(torch.as_tensor(np.stack(poses), dtype=torch.float32))
    state = state._replace(poses=state.poses.index_copy(0, torch.arange(4), pose6))
    step = topt.make_train_step(cfg, cube, device="cpu", generator=torch.Generator().manual_seed(42))
    flags = topt.TrainStepFlags(freeze_sigma=False, freeze_rgb=True, freeze_poses=True, do_occ_update=False)
    mask = torch.zeros(cfg.max_keyframes)
    l1_before = _eval_l1_depth(cfg, cube, state, scene, poses[0])
    for i in range(300):
        state, _ = step(state, window, flags._replace(do_occ_update=(i % 10) == 9), mask, i)
    assert int(state.skipped_steps) == 0
    l1_after = _eval_l1_depth(cfg, cube, state, scene, poses[0])
    print(f"CellHash L1 {l1_before:.3f} m -> {l1_after:.3f} m after 300 steps")
    assert l1_after < l1_before * 0.5
    assert l1_after < 3.5, f"CellHash L1 {l1_after:.2f} m"
