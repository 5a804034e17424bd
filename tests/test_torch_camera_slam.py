"""The online camera mode of the PyTorch port's LonerSLAM on the CPU: images
fed through ``process_image`` reach the keyframes the JAX package's frame
matching and keyframe gate give, train the intensity branch (the gate of
tests/test_camera_online.py), and ``camera.mask_fn`` masks them."""
import json

import numpy as np
import pytest
import torch

from loner_tpu.data import synthetic as jsyn
from loner_tpu_torch.geometry import world_cube as twc
from loner_tpu_torch.mapping import camera_optimizer as tcam
from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.models import losses as tlosses
from loner_tpu_torch.models import nerf as tnerf
from loner_tpu_torch.models import rendering as trender

from torch_parity import two_threads  # noqa: F401 (autouse: two torch threads)

# camera looks forward: z_cam = +x_lidar (write_synthetic_images' convention)
T_LC = np.eye(4)
T_LC[:3, :3] = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])


def _camera_slam(cube, device="cpu", mask_fn=None):
    """The port's form of ``tests/test_camera_online.py::_build_slam``: a
    small triad field (one colour), keyframes 1 s apart in windows of 4, a
    20 + 8 step schedule, 25 camera steps of 512 rays after each pass."""
    from loner_tpu_torch.mapping.keyframe_manager import KeyFrameManagerConfig
    from loner_tpu_torch.mapping.mapper import IterationPhase, OnlineCameraConfig, OnlineMapperConfig, SchedulePhase
    from loner_tpu_torch.models.occupancy_grid import OccGridConfig
    from loner_tpu_torch.slam import LonerSLAM, SlamConfig
    from loner_tpu_torch.tracking.icp import IcpConfig, IcpStage
    from loner_tpu_torch.tracking.tracker import TrackerConfig

    mapper_cfg = topt.MapperConfig(
        nerf=tnerf.NeRFConfig(num_colors=1, pos_encoding_sigma=tnerf.HashEncodingConfig(n_levels=6, log2_hashmap_size=14),
                              pos_encoding_intensity=tnerf.HashEncodingConfig(n_levels=4, log2_hashmap_size=12),
                              sigma_hidden_dim=32, intensity_hidden_dim=16, intensity_hidden_layers=1),
        loss=tlosses.LossConfig(min_depth_eps=1.5), occ=OccGridConfig(voxel_size=32), ray_range=(1.0, 40.0),
        world_scale=cube.scale_factor, window_size=4, max_keyframes=32, rays_per_kf=128, sky_rays_per_kf=16,
        n_samples_train=128, n_samples_test=256)
    return LonerSLAM(SlamConfig(
        tracker=TrackerConfig(icp=IcpConfig(stages=(IcpStage(1.5, 8), IcpStage(0.25, 8)), n_buckets=1 << 12),
                              target_points=2048, motion_compensation=False),
        mapper=OnlineMapperConfig(
            mapper=mapper_cfg, keyframe_manager=KeyFrameManagerConfig(time_diff_seconds=1.0, window_size=4),
            schedule=[SchedulePhase(1, [IterationPhase(20, freeze_poses=True)]),
                      SchedulePhase(-1, [IterationPhase(8, freeze_poses=False)])],
            n_sky_pad=256,
            camera=OnlineCameraConfig(enabled=True, K=K_ONLINE, lidar_to_camera=T_LC, iterations_per_window=25,
                                      n_rays=512, mask_fn=mask_fn)),
        single_threaded=True), cube, device=device)


HO, WO = 32, 48
K_ONLINE = np.array([[WO / 2, 0, WO / 2], [0, WO / 2, HO / 2], [0, 0, 1.0]])


@pytest.fixture(scope="module")
def online_run(tmp_path_factory):
    """The port's LonerSLAM over the 24-pose loop of
    tests/test_camera_online.py, one image after each scan stamped inside
    its interval; with the images and stamps."""
    from loner_tpu_torch.data.scan import make_lidar_scan

    torch.manual_seed(0)
    scene = jsyn.Scene.default()
    poses, ts = jsyn.circular_trajectory(n_poses=24, radius=5.0, z=1.5, period=4.8)
    cube = twc.compute_world_cube(poses, ray_range=(1.0, 40.0), rebase_to_first_pose=True)
    slam = _camera_slam(cube)
    gt_rel = np.linalg.inv(poses[0])[None] @ poses
    stamps_img, tracked = [], []
    for i, (Tp, t0) in enumerate(zip(poses, ts)):
        dirs, dists, stamps, hit = jsyn.simulate_scan(scene, Tp, t0, n_channels=16, n_azimuth=256, max_range=40.0)
        scan = make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=3072)
        t_mid = float(np.median(stamps[hit]))
        img, _ = jsyn.render_intensity_image(scene, Tp @ T_LC, K_ONLINE, HO, WO)
        tracked.append(slam.process_scan(scan, t0, gt_pose=gt_rel[i]))
        slam.process_image(img, t_mid)
        stamps_img.append((t0, t_mid, scan))
    out = tmp_path_factory.mktemp("camera_run")
    slam.stop(str(out))
    return slam, cube, out, stamps_img, tracked, ts


def test_online_images_attach_as_in_the_jax_package(online_run):
    """The images reach the same keyframes as the JAX package's frame
    matching and keyframe gate give on the same stamps and tracked poses;
    camera_attach.json counts them; every camera step counted in
    ``global_step`` beside the lidar steps."""
    from loner_tpu.mapping.keyframe import KeyFrame as JKeyFrame
    from loner_tpu.mapping.keyframe_manager import KeyFrameManager as JKFM, KeyFrameManagerConfig as JKFMC
    from loner_tpu.tracking.frame_synthesis import FrameSynthesis as JFS, FrameSynthesisConfig as JFSC

    slam, _, out, stamps_img, tracked, ts = online_run
    fs, kfm = JFS(JFSC()), JKFM(JKFMC(time_diff_seconds=1.0, window_size=4))
    kf_times, attached = [], []
    for (t0, t_mid, scan), pose in zip(stamps_img, tracked):
        if not fs.accepts(t0):
            continue
        if kfm.decide(t0, pose) == "NEW":
            kf_times.append(t0)
            kfm.accept(JKeyFrame(scan=scan, timestamp=t0, pose_index=len(kfm), tracked_pose=pose))
        fs.process_scan_for_matching(scan, t0)
        fs.process_image(np.zeros((1, 1, 1), np.float32), t_mid)
        while fs.has_frame():
            mf = fs.pop_frame()
            attached.append(mf.scan_timestamp in kf_times)
    kfs = slam.mapper.kf_manager.keyframes
    assert [k.timestamp for k in kfs] == kf_times
    got = json.loads((out / "camera_attach.json").read_text())
    assert got == {"attached": sum(attached), "dropped": len(attached) - sum(attached)}
    assert sum(1 for k in kfs if k.image is not None) == sum(attached) >= 3
    # every keyframe's image arrives after its scan's pass: each pass but the
    # first has an image in its window and runs the camera steps
    assert all(k.image is not None for k in kfs)
    n_cam = (len(kfs) - 1) * slam.cfg.mapper.camera.iterations_per_window
    assert int(slam.mapper.state.global_step) == slam.mapper._host_step + n_cam
    assert int(slam.mapper.state.skipped_steps) == 0


def test_online_images_train_intensity(online_run):
    """The gate of tests/test_camera_online.py: the trained intensity
    branch's masked camera L1 on the window's images under 0.8x that of a
    fresh intensity branch, on the same rays and samples."""
    from loner_tpu_torch.models import sampling

    slam, cube, _, _, _, _ = online_run
    state, cfg = slam.mapper.state, slam.cfg.mapper.mapper
    kfs = [k for k in slam.mapper.kf_manager.keyframes if k.image is not None][:4]
    cam_poses = [slam.mapper.optimized_pose(k) @ T_LC for k in kfs]
    win = tcam.stack_camera_window(np.stack([k.image for k in kfs]), np.ones((len(kfs), HO, WO), bool),
                                   np.stack(cam_poses), K_ONLINE, device="cpu")
    gen = torch.Generator().manual_seed(5)
    n = 2048
    bi, yi, xi = (torch.randint(0, m, (n,), generator=gen) for m in (len(kfs), HO, WO))
    bundle, target = tcam._sample_camera_rays(win, cube, cfg, bi, yi, xi)
    half = cfg.n_samples_train // 2
    z = sampling.occ_grid_sampler_z_vals(bundle, state.occ_grid, cfg.n_samples_train, 0.0, None,
                                         torch.rand((n, half), generator=gen))

    def cam_l1(params):
        render = trender.render_rays(params, bundle, z, cfg.nerf, sigma_only=False)
        return float(tlosses.compute_camera_loss(render, target, bundle.valid, cfg.loss)[1]["cam_l1"])

    fresh = tnerf.init_nerf(torch.Generator().manual_seed(123), cfg.nerf, device="cpu")["intensity"]
    l1_trained = cam_l1(state.params)
    l1_fresh = cam_l1({"sigma": state.params["sigma"], "intensity": fresh})
    assert l1_trained < 0.8 * l1_fresh, (l1_trained, l1_fresh)


def test_online_mask_fn_reaches_the_keyframes():
    """``camera.mask_fn`` masks each attached image, and an explicit mask
    wins over it; an image matched to a scan that never became a keyframe
    is a drop; ``process_image`` without camera mode raises."""
    cube = twc.compute_world_cube(np.eye(4)[None].repeat(2, axis=0), ray_range=(1.0, 40.0))

    def mask_fn(img):
        m = np.ones(img.shape[:2], bool)
        m[:, :4] = False
        return m

    slam = _camera_slam(cube, mask_fn=mask_fn)
    from loner_tpu_torch.data.scan import make_lidar_scan
    from loner_tpu_torch.mapping.keyframe import KeyFrame

    scan = make_lidar_scan(np.eye(3, dtype=np.float32), np.ones(3, np.float32), np.zeros(3, np.float32), pad_to=8)
    slam.mapper.kf_manager.keyframes.append(KeyFrame(scan=scan, timestamp=1.0, pose_index=0, tracked_pose=np.eye(4)))
    img = np.zeros((HO, WO, 1), np.float32)
    assert slam.mapper.attach_image(scan, img, 1.01)
    kf = slam.mapper.kf_manager.keyframes[0]
    assert not kf.image_mask[:, :4].any() and kf.image_mask[:, 4:].all()
    assert slam.mapper.attach_image(None, img, 1.02, scan_timestamp=1.0, mask=np.ones((HO, WO), bool))
    assert kf.image_mask.all() and kf.image_timestamp == 1.02
    assert not slam.mapper.attach_image(None, img, 2.0, scan_timestamp=2.0)
    assert (slam.mapper.image_attaches, slam.mapper.image_attach_drops) == (2, 1)
    slam.cfg.mapper.camera.enabled = False
    with pytest.raises(RuntimeError, match="camera"):
        slam.process_image(img, 0.0)
