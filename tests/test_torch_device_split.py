"""The tracker / mapper device split of the port's LonerSLAM
(``concurrent_device_split``, ``TrackerConfig.device_index``,
``OnlineMapperConfig.mesh_device_indices``) on the CPU, against the JAX
package's rule (``loner_tpu/slam.py:68-89``) and against the run without
the split."""
import copy
import warnings

import numpy as np
import pytest
import torch

from loner_tpu_torch.data.scan import LidarScan
from loner_tpu_torch.slam import LonerSLAM, device_split

import torch_parity as tp
from torch_parity import two_threads  # noqa: F401 (autouse: two torch threads)

N_FRAMES = 12


@pytest.mark.parametrize("n,w,want,warns", [
    (8, 8, [1, 2, 3, 4], False),  # tests/test_slam_e2e.py:175
    (3, 8, [1, 2], False),  # :169-170
    (8, 11, [1], True),  # :185-186: a prime window, one mapper device and a warning
    (2, 8, [1], False),  # no idle device: no warning
    (1, 8, None, False),  # below two devices the split does nothing
])
def test_device_split_rule(n, w, want, warns):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert device_split(n, w) == want
    assert any("no divisor" in str(r.message) for r in rec) == warns


@pytest.mark.parametrize("window", [8, 11])
def test_device_split_matches_the_jax_constructor(window):
    """JAX's LonerSLAM on the virtual 8-device mesh picks the mapper's
    devices that ``device_split`` gives for 8 devices."""
    import jax

    import loner_tpu.mapping.keyframe_manager as jkfm
    import loner_tpu.mapping.mapper as jmapper
    import loner_tpu.slam as jslam
    import loner_tpu.tracking.icp as jicp
    import loner_tpu.tracking.tracker as jtracker
    from loner_tpu.geometry.world_cube import compute_world_cube

    _, cube = tp.port_slam_config()
    jcfg = tp.slam_configs(jmapper, jkfm, jslam, jtracker, jicp, tp.mapper_configs(cube.scale_factor)[0])
    jcfg.concurrent_device_split = True
    jcfg.mapper.mapper = jcfg.mapper.mapper._replace(window_size=window)
    jcfg.mapper.keyframe_manager.window_size = window
    poses, _ = tp.jsyn.circular_trajectory(n_poses=48, radius=5.0, z=1.5, period=9.6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        slam = jslam.LonerSLAM(jcfg, compute_world_cube(poses, ray_range=tp.RAY_RANGE, rebase_to_first_pose=True))
    assert slam.cfg.tracker.device_index == 0
    assert slam.cfg.mapper.mesh_device_indices == device_split(len(jax.devices()), window)


def _run(cfg, cube, scans, skies, ts, gt, out_dir):
    slam = LonerSLAM(cfg, cube, device="cpu")
    est = [slam.process_scan(s, t0, gt_pose=g, sky=k) for s, k, t0, g in zip(scans, skies, ts, gt)]
    slam.stop(out_dir)
    kf = np.stack([slam.mapper.optimized_pose(k) for k in slam.mapper.kf_manager.keyframes])
    return slam, np.stack(est), kf


def test_split_run_tracks_as_the_unsplit_one(tmp_path):
    """The first 12 scans of the loop with the tracker on device 0 and the
    mapper data-parallel over devices 1 and 2 (the CPU each time): the
    tracked poses within 1e-6 m of the run without them, and the keyframes'
    optimized poses within 1e-4 m (the mapper's sums in another order)."""
    cfg, cube = tp.port_slam_config()
    _, gt, ts, scans, skies = tp.loop_scans(N_FRAMES)
    scans = [LidarScan(*s) for s in scans]
    skies = [LidarScan(*s) for s in skies]
    split = copy.deepcopy(cfg)
    split.tracker.device_index = 0
    split.mapper.mesh_device_indices = [1, 2]
    _, est, kf = _run(cfg, cube, scans, skies, ts, gt[:N_FRAMES], str(tmp_path / "plain"))
    slam, est_split, kf_split = _run(split, cube, scans, skies, ts, gt[:N_FRAMES], str(tmp_path / "split"))
    assert slam.mapper.mesh.devices.tolist() == [torch.device("cpu")] * 2
    assert slam.tracker.device == torch.device("cpu")
    np.testing.assert_allclose(est_split[:, :3, 3], est[:, :3, 3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(kf_split[:, :3, 3], kf[:, :3, 3], rtol=0, atol=1e-4)
    assert len(kf) == 3
    assert (tmp_path / "split" / "trajectory" / "tracking_only.txt").exists()


def test_split_with_one_device_changes_nothing():
    """On the CPU (one device) ``concurrent_device_split`` leaves the
    config, the tracker and the mapper as they were."""
    cfg, cube = tp.port_slam_config()
    cfg.concurrent_device_split = True
    slam = LonerSLAM(cfg, cube, device="cpu")
    assert cfg.tracker.device_index is None and cfg.mapper.mesh_device_indices is None
    assert slam.mapper.mesh is None and slam.tracker.device == slam.mapper.device == torch.device("cpu")
