"""The port's tracking front end against the JAX package on the CPU: the se3
remainder and motion compensation (loner_tpu_torch/geometry/), the tracker
over frames of the synthetic loop, sky extraction and frame decimation
(loner_tpu_torch/tracking/), from the same numpy inputs."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.geometry import motion as jmotion
from loner_tpu.geometry import se3 as jse3
from loner_tpu.tracking import sky as jsky
from loner_tpu.tracking.frame_synthesis import FrameSynthesis as JFrameSynthesis
from loner_tpu.tracking.frame_synthesis import FrameSynthesisConfig as JFrameSynthesisConfig
from loner_tpu.tracking.icp import IcpConfig as JIcpConfig, IcpStage as JIcpStage
from loner_tpu.tracking.tracker import Tracker as JTracker, TrackerConfig as JTrackerConfig
from loner_tpu_torch.data.scan import LidarScan
from loner_tpu_torch.geometry import motion as tmotion
from loner_tpu_torch.geometry import se3 as tse3
from loner_tpu_torch.tracking import sky as tsky
from loner_tpu_torch.tracking.frame_synthesis import FrameSynthesis, FrameSynthesisConfig
from loner_tpu_torch.tracking.icp import IcpConfig, IcpStage
from loner_tpu_torch.tracking.tracker import Tracker, TrackerConfig

import torch_parity as tp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while these tests run: their tensors are small and
    their operators many, and parallel test workers each running torch's
    default thread pool oversubscribe the cores (a SLAM case took 86 s
    instead of 4 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

RNG = np.random.default_rng(3)


def _rigid(n, rng, angle=2.0, trans=3.0):
    w = rng.normal(size=(n, 3)) * angle / np.sqrt(3)
    T = np.asarray(jse3.pose_to_matrix(jnp.asarray(np.concatenate([rng.normal(size=(n, 3)) * trans, w], -1),
                                                   jnp.float32)))
    return T


def test_se3_remainder_matches():
    """compose, inverse, transform_points, quaternions both ways (one near
    pi), slerp and interpolate_transform within 1e-5."""
    # relative rotations well short of pi, where slerp's log is ill-conditioned
    T0 = np.array(_rigid(64, RNG))
    T1 = T0 @ np.array(_rigid(64, RNG, angle=1.0))
    T_pi = T1.copy()
    T_pi[0, :3, :3] = np.diag([1.0, -1.0, -1.0])  # a rotation by pi
    alpha = RNG.uniform(0, 1, 64).astype(np.float32)
    pts = RNG.normal(size=(64, 5, 3)).astype(np.float32)
    arrays = dict(T0=T0, T1=T1, T_pi=T_pi, alpha=alpha, pts=pts)
    t = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    pairs = [
        (tse3.compose(t["T0"], t["T1"]), jse3.compose(j["T0"], j["T1"])),
        (tse3.inverse(t["T0"]), jse3.inverse(j["T0"])),
        (tse3.transform_points(t["T0"], t["pts"]), jse3.transform_points(j["T0"], j["pts"])),
        (tse3.matrix_to_quat(t["T_pi"][:, :3, :3]), jse3.matrix_to_quat(j["T_pi"][:, :3, :3])),
        (tse3.slerp_rotation(t["T0"][:, :3, :3], t["T1"][:, :3, :3], t["alpha"]),
         jse3.slerp_rotation(j["T0"][:, :3, :3], j["T1"][:, :3, :3], j["alpha"])),
        (tse3.interpolate_transform(t["T0"], t["T1"], t["alpha"]),
         jse3.interpolate_transform(j["T0"], j["T1"], j["alpha"])),
    ]
    q = RNG.normal(size=(64, 4)).astype(np.float32)
    pairs.append((tse3.quat_to_matrix(torch.from_numpy(q)), jse3.quat_to_matrix(jnp.asarray(q))))
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5, err_msg=f"pair {i}")
    np.testing.assert_allclose(tse3.inverse(t["T0"]).numpy() @ T0, np.broadcast_to(np.eye(4), T0.shape), atol=1e-5)


def test_motion_compensate_matches():
    """interpolate_poses and motion_compensate on a scan of the loop between
    two of its poses, timestamps past the end pose included (alpha > 1)."""
    poses, _, ts, scans, _ = tp.loop_scans(4)
    scan = scans[3]
    args = (scan.ray_directions, scan.distances, scan.timestamps, poses[2].astype(np.float32),
            poses[3].astype(np.float32), np.float32(ts[2]), np.float32(ts[3]), poses[3].astype(np.float32))
    jd, jr = jmotion.motion_compensate(*(jnp.asarray(a) for a in args))
    td, tr = tmotion.motion_compensate(*(torch.as_tensor(np.array(a)) for a in args))
    valid = scan.valid
    np.testing.assert_allclose(td.numpy()[valid], np.asarray(jd)[valid], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr.numpy()[valid], np.asarray(jr)[valid], rtol=1e-5, atol=1e-5)
    assert np.abs(tr.numpy()[valid] - scan.distances[valid]).max() > 0.1  # the scan moved
    jp = jmotion.interpolate_poses(*(jnp.asarray(a) for a in args[3:7]), jnp.asarray(scan.timestamps[:100]))
    tpz = tmotion.interpolate_poses(*(torch.as_tensor(np.array(a)) for a in args[3:7]),
                                    torch.from_numpy(scan.timestamps[:100]))
    np.testing.assert_allclose(tpz.numpy(), np.asarray(jp), rtol=0, atol=1e-5)


def _tracker_cfgs(motion_compensation: bool, sky: bool):
    """The ICP schedule of cfg/defaults.yaml (1.5 m then 0.125 m, 10 steps
    each) on 2048 points. Where a target point's 10 neighbours lie on a line
    (a box's vertical edge), its normal is any vector across the line, and
    the two packages' eigen-solvers pick different ones: with the e2e test's
    0.25 m fine stage that moved one frame of this loop by 1.5 mm."""
    kw = dict(target_points=2048, motion_compensation=motion_compensation, sky_segmentation=sky)
    stages = ((1.5, 10), (0.125, 10))
    return (JTrackerConfig(icp=JIcpConfig(stages=tuple(JIcpStage(*s) for s in stages), n_buckets=1 << 12), **kw),
            TrackerConfig(icp=IcpConfig(stages=tuple(IcpStage(*s) for s in stages), n_buckets=1 << 12), **kw))


@functools.lru_cache(maxsize=None)
def _tracked(motion_compensation: bool, sky: bool = False, n_frames: int = 8):
    """(JAX results, port results, ground truth re-based) over the loop's
    first frames."""
    _, gt, ts, scans, _ = tp.loop_scans(n_frames)
    jcfg, tcfg = _tracker_cfgs(motion_compensation, sky)
    jt, tt = JTracker(jcfg), Tracker(tcfg, device="cpu")
    jres = [jt.track(s, t) for s, t in zip(scans, ts)]
    tres = [tt.track(LidarScan(*s), t) for s, t in zip(scans, ts)]
    return jres, tres, gt[:n_frames], tt


@pytest.mark.parametrize("motion_compensation,n_frames", [(False, 8), (True, 5)])
def test_tracker_matches_jax(motion_compensation, n_frames):
    """Every pose within 1e-3 m and 1e-3 rad of the JAX tracker's over 8
    frames; rmse within 1e-3 (one normal picked across a line moved it by
    4.4e-4) and fitness within 1e-4. With motion compensation over 5 frames:
    the synthetic scans are taken from one pose each, so compensating them
    distorts them, and from the sixth frame on the two packages' tracks part
    chaotically (9.7 mm, then 25 mm by the eighth), as a tracker that has lost
    the scene does."""
    jres, tres, gt, tracker = _tracked(motion_compensation, n_frames=n_frames)
    for i, (j, t) in enumerate(zip(jres, tres)):
        assert np.linalg.norm(t.pose[:3, 3] - j.pose[:3, 3]) <= 1e-3, i
        rel = np.linalg.inv(j.pose[:3, :3]) @ t.pose[:3, :3]
        assert np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1)) <= 1e-3, i
        assert abs(t.rmse - j.rmse) <= 1e-3 and abs(t.fitness - j.fitness) <= 1e-4, i
        assert isinstance(t.scan.distances, np.ndarray)
        np.testing.assert_allclose(t.scan.distances, np.asarray(j.scan.distances), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(tres[0].pose, np.eye(4))
    assert len(tracker.track_times) == n_frames
    if not motion_compensation:
        err = np.linalg.norm(np.stack([t.pose for t in tres])[:, :3, 3] - gt[:, :3, 3], axis=1)
        assert err.max() < 0.3  # the e2e test's ATE gate


def test_tracker_sky_directions_match():
    jres, tres, _, _ = _tracked(False, sky=True, n_frames=3)
    for j, t in zip(jres, tres):
        assert len(t.sky_dirs) > 0
        np.testing.assert_array_equal(t.sky_dirs, j.sky_dirs)


@pytest.mark.parametrize("max_rays,kernel", [(None, 3), (300, 3), (None, 1), (None, 5)])
def test_extract_sky_directions_is_equal(max_rays, kernel):
    """The numpy closing stands in for OpenCV's (which the JAX package uses
    when it is installed) on scans of the loop and on a speckled scan."""
    _, _, _, scans, _ = tp.loop_scans(2)
    dirs, valid = scans[1].ray_directions, scans[1].valid.copy()
    valid[RNG.uniform(size=valid.shape) < 0.3] = False  # no-return speckles
    for v in (scans[1].valid, valid):
        j = jsky.extract_sky_directions(dirs, v, closing_kernel=kernel, max_rays=max_rays)
        t = tsky.extract_sky_directions(dirs, v, closing_kernel=kernel, max_rays=max_rays)
        np.testing.assert_array_equal(t, j)
        assert len(t) > 0
    np.testing.assert_array_equal(tsky.spherical_projection(dirs, valid), jsky.spherical_projection(dirs, valid))


def test_frame_decimation_and_matching_are_equal():
    """Decimation decisions over jittered 10 Hz timestamps at three rates,
    and the image <-> scan matches (skipped and waiting images included)."""
    stamps = np.cumsum(RNG.uniform(0.08, 0.12, 200))
    for rate in (5.0, 2.5, 0.0):
        j = JFrameSynthesis(JFrameSynthesisConfig(frame_decimation_rate_hz=rate))
        t = FrameSynthesis(FrameSynthesisConfig(frame_decimation_rate_hz=rate))
        dj, dt = [j.accepts(s) for s in stamps], [t.accepts(s) for s in stamps]
        assert dt == dj and 0 < sum(dt) <= len(stamps)
    _, _, _, scans, _ = tp.loop_scans(4)
    j, t = JFrameSynthesis(JFrameSynthesisConfig()), FrameSynthesis(FrameSynthesisConfig())
    events = [("img", -1.0), ("scan", 0), ("img", 0.05), ("img", 0.15), ("scan", 1), ("img", 0.25),
              ("img", 0.3), ("scan", 2), ("scan", 3), ("img", 0.65)]
    for kind, x in events:
        for fs, cls in ((j, None), (t, LidarScan)):
            if kind == "img":
                fs.process_image(np.full((2, 2, 1), x, np.float32), x)
            else:
                scan = scans[x] if cls is None else cls(*scans[x])
                fs.process_scan_for_matching(scan, float(scans[x].timestamps[0]))
    mj = [(m.image_timestamp, m.scan_timestamp) for m in iter(j.pop_frame, None)]
    mt = [(m.image_timestamp, m.scan_timestamp) for m in iter(t.pop_frame, None)]
    assert mt == mj and len(mt) >= 2


def test_tracker_defaults_to_the_card_and_refuses_unported_options():
    """No card: the default device raises. ``device_index`` and the ICP
    cloud dumps, ported since, build: the index picks a card on the card and
    leaves the CPU the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Tracker(TrackerConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            Tracker(TrackerConfig(device_index=0))
    assert Tracker(TrackerConfig(device_index=1), device="cpu").device == torch.device("cpu")
    from loner_tpu_torch.runtime.debug_dump import DebugFlags

    Tracker(TrackerConfig(debug=DebugFlags(global_enabled=True, draw_icp_clouds=True)), device="cpu")


@pytest.mark.gpu
def test_loner_slam_on_card():
    """Six frames of the loop through the port's LonerSLAM on the card, with
    the small configuration of test_torch_slam.py: the tracked poses within
    1e-3 m of the same run on the CPU, two keyframes, and B1-B3 launched once
    per train step. (Here, not in test_torch_slam.py: that file imports the
    JAX package's runtime, which needs orbax; this one collects without it.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from loner_tpu_torch.ops import cp_kernel, pdf_kernel
    from loner_tpu_torch.slam import LonerSLAM

    _, _, ts, scans, skies = tp.loop_scans(6)
    wrappers = (cp_kernel.cp_fwd, cp_kernel.cp_bwd, pdf_kernel.pdf_sample)
    est = {}
    for dev in ("cpu", "cuda"):
        cfg, cube = tp.port_slam_config()
        slam = LonerSLAM(cfg, cube, device=dev)
        for w in wrappers:
            w.launches = 0
        est[dev] = np.stack([slam.process_scan(LidarScan(*s), t, sky=LidarScan(*k))
                             for s, k, t in zip(scans, skies, ts)])
        slam.stop()
    assert [w.launches for w in wrappers] == [4 + 2] * 3
    np.testing.assert_allclose(est["cuda"][:, :3, 3], est["cpu"][:, :3, 3], atol=1e-3)
    assert slam.mapper.state.poses.device.type == "cuda" and len(slam.mapper.kf_manager) == 2
    assert int(slam.mapper.state.global_step) == 6 and int(slam.mapper.state.skipped_steps) == 0

