"""The port's online SLAM loop against the JAX package on the CPU: the
keyframe manager, the yaml configuration layer, the online mapper's schedule
from the JAX mapper's own state and random draws, ``LonerSLAM`` over 12
frames of the synthetic loop in both modes, the trajectory files and the
checkpoints (loner_tpu_torch/{mapping,config,runtime}/, slam.py)."""
import dataclasses
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.config import build as jbuild
from loner_tpu.config import settings as jsettings
from loner_tpu.geometry.world_cube import compute_world_cube as j_compute_world_cube
from loner_tpu.mapping import keyframe as jkf
from loner_tpu.mapping import keyframe_manager as jkfm
from loner_tpu.mapping import mapper as jmapper
from loner_tpu.runtime import trajectory_logger as jlog
from loner_tpu.slam import LonerSLAM as JLonerSLAM
from loner_tpu_torch.config import build as tbuild
from loner_tpu_torch.config import settings as tsettings
from loner_tpu_torch.convert import state_from_jax
from loner_tpu_torch.data.scan import LidarScan
from loner_tpu_torch.flagship import flagship
from loner_tpu_torch.geometry.world_cube import compute_world_cube
from loner_tpu_torch.mapping import keyframe as tkf
from loner_tpu_torch.mapping import keyframe_manager as tkfm
from loner_tpu_torch.mapping import mapper as tmapper
from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.runtime import checkpoints as tckpt
from loner_tpu_torch.runtime.profiling import maybe_trace
from loner_tpu_torch.runtime import trajectory_logger as tlog
from loner_tpu_torch.slam import LonerSLAM

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# keyframe manager
# ---------------------------------------------------------------------------


def _stop_and_go(rng):
    """Tracked poses along the loop with stationary stretches and timestamps
    with irregular gaps: (timestamps, poses)."""
    poses, _ = jax.device_get(tp.jsyn.circular_trajectory(n_poses=48, radius=5.0, z=1.5, period=9.6))
    idx = np.concatenate([np.arange(0, 10), np.full(6, 10), np.arange(10, 30, 2), np.full(5, 30), np.arange(31, 48)])
    ts = np.cumsum(rng.uniform(0.1, 0.6, len(idx)))
    return ts, poses[idx]


@pytest.mark.parametrize("window", ["HYBRID", "MOST_RECENT", "RANDOM"])
@pytest.mark.parametrize("strategy", ["TEMPORAL", "MOTION", "HYBRID", "HYBRID_LAZY"])
def test_keyframe_manager_matches(strategy, window):
    """Decisions, rebased poses and windows are equal
    over a stop-and-go sequence, with optimized poses that drift from the
    tracked ones (the same numbers on both sides)."""
    rng = np.random.default_rng(7)
    ts, poses = _stop_and_go(rng)
    kw = dict(selection_strategy=strategy, time_diff_seconds=1.0, window_selection=window, window_size=4,
              num_recent_frames=2)
    jm, tm = jkfm.KeyFrameManager(jkfm.KeyFrameManagerConfig(**kw), seed=3), \
        tkfm.KeyFrameManager(tkfm.KeyFrameManagerConfig(**kw), seed=3)
    optimized = np.zeros((64, 6), np.float32)
    decisions = []
    for t, T in zip(ts, poses):
        d = jm.decide(t, T)
        assert tm.decide(t, T) == d
        decisions.append(d)
        if d == "SKIP":
            continue
        if d == "NEW":
            jpose = jm.rebase_pose(T, optimized)
            tpose = tm.rebase_pose(T, optimized)
            np.testing.assert_allclose(tpose, jpose, rtol=0, atol=1e-5)
            i = len(jm)
            jm.accept(jkf.KeyFrame(scan=None, timestamp=t, pose_index=i, tracked_pose=T))
            tm.accept(tkf.KeyFrame(scan=None, timestamp=t, pose_index=i, tracked_pose=T))
            # the mapper's optimized pose: the rebased one, nudged
            optimized[i] = np.asarray(jax.device_get(tp.jse3.matrix_to_pose(jnp.asarray(jpose, jnp.float32))))
            optimized[i] += rng.normal(0, 0.01, 6).astype(np.float32)
        jw, tw = jm.get_active_window(), tm.get_active_window()
        assert [k.pose_index for k in tw] == [k.pose_index for k in jw]
        assert [k.is_anchored for k in tw] == [k.is_anchored for k in jw]
    assert decisions.count("NEW") >= 3
    if strategy in ("MOTION", "HYBRID", "HYBRID_LAZY"):
        assert decisions.count("SKIP") >= 3


def test_keyframe_band_indices_match():
    _, gt, ts, scans, _ = tp.loop_scans(2)
    j = jkf.KeyFrame(scan=scans[1], timestamp=ts[1], pose_index=0, tracked_pose=gt[1]).compute_band_indices()
    t = tkf.KeyFrame(scan=LidarScan(*scans[1]), timestamp=ts[1], pose_index=0,
                     tracked_pose=gt[1]).compute_band_indices()
    np.testing.assert_array_equal(t.band_indices, j.band_indices)
    assert len(np.unique(t.band_indices)) > 100


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

CFG_FILES = sorted(
    os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "cfg", "**", "*.yaml"), recursive=True)
    if "tracker" in open(p).read() or "baseline" in open(p).read()
)
def _assert_same_config(t, j, path="cfg"):
    if dataclasses.is_dataclass(j) or hasattr(j, "_fields"):
        names = [f.name for f in dataclasses.fields(j)] if dataclasses.is_dataclass(j) else list(j._fields)
        for name in names:
            assert hasattr(t, name), f"{path}.{name} is not in the port"
            _assert_same_config(getattr(t, name), getattr(j, name), f"{path}.{name}")
        return
    if isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_same_config(a, b, f"{path}[{i}]")
        return
    assert type(t) is type(j) and t == j, f"{path}: {t!r} != {j!r}"


def test_config_files_found():
    assert "cfg/defaults.yaml" in CFG_FILES and len(CFG_FILES) >= 5


@pytest.mark.parametrize("path", CFG_FILES)
def test_build_slam_config_matches(path):
    """Every field of ``build_slam_config(load_settings(path))``, nested
    configs included, equals the JAX package's, value and type."""
    full = os.path.join(REPO, path)
    j = jbuild.build_slam_config(jsettings.load_settings(full), 12.5)
    t = tbuild.build_slam_config(tsettings.load_settings(full), 12.5)
    _assert_same_config(t, j)
    assert t.mapper.schedule and t.tracker.icp.stages


def test_settings_overrides_and_options_match():
    full = os.path.join(REPO, "cfg", "defaults.yaml")
    over = {"data": {"ray_range": [1, 40]}, "tracker": {"motion_compensation": {"enabled": False}}}
    j, t = jsettings.load_settings(full, over), tsettings.load_settings(full, over)
    assert t.to_dict() == j.to_dict() and t.data.ray_range == [1, 40]
    grid = {"mapper.optimizer.num_samples.lidar": [256, 512, 1024], "tracker.icp.scan_duration": [0.5, 0.9]}
    for combos in (False, True):
        jo = jsettings.generate_options(j, grid, combos)
        to = tsettings.generate_options(t, grid, combos)
        assert [(s.to_dict(), d) for s, d in to] == [(s.to_dict(), d) for s, d in jo]
    spec = {"groups": [{"run_all_combos": True, "overrides": grid}, {"overrides": {"system.single_threaded": [False]}}]}
    assert [d for _, d in tsettings.generate_options_spec(t, spec)] == [d for _, d in jsettings.generate_options_spec(j, spec)]


# ---------------------------------------------------------------------------
# trajectory files and checkpoints
# ---------------------------------------------------------------------------


def test_trajectory_logger_files_match(tmp_path):
    """The same frames and keyframe updates give the same TUM files (within
    1e-6 of the JAX package's), and load_tum reads them back."""
    _, gt, ts, _, _ = tp.loop_scans(0)
    rng = np.random.default_rng(5)
    tracked = gt[:20] @ np.asarray(jax.device_get(tp.jse3.pose_to_matrix(
        jnp.asarray(rng.normal(0, 0.02, (20, 6)), jnp.float32))), np.float64)
    logs = (jlog.TrajectoryLogger(), tlog.TrajectoryLogger())
    for i in range(20):
        for log in logs:
            log.log_frame(ts[i], tracked[i], gt[i])
            if i % 6 == 0:
                log.update_keyframe(ts[i], tracked[i], gt[i])
    for log, d in zip(logs, ("j", "t")):
        log.finish(str(tmp_path / d))
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names and len(names) == 5
    for name in names:
        np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / name), np.loadtxt(tmp_path / "j" / name),
                                   rtol=0, atol=1e-6, err_msg=name)
    poses, stamps = tlog.load_tum(str(tmp_path / "t" / "tracking_only.txt"))
    jposes, _ = jlog.load_tum(str(tmp_path / "j" / "tracking_only.txt"))
    np.testing.assert_allclose(poses, jposes, atol=1e-6)
    np.testing.assert_allclose(poses, tracked, atol=1e-5)


def test_maybe_trace_writes_a_trace(tmp_path):
    """torch.profiler in place of jax.profiler: a Chrome trace under
    <log_dir>/profile when on, nothing when off or without a directory."""
    with maybe_trace(str(tmp_path)):
        torch.ones(8).sum()
    assert (tmp_path / "profile" / "trace.json").stat().st_size > 0
    with maybe_trace(str(tmp_path / "off"), enabled=False), maybe_trace(None):
        torch.ones(8).sum()
    assert not (tmp_path / "off").exists()


def test_checkpoint_round_trip(tmp_path):
    """torch.save / torch.load of a whole MapperState, after a step so that
    moments and counts are set; latest_checkpoint picks the highest step."""
    _, tcfg = tp.mapper_configs(20.0)
    tcfg, cube, state, window = flagship(device="cpu", cfg=tcfg, **tp.SCAN)
    step = topt.make_train_step(tcfg, cube, device="cpu")
    state, _ = step(state, window, topt.TrainStepFlags(False, True, False, True), torch.ones(tcfg.max_keyframes), 0)
    for s in (3, 12, 7):
        path = tckpt.save_checkpoint(str(tmp_path), s, state, extras={"kf_times": np.arange(3.0)})
    assert tckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_12")
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None
    fresh = topt.init_mapper_state(torch.Generator().manual_seed(9), tcfg, device="cpu")
    loaded = tckpt.load_checkpoint(path, fresh)
    assert type(loaded["state"]) is topt.MapperState and type(loaded["state"].opt_sigma) is topt.AdamState
    a, b = topt.tree_leaves(loaded["state"]), topt.tree_leaves(state)
    assert len(a) == len(b) and all(torch.equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b))
    assert int(loaded["state"].global_step) == 1
    np.testing.assert_array_equal(loaded["extras"]["kf_times"].numpy(), np.arange(3.0))


# ---------------------------------------------------------------------------
# the online mapper, from the JAX mapper's state and draws
# ---------------------------------------------------------------------------

SCHEDULE = dict(first=3, later=2)


def _schedules():
    return [(cls.SchedulePhase(1, [cls.IterationPhase(SCHEDULE["first"], freeze_poses=True)]),
             cls.SchedulePhase(-1, [cls.IterationPhase(SCHEDULE["later"], freeze_poses=False)]))
            for cls in (jmapper, tmapper)]


def replayed_jax_fixed_draws(jcfg, seed: int, n_per_phase: int):
    """``step_draws`` under FIXED: each phase of ``n_per_phase`` steps splits
    the JAX mapper's key chain once, and every step of the phase draws from
    that held key at its iteration, as the JAX mapper's window schedule
    does (``mapper.py:250-263``)."""
    key, held, calls = [jax.random.PRNGKey(seed + 1)], [None], [0]

    def draws(window):
        it = calls[0] % n_per_phase
        if it == 0:
            key[0], held[0] = jax.random.split(key[0])
        calls[0] += 1
        return tp.torch_draws(tp.jax_step_draws(held[0], jcfg, window, iteration=it))

    return draws


def _mapper_pair(tmp_path, rays_strategy="RANDOM"):
    """Both packages' online mappers over two keyframes of the default scene
    (the occupancy update every second step; the port's from the JAX
    mapper's initial state, with its draws replayed), each frame processed
    by both. Returns (JAX mapper, the port's, the port's config, the
    published keyframe poses of each)."""
    scene = tp.jsyn.Scene.default()
    poses, ts = tp.jsyn.circular_trajectory(n_poses=2, radius=6.0, z=1.5)
    jcube = j_compute_world_cube(poses, ray_range=tp.RAY_RANGE, rebase_to_first_pose=False)
    tcube = compute_world_cube(poses, ray_range=tp.RAY_RANGE, rebase_to_first_pose=False)
    jcfg, tcfg = tp.mapper_configs(float(jcube.scale_factor))
    jcfg, tcfg = (c._replace(occ=c.occ._replace(n_iters_acc=2), rays_strategy=rays_strategy) for c in (jcfg, tcfg))
    draws = (tp.replayed_jax_draws(jcfg, 0) if rays_strategy != "FIXED"
             else replayed_jax_fixed_draws(jcfg, 0, tp.SCAN["pad_to"] // tcfg.rays_per_kf))
    (jsched, tsched) = _schedules()
    kw = dict(n_sky_pad=tp.SCAN["n_sky"], log_level="DISABLED", log_losses=True)
    jm = jmapper.OnlineMapper(jmapper.OnlineMapperConfig(
        mapper=jcfg, keyframe_manager=jkfm.KeyFrameManagerConfig(time_diff_seconds=1.0, window_size=2),
        schedule=list(jsched), loss_log_dir=str(tmp_path / "j"), **kw), jcube)
    tm = tmapper.OnlineMapper(tmapper.OnlineMapperConfig(
        mapper=tcfg, keyframe_manager=tkfm.KeyFrameManagerConfig(time_diff_seconds=1.0, window_size=2),
        schedule=list(tsched), loss_log_dir=str(tmp_path / "t"), **kw), tcube, device="cpu",
        step_draws=draws)
    tm.state = state_from_jax(tp.np_tree(jm.state), device="cpu")
    published = {"j": [], "t": []}
    jm.keyframe_update_callbacks.append(lambda *a: published["j"].append(a))
    tm.keyframe_update_callbacks.append(lambda *a: published["t"].append(a))

    for T, t0 in zip(poses, ts):
        dirs, dists, stamps, hit = tp.jsyn.simulate_scan(scene, T, t0, n_channels=tp.SCAN["n_channels"],
                                                         n_azimuth=tp.SCAN["n_azimuth"], max_range=40.0)
        scan = tp.j_make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=tp.SCAN["pad_to"])
        sky = tp.j_sky_scan(dirs[~hit][: tp.SCAN["n_sky"]], 41.0, t0, pad_to=tp.SCAN["n_sky"])
        tracked = T @ np.asarray(jax.device_get(tp.jse3.pose_to_matrix(jnp.asarray([0.05, -0.03, 0.0, 0.0, 0.0, 0.01]))),
                                 np.float64)
        assert jm.process_frame(scan, t0, tracked, gt_pose=T, sky=sky)
        assert tm.process_frame(LidarScan(*scan), t0, tracked, gt_pose=T, sky=LidarScan(*sky))
    return jm, tm, tcfg, published


def _assert_mappers_agree(tmp_path, jm, tm, tcfg, published):
    """Every step's loss within 1e-5 (relative) and its terms within 1e-4,
    the poses within 0.2 lr, the occupancy grid within 1e-6, the same
    published keyframe poses."""
    for kf in (1, 2):
        jl = np.loadtxt(tmp_path / "j" / f"keyframe_{kf}" / "phase_0.csv", delimiter=",", skiprows=1)
        tl = np.loadtxt(tmp_path / "t" / f"keyframe_{kf}" / "phase_0.csv", delimiter=",", skiprows=1)
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl[:, :2], jl[:, :2], rtol=1e-5, err_msg=f"losses, keyframe {kf}")
        np.testing.assert_allclose(tl[:, 2:], jl[:, 2:], rtol=1e-4, atol=1e-6, err_msg=f"loss terms, keyframe {kf}")
    np.testing.assert_allclose(tm.state.poses.numpy(), np.asarray(jm.state.poses), rtol=0, atol=0.2 * tcfg.lr_pose)
    assert np.abs(np.asarray(jm.state.occ_grid)).max() > 0  # the occupancy update ran
    np.testing.assert_allclose(tm.state.occ_grid.numpy(), np.asarray(jm.state.occ_grid), rtol=0, atol=1e-6)
    assert len(published["t"]) == len(published["j"]) == 2 + 2
    for a, b in zip(published["t"], published["j"]):
        assert a[0] == b[0]
        np.testing.assert_allclose(a[2], b[2], rtol=0, atol=1e-5)


def test_online_mapper_matches_jax(tmp_path):
    """Two keyframes, 3 pose-frozen steps then 2 joint steps with the
    occupancy update every second step, from the JAX mapper's initial state
    and with its draws: every step's loss within 1e-5 (relative) and the
    poses within 0.2 lr of the JAX mapper's, as one train step is held in
    test_torch_train_step.py; the same published keyframe poses."""
    jm, tm, tcfg, published = _mapper_pair(tmp_path)
    assert tm._host_step == jm._host_step == SCHEDULE["first"] + SCHEDULE["later"]
    assert int(tm.state.global_step) == int(jm.state.global_step) == 5
    assert int(tm.state.skipped_steps) == 0
    _assert_mappers_agree(tmp_path, jm, tm, tcfg, published)
    assert len(tm.window_timer.rows) == 2 and [r[1] for r in tm.window_timer.rows] == [3, 2]


def test_fixed_online_mapper_matches_jax(tmp_path):
    """FIXED: each keyframe's phase is one epoch of P // R = 8 steps over the
    padded scan, whatever the schedule says, run from the JAX mapper's
    initial state with its draws, the key held through each phase (the
    permutation and the occupancy-corner uniforms repeat; the sky, sampler
    and encoder draws fold in the iteration): the same bounds as
    ``test_online_mapper_matches_jax``."""
    jm, tm, tcfg, published = _mapper_pair(tmp_path, "FIXED")
    n = tp.SCAN["pad_to"] // tcfg.rays_per_kf
    assert tm._host_step == jm._host_step == 2 * n == 16
    assert int(tm.state.global_step) == int(jm.state.global_step) == 16
    assert int(tm.state.skipped_steps) == 0
    _assert_mappers_agree(tmp_path, jm, tm, tcfg, published)


LAP_FRAMES = (0, 16, 32)  # the first three keyframes of the 1.5 s lap: 0, 1.6 and 3.2 s
LAP_ERRORS_M = (0.0, 0.17, 0.32)
LAP_SCHEDULE = dict(first=60, later=25)
# the largest final pose difference measured (f32, these sizes, one thread): 4.8e-7
LAP_POSE_BOUND = 2e-6


def test_online_mapper_long_horizon_matches_jax(tmp_path):
    """The long-horizon form of ``test_online_mapper_matches_jax``, the
    collected counterpart of tests/compare_mapper_lap.py: three keyframes of
    the quality experiment's lap at 1.5 s spacing (radius 5 m, 12.6 s) at
    the small sizes, window 3, tracked with errors of 0, 0.17 and 0.32 m
    (and a yaw of length / 5 m rad), 60 pose-frozen steps then 25 joint
    steps a keyframe with the occupancy update every 10th step, f32, from
    the JAX mapper's initial state and with its draws: every step's loss
    within 1e-5 (relative), the final poses within ``LAP_POSE_BOUND``, and
    each keyframe's refined error on the same side of 0.05 m in both
    packages; the joint steps moved the poses."""
    import compare_mapper_lap as lap

    scene = tp.jsyn.Scene.default()
    poses, ts = tp.jsyn.circular_trajectory(n_poses=126, radius=5.0, period=12.6)
    poses, ts = np.asarray(poses, np.float64), np.asarray(ts)
    jcube = j_compute_world_cube(poses, ray_range=tp.RAY_RANGE)
    tcube = compute_world_cube(poses, ray_range=tp.RAY_RANGE)
    jcfg, tcfg = tp.mapper_configs(float(jcube.scale_factor), window_size=3)
    schedules = [(cls.SchedulePhase(1, [cls.IterationPhase(LAP_SCHEDULE["first"], freeze_poses=True)]),
                  cls.SchedulePhase(-1, [cls.IterationPhase(LAP_SCHEDULE["later"], freeze_poses=False)]))
                 for cls in (jmapper, tmapper)]
    kw = dict(n_sky_pad=tp.SCAN["n_sky"], log_level="DISABLED", log_losses=True)
    kfm = dict(time_diff_seconds=1.5, window_size=3)
    jm = jmapper.OnlineMapper(jmapper.OnlineMapperConfig(
        mapper=jcfg, keyframe_manager=jkfm.KeyFrameManagerConfig(**kfm), schedule=list(schedules[0]),
        loss_log_dir=str(tmp_path / "j"), **kw), jcube)
    tm = tmapper.OnlineMapper(tmapper.OnlineMapperConfig(
        mapper=tcfg, keyframe_manager=tkfm.KeyFrameManagerConfig(**kfm), schedule=list(schedules[1]),
        loss_log_dir=str(tmp_path / "t"), **kw), tcube, device="cpu", step_draws=tp.replayed_jax_draws(jcfg, 0))
    tm.state = state_from_jax(tp.np_tree(jm.state), device="cpu")

    gt = np.linalg.inv(poses[0])[None] @ poses[list(LAP_FRAMES)]
    tracked = lap.tracked_poses(gt, 0, LAP_ERRORS_M)
    inserted = []
    for i, T, G in zip(LAP_FRAMES, tracked, gt):
        dirs, dists, stamps, hit = tp.jsyn.simulate_scan(scene, poses[i], ts[i], n_channels=tp.SCAN["n_channels"],
                                                         n_azimuth=tp.SCAN["n_azimuth"], max_range=40.0)
        scan = tp.j_make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=tp.SCAN["pad_to"])
        sky = tp.j_sky_scan(dirs[~hit][: tp.SCAN["n_sky"]], 41.0, ts[i], pad_to=tp.SCAN["n_sky"])
        assert jm.process_frame(scan, ts[i], T, gt_pose=G, sky=sky)
        inserted.append(tm.kf_manager.rebase_pose(T, tm.state.poses.numpy()))
        assert tm.process_frame(LidarScan(*scan), ts[i], T, gt_pose=G, sky=LidarScan(*sky))
    assert tm._host_step == jm._host_step == LAP_SCHEDULE["first"] + 2 * LAP_SCHEDULE["later"]
    assert int(tm.state.skipped_steps) == int(jm.state.skipped_steps) == 0

    for kf in (1, 2, 3):
        jl = np.loadtxt(tmp_path / "j" / f"keyframe_{kf}" / "phase_0.csv", delimiter=",", skiprows=1)
        tl = np.loadtxt(tmp_path / "t" / f"keyframe_{kf}" / "phase_0.csv", delimiter=",", skiprows=1)
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl[:, :2], jl[:, :2], rtol=1e-5, err_msg=f"losses, keyframe {kf}")
    jp, tpose = np.asarray(jm.state.poses)[:3], tm.state.poses.numpy()[:3]
    np.testing.assert_allclose(tpose, jp, rtol=0, atol=LAP_POSE_BOUND)
    moved = np.linalg.norm(tpose[1:, :3] - np.stack(inserted)[1:, :3, 3], axis=1)
    assert moved.min() > 5 * tcfg.lr_pose, moved  # the joint steps refined the poses
    err_j = np.linalg.norm(jp[:, :3] - gt[:, :3, 3], axis=1)
    err_t = np.linalg.norm(tpose[:, :3] - gt[:, :3, 3], axis=1)
    np.testing.assert_array_equal(err_t < 0.05, err_j < 0.05)


# ---------------------------------------------------------------------------
# LonerSLAM, end to end on the CPU
# ---------------------------------------------------------------------------

N_FRAMES = 12


def _slam_configs():
    """(JAX SlamConfig, port SlamConfig, loop poses): ``tp.slam_configs`` of
    each package, the gather-free triad field of ``tp.mapper_configs``."""
    import loner_tpu.slam as jslam
    import loner_tpu.tracking.icp as jicp
    import loner_tpu.tracking.tracker as jtracker

    tcfg, cube = tp.port_slam_config()
    jcfg = tp.slam_configs(jmapper, jkfm, jslam, jtracker, jicp, tp.mapper_configs(cube.scale_factor)[0])
    poses, _ = tp.jsyn.circular_trajectory(n_poses=48, radius=5.0, z=1.5, period=9.6)
    return jcfg, tcfg, poses


def _run(slam, scans, skies, ts, gt, out_dir):
    est = [slam.process_scan(scan, t0, gt_pose=g, sky=sky) for scan, sky, t0, g in zip(scans, skies, ts, gt)]
    slam.stop(out_dir)
    return np.stack(est)


@functools.lru_cache(maxsize=None)
def _jax_run(out_dir: str):
    jcfg, _, poses = _slam_configs()
    _, gt, ts, scans, skies = tp.loop_scans(N_FRAMES)
    cube = j_compute_world_cube(poses, ray_range=tp.RAY_RANGE, rebase_to_first_pose=True)
    slam = JLonerSLAM(jcfg, cube)
    est = _run(slam, scans, skies, ts, gt[:N_FRAMES], out_dir)
    return est, [k.timestamp for k in slam.mapper.kf_manager.keyframes]


@pytest.fixture(scope="module")
def jax_slam(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_slam")
    return (out,) + _jax_run(str(out))


def _contract(out_dir):
    files = {os.path.relpath(os.path.join(d, f), out_dir) for d, _, fs in os.walk(out_dir) for f in fs}
    return {f for f in files if not f.startswith("checkpoints/ckpt_")}, files


@pytest.mark.parametrize("single_threaded", [True, False])
def test_loner_slam_matches_jax_on_the_cpu(single_threaded, jax_slam, tmp_path):
    """12 frames of the synthetic loop: tracking_only.txt within 1e-3 m of
    the JAX run's, the same keyframe timestamps, tracking ATE under 0.3 m,
    every trajectory finite, and the same output files (the checkpoint as
    ``ckpt_<step>/state.pt`` where JAX writes an orbax directory)."""
    jout, jest, jkf_times = jax_slam
    _, tcfg, poses = _slam_configs()
    tcfg.single_threaded = single_threaded
    _, gt, ts, scans, skies = tp.loop_scans(N_FRAMES)
    cube = compute_world_cube(poses, ray_range=tp.RAY_RANGE, rebase_to_first_pose=True)
    slam = LonerSLAM(tcfg, cube, device="cpu")
    est = _run(slam, [LidarScan(*s) for s in scans], [LidarScan(*s) for s in skies], ts, gt[:N_FRAMES], str(tmp_path))

    np.testing.assert_allclose(est[:, :3, 3], jest[:, :3, 3], rtol=0, atol=1e-3)
    tj = np.loadtxt(jout / "trajectory" / "tracking_only.txt")
    tt = np.loadtxt(tmp_path / "trajectory" / "tracking_only.txt")
    assert tt.shape == tj.shape == (N_FRAMES, 8)
    np.testing.assert_allclose(tt[:, :4], tj[:, :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.abs(np.sum(tt[:, 4:] * tj[:, 4:], axis=1)), 1.0, atol=1e-6)
    assert [k.timestamp for k in slam.mapper.kf_manager.keyframes] == jkf_times and len(jkf_times) == 3
    ate = np.sqrt(np.mean(np.linalg.norm(est[:, :3, 3] - gt[:N_FRAMES, :3, 3], axis=1) ** 2))
    assert ate < 0.3, ate
    for name in ("estimated_trajectory", "keyframe_trajectory", "online_estimates", "groundtruth"):
        assert np.all(np.isfinite(np.loadtxt(tmp_path / "trajectory" / f"{name}.txt"))), name
    assert len(np.loadtxt(tmp_path / "trajectory" / "keyframe_trajectory.txt")) == 3
    (files, all_files), (jfiles, _) = _contract(tmp_path), _contract(jout)
    assert files == jfiles
    assert f"checkpoints/ckpt_{4 + 2 + 2}/state.pt" in all_files
    assert len(np.loadtxt(tmp_path / "timing.csv", delimiter=",", skiprows=1)) == 3
    assert len(np.loadtxt(tmp_path / "track_times.csv")) == N_FRAMES
    assert int(slam.mapper.state.global_step) == 8 and int(slam.mapper.state.skipped_steps) == 0
