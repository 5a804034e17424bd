"""The port's span record (``loner_tpu_torch/runtime/profiling.py``): the
spans an optimized keyframe of the online mapper and an epoch of the
offline loop record, their nesting, the same spans as ``user_annotation``
events of a ``torch.profiler`` trace, no ``record_function`` entered with no
profiler, and the ring's bound."""
import json
import threading
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

import graph_stub
from loner_tpu_torch.data import synthetic
from loner_tpu_torch.data.scan import make_lidar_scan, sky_scan
from loner_tpu_torch.geometry.world_cube import compute_world_cube
from loner_tpu_torch.mapping import keyframe_manager as kfm
from loner_tpu_torch.mapping import mapper as mp
from loner_tpu_torch.mapping import optimizer as opt
from loner_tpu_torch.mapping.keyframe import KeyFrame
from loner_tpu_torch.mapping.offline import OfflineConfig, optimize_implicit_map
from loner_tpu_torch.models.nerf import NeRFConfig
from loner_tpu_torch.models.occupancy_grid import OccGridConfig
from loner_tpu_torch.ops.triad_field import TriadConfig
from loner_tpu_torch.mapping.step_graph import CAPTURE_SPAN, REPLAY_SPAN
from loner_tpu_torch.runtime import profiling

RAY_RANGE = (1.0, 40.0)
SCAN = dict(n_channels=8, n_azimuth=64, pad_to=256, n_sky=32)
POINT_CHUNKS = 2
JOINT_STEPS = 3  # each later keyframe's; the occupancy update on every second step
KEYFRAME_STAGES = {"loner.mapper.stack_window": 1, "loner.mapper.sync": 1, "loner.mapper.readback": 1,
                   "loner.mapper.draws": JOINT_STEPS, "loner.step": JOINT_STEPS}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """(poses, timestamps, [(scan, sky)]) of four frames 1.5 s apart on the
    default scene's circle, and the configuration of a small mapper."""
    scene = synthetic.Scene.default()
    poses, _ = synthetic.circular_trajectory(n_poses=4, radius=6.0, z=1.5)
    ts = 1.5 * np.arange(len(poses))
    cube = compute_world_cube(poses, ray_range=RAY_RANGE, rebase_to_first_pose=False)
    frames = []
    for T, t0 in zip(poses, ts):
        dirs, dists, stamps, hit = synthetic.simulate_scan(scene, T, t0, n_channels=SCAN["n_channels"],
                                                           n_azimuth=SCAN["n_azimuth"], max_range=RAY_RANGE[1])
        frames.append((make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=SCAN["pad_to"]),
                       sky_scan(dirs[~hit][: SCAN["n_sky"]], RAY_RANGE[1] + 1.0, t0, pad_to=SCAN["n_sky"])))
    cfg = opt.MapperConfig(
        nerf=NeRFConfig(num_colors=1, sigma_hidden_dim=16, intensity_hidden_dim=16, intensity_hidden_layers=1,
                        triad=TriadConfig(cp_resolutions=(4, 8), cp_features=4, fourier_freqs=2)),
        occ=OccGridConfig(voxel_size=16, n_iters_acc=2), ray_range=RAY_RANGE, world_scale=float(cube.scale_factor),
        window_size=2, max_keyframes=4, rays_per_kf=32, sky_rays_per_kf=8, n_samples_train=32,
        train_point_chunks=POINT_CHUNKS)
    return poses, ts, frames, cube, cfg


def _mapper(scene):
    _, _, _, cube, cfg = scene
    schedule = [mp.SchedulePhase(1, [mp.IterationPhase(2, freeze_poses=True)]),
                mp.SchedulePhase(-1, [mp.IterationPhase(JOINT_STEPS, freeze_poses=False)])]
    return mp.OnlineMapper(mp.OnlineMapperConfig(
        mapper=cfg, keyframe_manager=kfm.KeyFrameManagerConfig(selection_strategy="TEMPORAL", time_diff_seconds=1.0,
                                                               window_size=2),
        schedule=schedule, n_sky_pad=SCAN["n_sky"], log_level="DISABLED"), cube, device="cpu")


def _feed(mapper, scene, i, t=None):
    poses, ts, frames, _, _ = scene
    scan, sky = frames[i]
    return mapper.process_frame(scan, ts[i] if t is None else t, poses[i], gt_pose=poses[i], sky=sky)


def _tree(recs):
    """(id -> record, parent id -> children in the order they began)."""
    by_id = {r.id: r for r in recs}
    kids = defaultdict(list)
    for r in sorted(recs, key=lambda r: r.id):
        kids[r.parent].append(r)
    return by_id, kids


@pytest.fixture(scope="module")
def mapped(scene):
    """The spans of the mapper's first two keyframes, and of a frame the
    gate skips after them; the mapper."""
    mapper = _mapper(scene)
    profiling.reset()
    assert _feed(mapper, scene, 0) and _feed(mapper, scene, 1)
    recs = profiling.records()
    assert not _feed(mapper, scene, 2, t=scene[1][1] + 0.5)
    return recs, profiling.records(), mapper


def test_keyframe_spans(mapped):
    """Each optimized keyframe records one ``loner.mapper.keyframe`` holding
    one stack_window, sync and readback, and a draws and a ``loner.step`` a
    step; each step holds forward (the rays, the sampler, a ``loner.field``
    a point chunk, the compositing and the loss), backward, update (the
    finite check, an Adam span a group, the occupancy update on its steps)
    and the release of the step's graph."""
    recs, _, mapper = mapped
    by_id, kids = _tree(recs)
    keyframes = kids[-1]
    assert [r.name for r in keyframes] == ["loner.mapper.keyframe"] * 2
    assert not any(r.profiled for r in recs)
    assert Counter(r.name for r in kids[keyframes[1].id]) == KEYFRAME_STAGES
    assert Counter(r.name for r in kids[keyframes[0].id])["loner.step"] == 2
    names = [r.name for r in kids[keyframes[1].id]]
    assert names[0] == "loner.mapper.stack_window" and names[-2:] == ["loner.mapper.sync", "loner.mapper.readback"]
    assert names[1:-2] == ["loner.mapper.draws", "loner.step"] * JOINT_STEPS
    occ_steps = 0
    for step in (r for k in keyframes for r in kids[k.id] if r.name == "loner.step"):
        assert [r.name for r in kids[step.id]] == ["loner.step.forward", "loner.step.backward", "loner.step.update",
                                                   "loner.step.release"]
        fwd, _, upd, _ = kids[step.id]
        assert [r.name for r in kids[fwd.id]] == (["loner.step.rays", "loner.step.sample"]
                                                  + ["loner.field"] * POINT_CHUNKS
                                                  + ["loner.composite", "loner.step.loss"])
        stages = [r.name for r in kids[upd.id]]
        occ_steps += stages[-1] == "loner.step.occ"
        assert stages in (["loner.step.finite"] + ["loner.step.adam"] * 3,
                          ["loner.step.finite"] + ["loner.step.adam"] * 3 + ["loner.step.occ"])
    assert occ_steps == (2 + JOINT_STEPS) // 2
    for r in recs:
        assert r.t0_ns <= r.t1_ns
        if r.parent >= 0:
            p = by_id[r.parent]
            assert p.t0_ns <= r.t0_ns and r.t1_ns <= p.t1_ns, (r, p)
    # map_times are the keyframe spans' own readings
    assert mapper.map_times == [(k.t1_ns - k.t0_ns) * 1e-9 for k in keyframes]


def test_graphed_steps_record_capture_and_replay(scene, monkeypatch):
    """Where the step runs as CUDA graphs (here through ``graph_stub.py``'s
    stand-in for the capture): a key's first step records its stages, its
    second a ``loner.step.capture`` holding the stages and then a
    ``loner.step.replay``, every later one a replay alone. Four keyframes:
    two burn-in steps (two keys, one an occupancy step), then three
    keyframes of three joint steps over two keys."""
    graph_stub.install(monkeypatch)
    mapper = _mapper(scene)
    profiling.reset()
    for i in range(4):
        assert _feed(mapper, scene, i)
    by_id, kids = _tree(profiling.records())
    stages = ["loner.step.forward", "loner.step.backward", "loner.step.update", "loner.step.release"]
    steps = [r for r in profiling.records() if r.name == "loner.step"]
    kinds = []
    for step in sorted(steps, key=lambda r: r.id):
        names = [r.name for r in kids[step.id]]
        if names == [CAPTURE_SPAN, REPLAY_SPAN]:
            assert [r.name for r in kids[kids[step.id][0].id]] == stages
            kinds.append("capture")
        else:
            assert names in (stages, [REPLAY_SPAN]), names
            kinds.append("eager" if names == stages else "replay")
        assert all(not kids[r.id] for r in kids[step.id] if r.name == REPLAY_SPAN)
    assert kinds == ["eager"] * 4 + ["capture"] * 2 + ["replay"] * 5
    assert (mapper._train_step.graph_captures, mapper._train_step.graph_replays) == (2, 7)


def test_skipped_frame_records_nothing(mapped):
    before, after, mapper = mapped
    assert after == before
    assert len(mapper.map_times) == 2


def test_offline_epoch_spans(scene):
    """An epoch of the offline loop records ``loner.offline.epoch`` holding a
    stack_window a window, a draws and a ``loner.step`` a step, then one
    sync and one eval."""
    poses, ts, frames, cube, cfg = scene
    kfs = [KeyFrame(scan=scan, timestamp=t, pose_index=i, tracked_pose=T, gt_pose=T, sky=sky)
           for i, ((scan, sky), T, t) in enumerate(zip(frames, poses, ts))]
    profiling.reset()
    offline = OfflineConfig(window_size=2, iterations_per_window=2, max_epochs=2, l1_stop_threshold=-1.0,
                            n_eval_scans=1, eval_rays_per_scan=16)
    result = optimize_implicit_map(cfg._replace(n_samples_test=32), cube, kfs, offline, log_fn=lambda m: None,
                                   device="cpu")
    recs = profiling.records()
    by_id, kids = _tree(recs)
    epochs = kids[-1]
    assert [r.name for r in epochs] == ["loner.offline.epoch"] * result.epochs_run == ["loner.offline.epoch"] * 2
    windows = 2  # three training scans in windows of two, the last wrapped round
    for e in epochs:
        names = [r.name for r in kids[e.id]]
        assert names == (["loner.offline.stack_window"] + ["loner.offline.draws", "loner.step"] * 2) * windows + [
            "loner.offline.sync", "loner.offline.eval"]
    for r in recs:
        if r.parent >= 0:
            p = by_id[r.parent]
            assert p.t0_ns <= r.t0_ns and r.t1_ns <= p.t1_ns
    evals = [r for r in recs if r.name == "loner.offline.eval"]
    assert result.eval_time_s == pytest.approx(sum((r.t1_ns - r.t0_ns) * 1e-9 for r in evals))


def test_profiler_trace_holds_the_spans(scene, tmp_path):
    """Under ``torch.profiler`` every span is a ``user_annotation`` of the
    trace, nested as the record nests it, and recorded as profiled."""
    mapper = _mapper(scene)
    _feed(mapper, scene, 0)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _feed(mapper, scene, 1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    recs = profiling.records()
    assert recs and all(r.profiled for r in recs)
    events = sorted(((float(e["ts"]), -float(e["dur"]), e["name"]) for e in json.loads(path.read_text())["traceEvents"]
                     if e.get("cat") == "user_annotation" and e.get("name", "").startswith("loner.")))
    assert Counter(e[2] for e in events) == Counter(r.name for r in recs)
    # each annotation's innermost enclosing loner.* annotation is its record's parent's name
    by_id, _ = _tree(recs)
    wanted = Counter((r.name, by_id[r.parent].name if r.parent >= 0 else None) for r in recs)
    found, open_ = Counter(), []
    for ts, neg_dur, name in events:
        while open_ and open_[-1][1] <= ts:
            open_.pop()
        found[name, open_[-1][0] if open_ else None] += 1
        open_.append((name, ts - neg_dur))
    assert found == wanted


def test_no_record_function_without_a_profiler(scene, monkeypatch):
    """With no profiler a span enters no ``record_function``; under one,
    every span enters one."""
    entered = []
    real = profiling.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    mapper = _mapper(scene)
    profiling.reset()
    _feed(mapper, scene, 0)
    assert profiling.records() and entered == []
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _feed(mapper, scene, 1)
    assert Counter(entered) == Counter(r.name for r in profiling.records())


def test_ring_drops_the_oldest_first():
    profiling.reset()
    extra = 10
    for i in range(profiling.SPAN_CAPACITY + extra):
        with profiling.span(f"s{i}"):
            pass
    recs = profiling.records()
    assert len(recs) == profiling.SPAN_CAPACITY
    assert recs[0].name == f"s{extra}" and recs[-1].name == f"s{profiling.SPAN_CAPACITY + extra - 1}"
    assert [r.id for r in recs] == list(range(recs[0].id, recs[0].id + profiling.SPAN_CAPACITY))
    profiling.reset()
    assert profiling.records() == []


def test_spans_nest_per_thread():
    """Each thread's spans take their parents from that thread's open
    spans alone, however the threads interleave."""
    profiling.reset()
    barrier = threading.Barrier(4, timeout=30)

    def work(k):
        with profiling.span(f"outer{k}"):
            barrier.wait()
            for _ in range(200):
                with profiling.span(f"inner{k}"):
                    pass

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    recs = profiling.records()
    outer = {r.name: r.id for r in recs if r.name.startswith("outer")}
    assert len(outer) == 4 and all(r.parent == -1 for r in recs if r.name.startswith("outer"))
    inner = Counter((r.name, r.parent) for r in recs if r.name.startswith("inner"))
    assert inner == {(f"inner{k}", outer[f"outer{k}"]): 200 for k in range(4)}
