"""The port's offline (FDT) map optimization and its options against the JAX
package on the CPU: the MASK and FIXED ray strategies, the UNIFORM sampler's
train step, the eval render (``make_render_fn``), the held-out L1 depth,
``optimize_implicit_map`` over two epochs from the JAX state with the JAX
draws, the submap segmentation and index, and the port of ``bench.py``
(loner_tpu_torch/mapping/{optimizer,mapper,offline,submaps}.py, bench.py).
One test runs two window-16 offline steps on the card against the CPU."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.mapping import keyframe as jkf
from loner_tpu.mapping import offline as joffline
from loner_tpu.mapping import optimizer as jopt
from loner_tpu.mapping import submaps as jsubmaps
from loner_tpu.models import losses as jlosses
from loner_tpu.models import rendering as jrender
from loner_tpu.models import sampling as jsampling
from loner_tpu_torch import bench
from loner_tpu_torch.convert import state_from_jax
from loner_tpu_torch.data.scan import LidarScan
from loner_tpu_torch.geometry.rays import RayBundle
from loner_tpu_torch.geometry.world_cube import compute_world_cube
from loner_tpu_torch.mapping import keyframe as tkf
from loner_tpu_torch.mapping import keyframe_manager as tkfm
from loner_tpu_torch.mapping import mapper as tmapper
from loner_tpu_torch.mapping import offline as toffline
from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.mapping import submaps as tsubmaps

import torch_parity as tp

KEY = jax.random.PRNGKey(5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: parallel test workers each running torch's
    default pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _forest_keyframes(n: int = 2, n_channels: int = 16, n_azimuth: int = 128, pad_to: int = 2048, n_sky: int = 32):
    """(poses, JAX keyframes, the port's keyframes) of the forest scene with
    their trunk-band indices, both packages' from the same scans."""
    scene = tp.jsyn.Scene.forest(seed=1)
    poses, ts = tp.jsyn.circular_trajectory(n_poses=n, radius=4.0, z=1.5)
    jk, tk = [], []
    for i, (T, t0) in enumerate(zip(poses, ts)):
        dirs, dists, stamps, hit = tp.jsyn.simulate_scan(scene, T, t0, n_channels=n_channels, n_azimuth=n_azimuth,
                                                         max_range=40.0)
        scan = tp.j_make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=pad_to)
        sky = tp.j_sky_scan(dirs[~hit][:n_sky], 41.0, t0, pad_to=n_sky)
        jk.append(jkf.KeyFrame(scan=scan, timestamp=t0, pose_index=i, tracked_pose=T, gt_pose=T, sky=sky)
                  .compute_band_indices())
        tk.append(tkf.KeyFrame(scan=LidarScan(*scan), timestamp=t0, pose_index=i, tracked_pose=T, gt_pose=T,
                               sky=LidarScan(*sky)).compute_band_indices())
    return poses, jk, tk


def _configs(strategy=None, samples=None, poses=None, **changes):
    """(JAX MapperConfig, the port's, JAX cube, port cube) of the small
    mapper around ``poses`` (the forest's two-pose circle by default)."""
    if poses is None:
        poses, _, _ = _forest_keyframes()
    jcube = tp.j_compute_world_cube(poses, ray_range=tp.RAY_RANGE, rebase_to_first_pose=False)
    tcube = compute_world_cube(poses, ray_range=tp.RAY_RANGE, rebase_to_first_pose=False)
    jcfg, tcfg = tp.mapper_configs(float(jcube.scale_factor))
    if strategy:
        changes["rays_strategy"] = strategy
    if samples:
        changes["samples_strategy"] = samples
    return jcfg._replace(**changes), tcfg._replace(**changes), jcube, tcube


def _poses6(poses, k):
    pose6 = np.asarray(jax.device_get(tp.jse3.matrix_to_pose(jnp.asarray(np.stack(poses), jnp.float32))))
    out = np.zeros((k, 6), np.float32)
    out[: len(poses)] = pose6
    return out


def _rays_match(jb, tb, what):
    for name in ("origins", "directions", "depth", "near", "far", "valid"):
        np.testing.assert_allclose(tp.t2n(getattr(tb, name)), np.asarray(getattr(jb, name)), rtol=1e-6, atol=1e-6,
                                   err_msg=f"{what}: {name}")


# ---------------------------------------------------------------------------
# ray strategies
# ---------------------------------------------------------------------------


def test_mask_rays_match_jax():
    """MASK rays from the JAX draws equal JAX's ``build_window_rays`` (1e-6),
    and the first 3/4 of each keyframe's lidar rays end in the trunk band
    (tests/test_mask_strategy.py's check)."""
    poses, jk, tk = _forest_keyframes()
    jcfg, tcfg, jcube, tcube = _configs("MASK", rays_per_kf=256, sky_rays_per_kf=16)
    jwin, twin = jkf.stack_window(jk, n_sky_pad=32), tkf.stack_window(tk, n_sky_pad=32, device="cpu")
    np.testing.assert_array_equal(tp.t2n(twin.band_idx), np.asarray(jwin.band_idx))
    pose6 = _poses6(poses, jcfg.max_keyframes)
    jb = jopt.build_window_rays(jnp.asarray(pose6), jwin, jcube, jcfg, jax.random.split(KEY, 3)[0], 0)
    d = tp.torch_draws(tp.jax_step_draws(KEY, jcfg, jwin))
    tb = topt.build_window_rays(torch.as_tensor(pose6), twin, tcube, tcfg, d.ray_idx, d.sky_idx)
    _rays_match(jb, tb, "MASK")

    r, s = tcfg.rays_per_kf, tcfg.sky_rays_per_kf
    n_band = int(r * tcfg.mask_band_fraction)
    ends = (tp.t2n(tb.origins) + tp.t2n(tb.directions) * tp.t2n(tb.depth)[:, None]) * tcube.scale_factor \
        - tcube.shift.numpy()
    band = np.concatenate([np.arange(k * (r + s), k * (r + s) + n_band) for k in range(2)])
    rest = np.concatenate([np.arange(k * (r + s) + n_band, k * (r + s) + r) for k in range(2)])
    ok = tp.t2n(tb.valid)
    in_band = (ends[:, 2] > 0.4) & (ends[:, 2] < 8.1)
    assert in_band[band][ok[band]].mean() == 1.0
    assert in_band[rest][ok[rest]].mean() < 1.0  # the rest draw from the whole scan


def test_fixed_rays_cover_the_scan_and_match_jax():
    """FIXED: P // R iterations slice every point of each keyframe once, and
    iteration 3 from the JAX permutation equals JAX's rays (1e-6), its sky
    indices drawn from the key folded with the iteration."""
    poses, jk, tk = _forest_keyframes()
    jcfg, tcfg, jcube, tcube = _configs("FIXED", rays_per_kf=256, sky_rays_per_kf=16)
    jwin, twin = jkf.stack_window(jk, n_sky_pad=32), tkf.stack_window(tk, n_sky_pad=32, device="cpu")
    p, r = twin.dirs.shape[1], tcfg.rays_per_kf
    perm = topt.draw_permutation(twin, torch.Generator().manual_seed(0), "cpu")
    seen = torch.cat([topt.fixed_ray_idx(perm, it, r) for it in range(p // r)], dim=1)
    assert torch.equal(torch.sort(seen, dim=1).values, torch.arange(p).expand(2, p))

    pose6 = _poses6(poses, jcfg.max_keyframes)
    jb = jopt.build_window_rays(jnp.asarray(pose6), jwin, jcube, jcfg, jax.random.split(KEY, 3)[0], 3)
    d = tp.torch_draws(tp.jax_step_draws(KEY, jcfg, jwin, iteration=3))
    assert d.ray_idx is None and d.perm.shape == (2, p)
    tb = topt.build_window_rays(torch.as_tensor(pose6), twin, tcube, tcfg, topt.fixed_ray_idx(d.perm, 3, r),
                                d.sky_idx)
    _rays_match(jb, tb, "FIXED")


def test_fixed_mapper_runs_one_epoch_per_phase(monkeypatch):
    """Under FIXED the online mapper runs max(1, P // R) steps per phase
    (the JAX mapper's window schedule), all finite, slicing one permutation
    with one set of occupancy-corner uniforms (the JAX mapper holds its step
    key through the phase), the other draws fresh each step."""
    seen = []
    real = tmapper.draw_step
    monkeypatch.setattr(tmapper, "draw_step", lambda *a, **k: seen.append(real(*a, **k)) or seen[-1])
    poses, _, tk = _forest_keyframes()
    _, tcfg, _, tcube = _configs("FIXED")
    sched = [tmapper.SchedulePhase(1, [tmapper.IterationPhase(1000, freeze_poses=True)]),
             tmapper.SchedulePhase(-1, [tmapper.IterationPhase(50)])]
    m = tmapper.OnlineMapper(tmapper.OnlineMapperConfig(
        mapper=tcfg, schedule=sched, n_sky_pad=32, log_level="DISABLED",
        keyframe_manager=tkfm.KeyFrameManagerConfig(window_size=tcfg.window_size)), tcube, device="cpu")
    kf = tk[0]
    assert m.process_frame(kf.scan, kf.timestamp, kf.tracked_pose, gt_pose=kf.gt_pose, sky=kf.sky)
    p = kf.scan.valid.shape[0]
    assert m._host_step == p // tcfg.rays_per_kf == 64
    assert int(m.state.global_step) == 64 and int(m.state.skipped_steps) == 0
    assert len(seen) == 64 and all(d.perm is seen[0].perm and d.u_occ is seen[0].u_occ for d in seen)
    assert not torch.equal(seen[0].u_strat, seen[1].u_strat) and not torch.equal(seen[0].sky_idx, seen[1].sky_idx)


# ---------------------------------------------------------------------------
# the UNIFORM sampler's train step and the eval render
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tiny(samples="OGM"):
    """The tiny flagship of torch_parity in both packages, with
    ``samples_strategy``, n_samples_test 48 and a random occupancy grid."""
    jcfg, jcube, jstate, jwin = tp.jax_flagship_tiny("float32")
    occ = np.random.default_rng(0).normal(0, 3, jstate.occ_grid.shape).astype(np.float32)
    jstate = jstate._replace(occ_grid=jnp.asarray(occ), poses=jstate.poses.at[1, 0].add(0.05))
    jcfg = jcfg._replace(samples_strategy=samples, n_samples_test=48)
    _, tcfg = tp.mapper_configs(float(jcube.scale_factor))
    tcfg = tcfg._replace(samples_strategy=samples, n_samples_test=48)
    from loner_tpu_torch.flagship import flagship

    _, tcube, _, twin = flagship(device="cpu", cfg=tcfg, **tp.SCAN)
    return jcfg, jcube, jstate, jwin, tcfg, tcube, twin


@pytest.mark.parametrize("freeze_poses", [False, True])
def test_uniform_train_step_matches_jax(freeze_poses):
    """One UNIFORM step from the JAX state with the JAX draws: loss within
    1e-5 (relative), the sigma and pose gradients normwise within 1e-5 (the
    f32 bound of test_torch_train_step.py), parameters within lr/5."""
    jcfg, jcube, jstate, jwin, tcfg, tcube, twin = _tiny("UNIFORM")
    mask = (0.0, 1.0, 0.0, 0.0)
    k_rays, k_samp, k_enc = jax.random.split(KEY, 3)

    def fwd(params, poses):
        bundle = jopt.build_window_rays(poses, jwin, jcube, jcfg, k_rays, 0)
        z = jsampling.uniform_sampler_z_vals(k_samp, bundle, jcfg.n_samples_train, jcfg.perturb)
        render = jrender.render_rays(params, bundle, z, jcfg.nerf, sigma_only=True, key=k_enc, point_chunks=1)
        return jlosses.compute_lidar_loss(render, bundle, jcfg.world_scale, jcfg.loss,
                                          jstate.global_step.astype(jnp.float32), jnp.float32(0.0))[0]

    jloss, (jg_params, jg_poses) = jax.jit(jax.value_and_grad(fwd, argnums=(0, 1)))(jstate.params, jstate.poses)
    body = jax.jit(jopt.make_train_step_body(jcfg, jcube), static_argnums=0)
    flags = (False, True, freeze_poses, False)
    jnew, _ = body(not freeze_poses, jstate, jwin, KEY, jopt.TrainStepFlags(*map(jnp.asarray, flags)),
                   jnp.asarray(mask, jnp.float32), jnp.asarray(0))

    state = state_from_jax(tp.np_tree(jstate), device="cpu")
    step = topt.make_train_step(tcfg, tcube, device="cpu")
    d = tp.torch_draws(tp.jax_step_draws(KEY, jcfg, jwin))
    assert d.u_pdf is None and d.u_strat.shape == (tcfg.rays_per_window, tcfg.n_samples_train)
    new, aux = step(state, twin, topt.TrainStepFlags(*flags), torch.tensor(mask), 0, d)
    np.testing.assert_allclose(float(aux["loss"]), float(jloss), rtol=1e-5)
    assert tp.rel_err(aux["grads"]["sigma"], tp.np_tree(jg_params["sigma"])) <= 1e-5
    if not freeze_poses:
        assert tp.rel_err(aux["grads"]["poses"], np.asarray(jg_poses)) <= 1e-5
    jnew = tp.np_tree(jnew)
    tp.assert_trees_close(new.params["sigma"], jnew.params["sigma"], rtol=0, atol=tcfg.lr_sigma * 0.2, what="sigma")
    np.testing.assert_allclose(tp.t2n(new.poses), jnew.poses, rtol=0, atol=tcfg.lr_pose * 0.2)


@pytest.mark.parametrize("chunks", [2, 4])
@pytest.mark.parametrize("samples", ["OGM", "UNIFORM"])
def test_chunked_train_step_matches_one_pass(samples, chunks):
    """``train_point_chunks`` = 2 or 4 against one pass over the same state
    and draws, with the occupancy update and pose gradients: loss within
    1e-6 (relative; equal as measured), the sigma and pose gradients
    normwise within 1e-5 (the f32 bound of test_torch_train_step.py), the
    updated parameters and occupancy grid within 1e-6."""
    jcfg, _, jstate, jwin, tcfg, tcube, twin = _tiny(samples)
    d = tp.torch_draws(tp.jax_step_draws(KEY, jcfg, jwin))
    flags = topt.TrainStepFlags(False, True, False, True)
    out = []
    for c in (1, chunks):
        step = topt.make_train_step(tcfg._replace(train_point_chunks=c), tcube, device="cpu")
        out.append(step(state_from_jax(tp.np_tree(jstate), device="cpu"), twin, flags, torch.tensor((0.0, 1.0, 0.0, 0.0)),
                        0, d))
    (one, aux1), (new, aux) = out
    np.testing.assert_allclose(float(aux["loss"]), float(aux1["loss"]), rtol=1e-6)
    for k in ("sigma", "poses"):
        assert tp.rel_err(aux["grads"][k], aux1["grads"][k]) <= 1e-5, k
    tp.assert_trees_close(new.params["sigma"], one.params["sigma"], rtol=0, atol=1e-6, what="sigma")
    np.testing.assert_allclose(tp.t2n(new.occ_grid), tp.t2n(one.occ_grid), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp.t2n(new.poses), tp.t2n(one.poses), rtol=0, atol=1e-6)


@pytest.mark.parametrize("samples", ["OGM", "UNIFORM"])
def test_render_fn_matches_jax(samples):
    """The eval render (n_samples_test, no jitter, point chunks of the field
    config) from the JAX state, with OGM's inverse-CDF uniforms replayed
    from the JAX key: depth within 1e-5, no gradient; no such draw under
    UNIFORM. With the intensity branch (``sigma_only=False``) the depth is
    the same and the colours come too. With the adjusted compositing
    (``render_strategy="adjusted"``) the depth is within 1e-5 of the JAX
    render's on every ray but those whose depth turns on a near-tie that
    float32 rounding decides (``torch_parity.adjusted_tie_rays``: mostly
    rise deltas equal in exact arithmetic, which the two packages' z values,
    ulps apart, order either way; counted and bounded, ROADMAP.md queue C),
    and the same compositing of the port's own samples within 1e-5 of the
    JAX package's on every ray."""
    jcfg, jcube, jstate, jwin, tcfg, tcube, twin = _tiny(samples)
    jb = jopt.build_window_rays(jstate.poses, jwin, jcube, jcfg, jax.random.split(KEY, 3)[0], 0)
    jout = jopt.make_render_fn(jcfg, test=True)(jstate.params, jstate.occ_grid, jb, KEY)
    state = state_from_jax(tp.np_tree(jstate), device="cpu")
    tb = RayBundle(*(torch.as_tensor(np.array(a)) for a in jb))
    n = tb.near.shape[0]
    u = torch.from_numpy(tp.jax_render_u_pdf(KEY, n, tcfg.n_samples_test)) if samples == "OGM" else None
    render = topt.make_render_fn(tcfg, test=True, device="cpu")
    out = render(state.params, state.occ_grid, tb, u_pdf=u)
    assert out.z_vals.shape == (n, tcfg.n_samples_test) and not out.depth.requires_grad
    np.testing.assert_allclose(tp.t2n(out.depth), np.asarray(jout.depth), rtol=1e-5, atol=1e-5)
    colour = topt.make_render_fn(tcfg, test=True, sigma_only=False, device="cpu")(state.params, state.occ_grid, tb,
                                                                                  u_pdf=u)
    np.testing.assert_allclose(tp.t2n(colour.depth), tp.t2n(out.depth), rtol=0, atol=0)
    assert colour.rgb.shape == (n, tcfg.nerf.num_colors) and bool(torch.all((colour.rgb >= 0) & (colour.rgb <= 1)))
    jadj = jopt.make_render_fn(jcfg, test=True, render_strategy="adjusted")(jstate.params, jstate.occ_grid, jb, KEY)
    adj = topt.make_render_fn(tcfg, test=True, render_strategy="adjusted", device="cpu")(
        state.params, state.occ_grid, tb, u_pdf=u)
    assert torch.equal(adj.weights, out.weights) and torch.equal(adj.opacity, out.opacity)
    tie = tp.adjusted_tie_rays(np.asarray(jadj.z_vals), np.asarray(jadj.raw[0]), np.asarray(jb.directions))
    valid = np.asarray(jadj.depth) > 0
    assert valid.sum() >= 20 and tie.sum() <= 0.25 * n, (valid.sum(), tie.sum())
    np.testing.assert_allclose(tp.t2n(adj.depth)[~tie], np.asarray(jadj.depth)[~tie], rtol=1e-5, atol=1e-5)
    _, jd, _, _, _ = jrender.composite_peak_adjusted(jnp.asarray(tp.t2n(adj.raw)), jnp.asarray(tp.t2n(adj.z_vals)),
                                                     jnp.asarray(tp.t2n(tb.directions)), jnp.asarray(tp.t2n(tb.far)),
                                                     sigma_only=True)
    np.testing.assert_allclose(tp.t2n(adj.depth), np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_evaluate_l1_depth_matches_jax():
    """The held-out L1 depth over three keyframes, the same rays chosen by
    numpy and the JAX render key's uniforms: within 1e-5 (relative)."""
    jcfg, jcube, jstate, _, tcfg, tcube, _ = _tiny("OGM")
    _, jk, tk = _forest_keyframes(3, 8, 64, 256, 32)
    jl1 = joffline.evaluate_l1_depth(jcfg, jcube, jstate, jk, n_rays=48, seed=8)
    state = state_from_jax(tp.np_tree(jstate), device="cpu")
    u = torch.as_tensor(tp.jax_render_u_pdf(jax.random.PRNGKey(8), 48, tcfg.n_samples_test))
    tl1 = toffline.evaluate_l1_depth(tcfg, tcube, state, tk, n_rays=48, seed=8, u_pdf=u)
    assert np.isfinite(tl1) and tl1 > 0
    np.testing.assert_allclose(tl1, jl1, rtol=1e-5)


# ---------------------------------------------------------------------------
# the offline loop, end to end
# ---------------------------------------------------------------------------


def test_optimize_implicit_map_matches_jax(monkeypatch):
    """Two epochs over five keyframes (one held out, windows of 2, 2 steps a
    window, the exact occupancy update every second step) from the JAX
    initial state with the JAX loop's draws: every step's loss within 1e-5
    and the L1 history within 1e-4 (relative), the same number of steps."""
    poses, jk, tk = _forest_keyframes(5, 8, 64, 256, 32)
    jcfg, tcfg, jcube, tcube = _configs(poses=poses, n_samples_test=48, max_keyframes=16)
    jcfg, tcfg = (c._replace(occ=c.occ._replace(n_iters_acc=2)) for c in (jcfg, tcfg))
    offline = dict(window_size=2, iterations_per_window=2, max_epochs=2, n_eval_scans=1, eval_rays_per_scan=48,
                   l1_stop_threshold=0.0)

    jlosses_seen = []
    real = joffline.make_train_step

    def recording(*a, **k):
        step = real(*a, **k)

        def run(*args):
            new, aux = step(*args)
            jlosses_seen.append(float(aux["loss"]))
            return new, aux
        return run

    monkeypatch.setattr(joffline, "make_train_step", recording)
    # numpy copies first: the JAX loop donates its state's buffers
    state0 = tp.np_tree(jopt.init_mapper_state(jax.random.PRNGKey(8), jcfg))
    jres = joffline.optimize_implicit_map(jcfg, jcube, jk, joffline.OfflineConfig(**offline),
                                          state=jax.tree.map(jnp.asarray, state0), log_fn=lambda m: None)

    key = [jax.random.PRNGKey(8)]
    jw = jcfg._replace(window_size=2)

    def draws(window):
        key[0], sub = jax.random.split(key[0])
        return tp.torch_draws(tp.jax_step_draws(sub, jw, window))

    u = torch.as_tensor(tp.jax_render_u_pdf(jax.random.PRNGKey(8), 48, tcfg.n_samples_test))
    tres = toffline.optimize_implicit_map(tcfg, tcube, tk, toffline.OfflineConfig(**offline),
                                          state=state_from_jax(state0, device="cpu"),
                                          log_fn=lambda m: None, step_draws=draws, eval_u_pdf=u)
    assert tres.iterations == jres.iterations == len(jlosses_seen) == 2 * 2 * 2
    assert tres.epochs_run == jres.epochs_run == 2
    np.testing.assert_allclose(tres.losses, jlosses_seen, rtol=1e-5)
    np.testing.assert_allclose(tres.l1_history, jres.l1_history, rtol=1e-4)
    assert int(tres.state.skipped_steps) == 0 and int(tres.state.global_step) == 8
    assert tres.state.occ_grid.abs().max() > 0  # the occupancy update ran


def test_submaps_match_jax(tmp_path):
    """``segment_trajectory`` equals JAX's, a collection saved by either
    package loads in the other and answers the same queries, and
    ``segment_and_optimize_submaps`` writes one map per segment."""
    rng = np.random.default_rng(4)
    positions = np.cumsum(rng.normal(0, 1.0, (80, 3)), axis=0)
    for length, overlap in ((10.0, 5), (30.0, 0), (1e9, 30)):
        js = jsubmaps.segment_trajectory(positions, length, overlap)
        ts = tsubmaps.segment_trajectory(positions, length, overlap)
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            assert a.indices == b.indices and a.core_indices == b.core_indices
            np.testing.assert_array_equal(a.middle_point, b.middle_point)
    mids = np.stack([s.middle_point for s in tsubmaps.segment_trajectory(positions, 10.0, 5)])
    names = [f"submap_{i:03d}" for i in range(len(mids))]
    tsubmaps.SubmapCollection(mids, names).save(str(tmp_path / "t"))
    jsubmaps.SubmapCollection(mids, names).save(str(tmp_path / "j"))
    for a, b in ((tsubmaps.SubmapCollection.load(str(tmp_path / "j")), jsubmaps.SubmapCollection.load(str(tmp_path / "t"))),):
        assert a.names == b.names == names
        for q in rng.normal(0, 5, (10, 3)):
            assert a.query(q) == b.query(q)

    poses, _, tk = _forest_keyframes(3, 8, 64, 256, 32)
    _, tcfg, _, tcube = _configs(poses=poses)
    coll, res = tsubmaps.segment_and_optimize_submaps(
        tcfg, tk, segment_length_m=8.0, overlap_poses=0, cube=tcube, out_dir=str(tmp_path / "s"),
        offline=toffline.OfflineConfig(window_size=2, iterations_per_window=1, max_epochs=1, eval_rays_per_scan=16),
        log_fn=lambda m: None, device="cpu")
    assert len(res) == len(coll.names) == 2 and all(np.isfinite(r.l1_history[0]) for r in res)
    assert (tmp_path / "s" / "submaps_index.json").exists()
    assert json.loads((tmp_path / "s" / "submap_001" / "l1_history.json").read_text()) == res[1].l1_history


def test_bench_prints_its_one_line(capsys):
    """``bench.main`` at a tiny size on the CPU: the last line is bench.py's
    JSON object with exactly its four keys; joint and frozen rates finite;
    no device time claimed off the card."""
    out = bench.main(["--device", "cpu", "--keyframes", "2", "--channels", "8", "--azimuth", "64", "--pad-to", "256",
                      "--sky", "32", "--rays-per-kf", "16", "--sky-rays-per-kf", "4", "--samples", "16"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(last) == ["metric", "unit", "value", "vs_baseline"]
    assert last["metric"] == "mapper_iterations_per_sec_joint" and last["value"] == round(out["joint_its_per_s"], 2)
    assert "40 rays x 16 samples" in last["unit"] and f"{round(out['frozen_its_per_s'], 2)} it/s" in last["unit"]
    assert np.isfinite(out["joint_its_per_s"]) and np.isfinite(out["frozen_its_per_s"])
    assert out["device_busy_ms"] is None and out["train_steps"] >= 2 * 122


@pytest.mark.gpu
def test_offline_window16_steps_on_card():
    """Two offline steps at window 16 (full widths, 64 + 16 rays a keyframe,
    64 samples, MASK rays, two point chunks, the exact occupancy update on
    the second), each run on the card and on the CPU from the CPU's state
    before it with the same draws: loss within 1e-5 (relative), sigma
    gradients normwise within 1e-4 with the MLP in f32; on the card B1 and
    B2 once per point chunk, B3 once per step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from loner_tpu_torch.flagship import flagship
    from loner_tpu_torch.models.nerf import NeRFConfig
    from loner_tpu_torch.ops import cp_kernel, pdf_kernel

    cfg = topt.MapperConfig(nerf=NeRFConfig(compute_dtype="float32"), window_size=16, rays_per_kf=64,
                            sky_rays_per_kf=16, n_samples_train=64, rays_strategy="MASK", train_point_chunks=2)
    cfg = cfg._replace(occ=cfg.occ._replace(estimator="exact"))
    cfg, cube, state, window = flagship("cpu", cfg=cfg, n_keyframes=16, n_channels=32, n_azimuth=512,
                                        pad_to=16384, n_sky=1024)
    gen = torch.Generator().manual_seed(3)
    draws = [topt.draw_step(cfg, window, gen, "cpu") for _ in range(2)]
    steps = {dev: topt.make_train_step(cfg, cube, dev) for dev in ("cpu", "cuda")}
    flags = topt.TrainStepFlags(False, True, True, False)
    mask = torch.zeros(cfg.max_keyframes)

    def card(tree):
        return topt.tree_map(lambda t: t.to("cuda"), tree)

    wrappers = (cp_kernel.cp_fwd, cp_kernel.cp_bwd, pdf_kernel.pdf_sample)
    for w in wrappers:
        w.launches = 0
    for it, d in enumerate(draws):
        f = flags._replace(do_occ_update=it == 1)
        new, aux = steps["cpu"](state, window, f, mask, it, d)
        _, aux_card = steps["cuda"](card(state), card(window), f, mask.cuda(), it, card(d))
        np.testing.assert_allclose(float(aux_card["loss"]), float(aux["loss"]), rtol=1e-5, err_msg=f"step {it}")
        g_card = [g.cpu() for g in topt.tree_leaves(aux_card["grads"]["sigma"])]
        assert tp.rel_err(g_card, topt.tree_leaves(aux["grads"]["sigma"])) <= 1e-4, f"step {it}"
        state = new
    assert [w.launches for w in wrappers] == [2 * 2, 2 * 2, 2]
