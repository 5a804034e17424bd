"""The PyTorch port's mapper train step (loner_tpu_torch/mapping/optimizer.py)
against the JAX package's ``make_train_step_body``, one step from the same
state carried across by ``state_from_jax``, with the JAX step's own random
draws handed to the port: a joint step, a pose-frozen step and a step with
the occupancy update, with the MLP in f32 and in bf16, and joint and frozen
steps with the field's hash term on (the triad's fat-row level and the
FusedHash encoder). Also the window and the tiny flagship against the JAX
arrays, and the non-finite guard."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.mapping import optimizer as jopt
from loner_tpu_torch.convert import state_from_jax
from loner_tpu_torch.flagship import flagship
from loner_tpu_torch.mapping import optimizer as topt

import torch_parity as tp

KEY = jax.random.PRNGKey(11)


@functools.lru_cache(maxsize=None)
def _setup(dtype, hash_term="off"):
    """JAX side (cfg, cube, state, window) with pose 1 perturbed, and the
    port's (cfg, cube, window) built by ``flagship`` from the same scans."""
    jcfg, jcube, jstate, jwindow = tp.jax_flagship_tiny(dtype, hash_term=hash_term)
    jstate = jstate._replace(poses=jstate.poses.at[1, 0].add(0.05).at[1, 5].add(0.02))
    if hash_term != "off":
        # a hash table at its init scale (1e-4) leaves the FusedHash field
        # near zero everywhere, where the reference's alpha = 1 - exp(-x)
        # loses its digits in f32 and the two packages' gradients differ by
        # about 1%; values of 0.1 give the field something to say
        sigma = jstate.params["sigma"]
        table = sigma["table"]
        table = {**table, "hash": table["hash"] * 1e3} if isinstance(table, dict) else table * 1e3
        jstate = jstate._replace(params={**jstate.params, "sigma": {**sigma, "table": table}})
    _, tcfg = tp.mapper_configs(float(jcube.scale_factor), dtype, hash_term)
    tcfg2, tcube, _, twindow = flagship(device="cpu", cfg=tcfg, **tp.SCAN)
    assert tcfg2 == tcfg
    return jcfg, jcube, jstate, jwindow, tcfg, tcube, twindow


_jax_loss_and_grads = tp.jax_loss_and_grads


CASES = {
    # (freeze_sigma, freeze_rgb, freeze_poses, do_occ_update), pose mask
    "joint": ((False, False, False, False), (0.0, 1.0, 0.0, 0.0)),
    "frozen": ((False, True, True, False), (0.0, 0.0, 0.0, 0.0)),
    "occ_update": ((False, True, False, True), (1.0, 1.0, 1.0, 1.0)),
}
# Normwise relative bounds on gradients and moments. f32: the two packages
# sum in other orders (and the pdf CDF differs by ulps); measured ~1e-6.
# bf16: the MLP operands and its input gradient round to bf16 on both sides,
# and an operand on a rounding boundary rounds one bf16 ulp apart; measured
# ~2e-5 on the pose gradient.
TOL = {"float32": 1e-5, "bfloat16": 1e-3}
# With the hash term on, the pose gradient goes through the hash level's
# point gradient, which changes with the point at the level's resolution (511
# cells across the cube for the triad level): the sampled z, whose CDF the two
# packages sum in other orders (a few ulps), moves it (and its Adam moment)
# by about 1.5e-5.
POSE_TOL_HASH = 1e-4
# Adam's first step is lr * g / (|g| + 1e-8), which for |g| near 1e-8 follows
# g's last digits; hash-table rows hit only by samples far behind the surface
# get gradients that small (some are one ulp of a difference, +-1.5e-9 apart
# in sign between the packages). With the hash term on, the sigma group's step
# is held where |g| >= 1e-6: normwise and each entry within lr/5.
ADAM_STEP_MIN_GRAD = 1e-6


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(case, dtype):
    _check_step(case, dtype, "off")


@pytest.mark.parametrize("case", ["joint", "frozen"])
@pytest.mark.parametrize("hash_term", ["triad_hash", "fused", "cell", "packed", "exact"])
def test_hash_on_train_step_matches_jax(hash_term, case):
    """The hash term's strided table gradient is drawn from the JAX step's
    own encoder key, handed over as ``enc_key`` (CellHash's corner uniforms,
    drawn from that key inside the JAX backward, as ``u_enc``); the table's
    gradient is in the sigma group and held to the same bound."""
    jcfg, _, jstate, _, tcfg, _, _ = _setup("float32", hash_term)
    assert jcfg.nerf.encoding_impl == tcfg.nerf.encoding_impl
    table = jstate.params["sigma"]["table"]
    assert [a.shape for a in tp.leaves(tp.np_tree(table))] == [
        a.shape for a in tp.leaves(state_from_jax(tp.np_tree(jstate), device="cpu").params["sigma"]["table"])]
    if hash_term == "triad_hash":
        # the same leaf order on both sides: the carried state, its moments
        # and a fresh state of the port
        tstate = state_from_jax(tp.np_tree(jstate), device="cpu")
        fresh = topt.init_mapper_state(torch.Generator(), tcfg, device="cpu")
        assert sorted(table) == list(tstate.params["sigma"]["table"]) == list(tstate.opt_sigma.mu["table"]) \
            == list(fresh.params["sigma"]["table"]) == ["cp", "hash"]
        assert [a.shape for a in topt.tree_leaves(tstate.params["sigma"]["table"])] == [
            a.shape for a in topt.tree_leaves(fresh.params["sigma"]["table"])]
    _check_step(case, "float32", hash_term)


def _check_step(case, dtype, hash_term):
    jcfg, jcube, jstate, jwindow, tcfg, tcube, twindow = _setup(dtype, hash_term)
    (fs, fr, fp, occ), mask = CASES[case]
    tol = TOL[dtype]
    pose_tol = tol if hash_term == "off" else POSE_TOL_HASH

    body = jopt.make_train_step_body(jcfg, jcube)
    jflags = jopt.TrainStepFlags(*(jnp.asarray(f) for f in (fs, fr, fp, occ)))
    jnew, jaux = body(not fp, jstate, jwindow, KEY, jflags, jnp.asarray(mask, jnp.float32), jnp.asarray(0))
    jnew = tp.np_tree(jnew)
    jloss, jg_params, jg_poses = _jax_loss_and_grads(jcfg, jcube, jstate, jwindow, KEY, not fp)

    state = state_from_jax(tp.np_tree(jstate), device="cpu")
    step = topt.make_train_step(tcfg, tcube, device="cpu")
    draws = tp.torch_draws(tp.jax_step_draws(KEY, jcfg, jwindow))
    new, aux = step(state, twindow, topt.TrainStepFlags(fs, fr, fp, occ), torch.tensor(mask), 0, draws)

    assert bool(aux["finite"]) and bool(jaux["finite"])
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(aux["loss"]), jloss, rtol=1e-5)
    for k in ("depth_mse", "los_loss", "opacity_loss", "n_valid", "n_opaque"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-4, atol=1e-6, err_msg=k)

    # every gradient group
    assert tp.rel_err(aux["grads"]["sigma"], jg_params["sigma"]) <= tol
    assert all(float(np.abs(g).max()) == 0.0 for g in tp.leaves(aux["grads"]["intensity"]))
    if fp:
        assert float(aux["grads"]["poses"].abs().max()) == 0.0
    else:
        assert tp.rel_err(aux["grads"]["poses"], jg_poses) <= pose_tol
        assert np.abs(jg_poses[:2]).max() > 0

    # the new state: counters exactly; moments and parameter deltas normwise;
    # each parameter within lr/5 (a first Adam step moves it by g/(|g|+eps)
    # * lr, which for a gradient near 1e-8 depends on its last digits)
    assert int(new.global_step) == int(jnew.global_step) == 1
    assert int(new.skipped_steps) == int(jnew.skipped_steps) == 0
    for name in ("opt_sigma", "opt_intensity", "opt_poses", "opt_occ"):
        assert int(getattr(new, name).count) == int(jopt_count(getattr(jnew, name))), name
    for group, lr in (("sigma", tcfg.lr_sigma), ("intensity", tcfg.lr_rgb)):
        dt = tp.leaves(topt.tree_map(torch.sub, new.params[group], state.params[group]))
        dj = tp.leaves(jax.tree.map(np.subtract, jnew.params[group], tp.np_tree(jstate.params[group])))
        pt, pj = tp.leaves(new.params[group]), tp.leaves(jnew.params[group])
        if group == "sigma" and hash_term != "off":
            keep = [np.abs(g) >= ADAM_STEP_MIN_GRAD for g in tp.leaves(jg_params["sigma"])]
            dt, dj, pt, pj = ([a[k] for a, k in zip(x, keep)] for x in (dt, dj, pt, pj))
        assert tp.rel_err(dt, dj) <= max(tol, 1e-3), group
        tp.assert_trees_close(pt, pj, rtol=0, atol=lr * 0.2, what=group)
    ja_s = jopt_adam(jnew.opt_sigma)
    assert tp.rel_err(new.opt_sigma.mu, ja_s.mu) <= tol
    assert tp.rel_err(new.opt_sigma.nu, ja_s.nu) <= 2 * tol
    np.testing.assert_allclose(tp.t2n(new.poses), jnew.poses, rtol=0, atol=tcfg.lr_pose * 0.2)
    moved = np.abs(tp.t2n(new.poses) - tp.t2n(state.poses)).sum(axis=1)
    assert np.array_equal(moved > 0, np.abs(jnew.poses - np.asarray(jstate.poses)).sum(axis=1) > 0)
    if not fp:
        ja_p = jopt_adam(jnew.opt_poses)
        assert tp.rel_err(new.opt_poses.mu, ja_p.mu) <= pose_tol
    if occ:
        dj = jnew.occ_grid - np.asarray(jstate.occ_grid)
        assert np.abs(dj).max() > 0
        assert tp.rel_err(new.occ_grid - state.occ_grid, dj) <= tol
        assert tp.rel_err(new.opt_occ.mu, jopt_adam(jnew.opt_occ).mu) <= tol
    else:
        assert torch.equal(new.occ_grid, state.occ_grid)
    if fr:
        tp.assert_trees_close(new.params["intensity"], state.params["intensity"], 0, 0, "frozen intensity")


def jopt_adam(chain):
    return next(s for s in jax.tree.leaves(chain, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))


def jopt_count(chain):
    return jopt_adam(chain).count


@pytest.mark.parametrize("wd,gamma", [(0.0, 1.0), (1e-2, 0.9)])
def test_adam_matches_optax(wd, gamma):
    """Three updates of one group: coupled L2 before Adam, the count
    incremented before the bias correction, lr * gamma**count."""
    import optax

    rng = np.random.default_rng(12)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32), "b": [rng.normal(size=4).astype(np.float32)]}
    schedule = 0.01 if gamma == 1.0 else (lambda count: 0.01 * gamma**count)
    tx = optax.chain(optax.add_decayed_weights(wd) if wd else optax.identity(), optax.adam(schedule))
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = tx.init(jp)
    tparams = topt.tree_map(torch.as_tensor, params)
    ts = topt.adam_init(tparams)
    for i in range(3):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32) * 10.0 ** (i - 1), params)
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, ts = topt.adam_updates(topt.tree_map(torch.as_tensor, g), ts, tparams, 0.01, gamma, wd)
        tparams = topt.tree_map(torch.add, tparams, tupd)
    tp.assert_trees_close(tparams, tp.np_tree(jp), rtol=1e-6, atol=1e-7, what="params")
    ja = jopt_adam(js)
    assert int(ts.count) == int(ja.count) == 3
    tp.assert_trees_close(ts.mu, tp.np_tree(ja.mu), rtol=1e-6, atol=1e-8, what="mu")
    tp.assert_trees_close(ts.nu, tp.np_tree(ja.nu), rtol=1e-6, atol=1e-8, what="nu")


def test_non_finite_step_leaves_params_moments_and_counts():
    jcfg, jcube, jstate, jwindow, tcfg, tcube, twindow = _setup("float32")
    # one step first, so that the moments and counts are not all zero
    flags = (False, False, False, True)
    state = state_from_jax(tp.np_tree(jstate), device="cpu")
    step = topt.make_train_step(tcfg, tcube, device="cpu", generator=torch.Generator().manual_seed(3))
    mask = torch.ones(tcfg.max_keyframes)
    state, aux = step(state, twindow, topt.TrainStepFlags(*flags), mask, 0)
    assert bool(aux["finite"])
    poisoned = state.params["sigma"]["mlp"]["w"][0].clone()
    poisoned[0, 0] = float("nan")
    bad = state._replace(params={**state.params, "sigma": {**state.params["sigma"], "mlp": {
        "w": [poisoned] + state.params["sigma"]["mlp"]["w"][1:], "b": state.params["sigma"]["mlp"]["b"]}}})
    new, aux = step(bad, twindow, topt.TrainStepFlags(*flags), mask, 1)
    assert not bool(aux["finite"])
    assert int(new.global_step) == 2 and int(new.skipped_steps) == 1
    for a, b in zip(tp.leaves((new.params, new.poses, new.occ_grid, new.opt_sigma, new.opt_intensity,
                               new.opt_poses, new.opt_occ)),
                    tp.leaves((bad.params, bad.poses, bad.occ_grid, bad.opt_sigma, bad.opt_intensity,
                               bad.opt_poses, bad.opt_occ))):
        np.testing.assert_array_equal(a, b)

    # the JAX step does the same from the same poisoned state
    jbad = jax.tree.map(jnp.asarray, tp.np_tree(jstate))
    w0 = jbad.params["sigma"]["mlp"]["w"][0].at[0, 0].set(jnp.nan)
    jbad = jbad._replace(params={**jbad.params, "sigma": {**jbad.params["sigma"], "mlp": {
        "w": [w0] + list(jbad.params["sigma"]["mlp"]["w"][1:]), "b": jbad.params["sigma"]["mlp"]["b"]}}})
    jflags = jopt.TrainStepFlags(*(jnp.asarray(f) for f in flags))
    jnew, jaux = jopt.make_train_step_body(jcfg, jcube)(True, jbad, jwindow, KEY, jflags, jnp.ones(4), jnp.asarray(0))
    assert not bool(jaux["finite"]) and int(jnew.skipped_steps) == 1
    assert int(jopt_count(jnew.opt_sigma)) == int(jopt_count(jbad.opt_sigma))


def test_window_and_flagship_match_jax():
    jcfg, jcube, jstate, jwindow, tcfg, tcube, twindow = _setup("float32")
    for name in jwindow._fields:
        np.testing.assert_array_equal(tp.t2n(getattr(twindow, name)), np.asarray(getattr(jwindow, name)), err_msg=name)
    assert tcube.scale_factor == float(jcube.scale_factor)
    np.testing.assert_array_equal(tcube.shift.numpy(), np.asarray(jcube.shift))
    assert tcfg.world_scale == jcfg.world_scale and tcfg.ray_range == jcfg.ray_range
    _, _, tstate, _ = flagship(device="cpu", cfg=tcfg, **tp.SCAN)
    jposes = np.asarray(tp.jax_flagship_tiny()[2].poses)
    np.testing.assert_allclose(tp.t2n(tstate.poses), jposes, rtol=1e-5, atol=1e-6)
    # same parameter tree and shapes as the JAX state, with the port's own draws
    jp = tp.leaves(tp.np_tree(jstate.params))
    assert [a.shape for a in tp.leaves(tstate.params)] == [a.shape for a in jp]


def test_window_rays_match_jax_with_the_jax_draws():
    jcfg, jcube, jstate, jwindow, tcfg, tcube, twindow = _setup("float32")
    k_rays = jax.random.split(KEY, 3)[0]
    jb = jopt.build_window_rays(jstate.poses, jwindow, jcube, jcfg, k_rays, 0)
    d = tp.torch_draws(tp.jax_step_draws(KEY, jcfg, jwindow))
    tb = topt.build_window_rays(
        torch.as_tensor(np.asarray(jstate.poses)), twindow, tcube, tcfg, d.ray_idx, d.sky_idx
    )
    for name in jb._fields:
        np.testing.assert_allclose(tp.t2n(getattr(tb, name)), np.asarray(getattr(jb, name)), rtol=1e-6, atol=1e-6, err_msg=name)
    # MASK over keyframes without trunk-band indices (band_idx = arange)
    # draws exactly as RANDOM
    tm = topt.build_window_rays(torch.as_tensor(np.asarray(jstate.poses)), twindow, tcube,
                                tcfg._replace(rays_strategy="MASK"), d.ray_idx, d.sky_idx)
    for name in tb._fields:
        assert torch.equal(getattr(tm, name), getattr(tb, name)), name


def test_state_from_jax_and_own_draws():
    jcfg, jcube, jstate, jwindow, tcfg, tcube, twindow = _setup("float32")
    state = state_from_jax(tp.np_tree(jstate), device="cpu")
    assert state.global_step.dtype == torch.int32 and state.opt_sigma.count.dtype == torch.int32
    tp.assert_trees_close(state.params, tp.np_tree(jstate.params), 0, 0, "params")
    fresh = topt.init_mapper_state(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert [a.shape for a in tp.leaves(fresh)] == [a.shape for a in tp.leaves(state)]
    # without draws the step draws from its generator: same seed, same step
    flags = topt.TrainStepFlags(False, True, True, False)
    mask = torch.zeros(tcfg.max_keyframes)
    outs = []
    for _ in range(2):
        step = topt.make_train_step(tcfg, tcube, device="cpu", generator=torch.Generator().manual_seed(5))
        outs.append(step(state, twindow, flags, mask, 0)[1]["loss"])
    assert bool(torch.isfinite(outs[0])) and torch.equal(outs[0], outs[1])
