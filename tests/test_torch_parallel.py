"""The port's multi-device layer (loner_tpu_torch/parallel/) against the JAX
package's sharded programs and against the port's own single-device
programs, on the CPU: JAX on the virtual 8-device mesh of
``tests/conftest.py``, the port on meshes of the CPU repeated (one
controller drives a mesh; a device may repeat). DP over the window's
keyframes (hash off, the triad's hash level, FusedHash, the alternate
encoders), ``apply_updates=False``, hash-table TP (mirroring
``tests/test_tp_sharding.py``), submap-parallel EP (mirroring
``tests/test_submap_parallel.py``), the pose graph's and the camera step's
mesh forms, and the multichip dry run."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.mapping import optimizer as jopt
from loner_tpu_torch import device as tdevice
from loner_tpu_torch.convert import state_from_jax
from loner_tpu_torch.flagship import flagship
from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.ops import fused_encoder as tfe
from loner_tpu_torch.parallel import sharding as tsh
from loner_tpu_torch.parallel import submaps_parallel as tsp
from loner_tpu_torch.parallel import tp as ttp

import torch_parity as tp
from torch_parity import two_threads  # noqa: F401 (autouse: two torch threads)

KEY = jax.random.PRNGKey(11)
W = 8  # keyframes a window: 2, 4 and 8 devices divide it
SIZES = dict(window_size=W, max_keyframes=W)
CASES = {  # (freeze_sigma, freeze_rgb, freeze_poses, do_occ_update)
    "joint": (False, False, False, False),
    "frozen": (False, True, True, False),
    "occ_update": (False, True, False, True),
}
# Normwise bound on gradients and moments (f32), as the single-step parity
# of tests/test_torch_train_step.py; the loss 1e-5 relative against JAX, 1e-6
# against the port's own single step (the same per-ray work, the window's
# sums in another order).
TOL = 1e-5
ADAM_STEP_MIN_GRAD = 1e-6  # as test_torch_train_step.py: Adam's first step follows tiny g's last digits


def cpu_mesh(n, tp_=None):
    devs = ["cpu"] * n
    if tp_ is None:
        return tsh.Mesh(devs, ("data",))
    return tsh.Mesh(np.reshape(np.asarray(devs, object), (n // tp_, tp_)), ("data", "model"))


@functools.lru_cache(maxsize=None)
def _setup(hash_term="off", dtype="float32", **changes):
    """JAX (cfg, cube, state, window) of an 8-keyframe window with pose 1
    perturbed (hash tables scaled to 0.1, as the single-step parity does),
    and the port's (cfg, cube, state, window) from the same scans; the MLP
    in ``dtype``."""
    sizes = {**SIZES, **changes}
    jcfg, jcube, jstate, jwindow = tp.jax_flagship_tiny(dtype, hash_term=hash_term, n_keyframes=W, **sizes)
    jstate = jstate._replace(poses=jstate.poses.at[1, 0].add(0.05).at[1, 5].add(0.02))
    if hash_term not in ("off",):
        sigma = jstate.params["sigma"]
        table = sigma["table"]
        table = {**table, "hash": table["hash"] * 1e3} if isinstance(table, dict) else table * 1e3
        jstate = jstate._replace(params={**jstate.params, "sigma": {**sigma, "table": table}})
    _, tcfg = tp.mapper_configs(float(jcube.scale_factor), dtype, hash_term, **sizes)
    tcfg2, tcube, _, twindow = flagship(device="cpu", cfg=tcfg, **{**tp.SCAN, "n_keyframes": W})
    assert tcfg2 == tcfg
    return jcfg, jcube, jstate, jwindow, tcfg, tcube, twindow


def _port(hash_term="off", dtype="float32", **changes):
    jcfg, jcube, jstate, jwindow, tcfg, tcube, twindow = _setup(hash_term, dtype, **changes)
    return tcfg, tcube, state_from_jax(tp.np_tree(jstate), device="cpu"), twindow


def _flags(case):
    return topt.TrainStepFlags(*CASES[case])


def _mask(cfg):
    return torch.ones(cfg.max_keyframes)


def _assert_sigma_update(new, jnew, state, jstate, jg_params, cfg, hash_on):
    """The sigma group's step as the single-step parity holds it: the
    parameter deltas 1e-3 normwise and each parameter within lr/5 of JAX's;
    with a hash table, where JAX's gradient is at least 1e-6."""
    dt = tp.leaves(topt.tree_map(torch.sub, new.params["sigma"], state.params["sigma"]))
    dj = tp.leaves(jax.tree.map(np.subtract, jnew.params["sigma"], tp.np_tree(jstate.params["sigma"])))
    pt, pj = tp.leaves(new.params["sigma"]), tp.leaves(jnew.params["sigma"])
    if hash_on:
        keep = [np.abs(g) >= ADAM_STEP_MIN_GRAD for g in tp.leaves(jg_params["sigma"])]
        dt, dj, pt, pj = ([a[k] for a, k in zip(x, keep)] for x in (dt, dj, pt, pj))
    assert tp.rel_err(dt, dj) <= 1e-3
    tp.assert_trees_close(pt, pj, rtol=0, atol=cfg.lr_sigma * 0.2, what="sigma")


# ---------------------------------------------------------------------------
# DP against JAX's make_sharded_train_step
# ---------------------------------------------------------------------------

# every field on 2, 4 and 8 devices, and every step kind on each device count
DP_JAX = [(2, "off", "joint"), (4, "off", "frozen"), (8, "off", "occ_update"), (8, "off", "joint"),
          (2, "triad_hash", "occ_update"), (4, "triad_hash", "joint"), (8, "triad_hash", "frozen"),
          (2, "fused", "frozen"), (4, "fused", "occ_update"), (8, "fused", "joint")]


@pytest.mark.parametrize("n,hash_term,case", DP_JAX)
def test_dp_step_matches_jax(n, hash_term, case):
    """The port's sharded step with JAX's draws handed over, against JAX's
    sharded step on the virtual mesh: loss 1e-5, gradients (against the
    JAX forward's) and the new state at the single-step parity's bounds."""
    _check_dp_against_jax(n, hash_term, case, "float32")


# the bf16 MLP (the flagship's): 2, 4 and 8 devices under each field
DP_JAX_BF16 = [(2, "off", "joint"), (4, "off", "occ_update"), (8, "off", "frozen"),
               (2, "triad_hash", "frozen"), (4, "triad_hash", "joint"), (8, "triad_hash", "joint"),
               (2, "fused", "joint"), (4, "fused", "frozen"), (8, "fused", "joint")]
# the bf16 single-step parity's bound (tests/test_torch_train_step.py): the
# MLP operands round to bf16 on both sides, and an operand on a rounding
# boundary rounds one bf16 ulp apart
TOL_BF16 = 1e-3


@pytest.mark.parametrize("n,hash_term,case", DP_JAX_BF16)
def test_dp_bf16_step_matches_jax(n, hash_term, case):
    """As :func:`test_dp_step_matches_jax` with the bf16 MLP, at the bf16
    single-step parity's bounds: JAX's sharded step sums the shards' weight
    gradients in f32 and rounds the sum to bf16 once, as the port does."""
    _check_dp_against_jax(n, hash_term, case, "bfloat16")


@pytest.mark.parametrize("n,hash_term,case,chunks", [(4, "off", "joint", 2)])
def test_dp_bf16_point_chunks_matches_jax(n, hash_term, case, chunks):
    """As :func:`test_dp_bf16_step_matches_jax` with the field in point
    chunks: JAX's sharded step rounds the weight gradient once per chunk of
    the window, after the sum over the shards."""
    _check_dp_against_jax(n, hash_term, case, "bfloat16", train_point_chunks=chunks)


def _check_dp_against_jax(n, hash_term, case, dtype, **changes):
    from loner_tpu.parallel.sharding import make_mesh as j_make_mesh, make_sharded_train_step as j_sharded

    jcfg, jcube, jstate, jwindow, tcfg, tcube, twindow = _setup(hash_term, dtype)
    jcfg, tcfg = jcfg._replace(**changes), tcfg._replace(**changes)
    tol = TOL if dtype == "float32" else TOL_BF16
    fs, fr, fp, occ = CASES[case]
    jflags = jopt.TrainStepFlags(*(jnp.asarray(f) for f in CASES[case]))
    jnew, jaux = j_sharded(jcfg, jcube, j_make_mesh(n))(jstate, jwindow, KEY, jflags, jnp.ones(W), jnp.asarray(0))
    jnew = tp.np_tree(jnew)
    jloss, jg_params, jg_poses = tp.jax_loss_and_grads(jcfg, jcube, jstate, jwindow, KEY, not fp,
                                                       jcfg.train_point_chunks)

    state = state_from_jax(tp.np_tree(jstate), device="cpu")
    step = tsh.make_sharded_train_step(tcfg, tcube, cpu_mesh(n))
    new, aux = step(state, twindow, _flags(case), _mask(tcfg), 0, tp.torch_draws(tp.jax_step_draws(KEY, jcfg, jwindow)))

    assert bool(aux["finite"]) and bool(jaux["finite"])
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(aux["loss"]), jloss, rtol=1e-5)
    assert tp.rel_err(aux["grads"]["sigma"], jg_params["sigma"]) <= tol
    if not fp:
        assert tp.rel_err(aux["grads"]["poses"], jg_poses) <= (tol if hash_term == "off" else max(tol, 1e-4))
    assert int(new.global_step) == int(jnew.global_step) == 1
    _assert_sigma_update(new, jnew, state, jstate, jg_params, tcfg, hash_term != "off")
    np.testing.assert_allclose(tp.t2n(new.poses), jnew.poses, rtol=0, atol=tcfg.lr_pose * 0.2)
    if occ:
        assert tp.rel_err(new.occ_grid - state.occ_grid, jnew.occ_grid - np.asarray(jstate.occ_grid)) <= tol


# ---------------------------------------------------------------------------
# DP against the port's own single-device step
# ---------------------------------------------------------------------------


def _single_and_sharded(cfg, cube, state, window, mesh, case, draws, **kw):
    single = topt.make_train_step(cfg, cube, "cpu", **kw)(state, window, _flags(case), _mask(cfg), 0, draws)
    sharded = tsh.make_sharded_train_step(cfg, cube, mesh, **kw)(state, window, _flags(case), _mask(cfg), 0, draws)
    return single, sharded


def _assert_same_step(single, sharded, pose_grads=True):
    (s1, a1), (sn, an) = single, sharded
    np.testing.assert_allclose(float(an["loss"]), float(a1["loss"]), rtol=1e-6)
    assert tp.rel_err(an["grads"]["sigma"], a1["grads"]["sigma"]) <= TOL
    if pose_grads:
        assert tp.rel_err(an["grads"]["poses"], a1["grads"]["poses"]) <= TOL
    assert tp.rel_err(sn.opt_sigma.mu, s1.opt_sigma.mu) <= TOL
    assert tp.rel_err(sn.occ_grid, s1.occ_grid) <= TOL


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("hash_term", ["off", "triad_hash", "fused", "cell", "packed"])
def test_dp_matches_single_step(hash_term, n):
    """The same draws through the port's single step and its sharded step:
    the loss within 1e-6 relative, gradients and moments within 1e-5
    normwise, on a joint step with the occupancy update."""
    cfg, cube, state, window = _port(hash_term)
    draws = topt.draw_step(cfg, window, torch.Generator().manual_seed(5), "cpu")
    single, sharded = _single_and_sharded(cfg, cube, state, window, cpu_mesh(n), "occ_update", draws)
    _assert_same_step(single, sharded)


# A bf16 rounding flip of one weight's gradient, from summing in another
# order, reads about 5e-5 normwise; rounding each shard's gradient before the
# sum read 1.78e-3 on a mesh of 4.
BF16_SHARDED = 1e-4


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("hash_term", ["off", "triad_hash", "fused"])
def test_dp_bf16_matches_single_step(hash_term, n, capsys):
    """With the bf16 MLP, the port's sharded step against its own single
    step on the same draws: the weights round once, on the first device,
    so the shards' weight gradients sum in f32 before the one rounding.
    Sigma and pose gradients and the moments within 1e-4 normwise (the
    measured value is printed; about 1e-7 expected), the loss 1e-6."""
    cfg, cube, state, window = _port(hash_term, "bfloat16")
    assert cfg.nerf.compute_dtype == "bfloat16"
    draws = topt.draw_step(cfg, window, torch.Generator().manual_seed(5), "cpu")
    (s1, a1), (sn, an) = _single_and_sharded(cfg, cube, state, window, cpu_mesh(n), "joint", draws)
    err = tp.rel_err(an["grads"]["sigma"], a1["grads"]["sigma"])
    with capsys.disabled():
        print(f"\nbf16 sharded over {n} ({hash_term}) against the single step: sigma gradients {err:.3e} normwise")
    np.testing.assert_allclose(float(an["loss"]), float(a1["loss"]), rtol=1e-6)
    assert err <= BF16_SHARDED
    assert tp.rel_err(an["grads"]["poses"], a1["grads"]["poses"]) <= BF16_SHARDED
    assert tp.rel_err(sn.opt_sigma.mu, s1.opt_sigma.mu) <= BF16_SHARDED


@pytest.mark.parametrize("chunks", [2, 5])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("hash_term", ["off", "triad_hash"])
def test_dp_bf16_point_chunks_matches_single_step(hash_term, n, chunks, capsys):
    """With the bf16 MLP and ``train_point_chunks`` 2 and 5, the sharded
    step against the single step on the same draws: the weight gradient
    rounds once per chunk of the window (5120 or 2048 points), after the
    sum over the rows that hold the chunk's points, as the single step and
    JAX round it. Sigma gradients 1e-4 normwise (the measured value is
    printed; about 1e-7 expected), the loss 1e-6."""
    cfg, cube, state, window = _port(hash_term, "bfloat16")
    cfg = cfg._replace(train_point_chunks=chunks)
    draws = topt.draw_step(cfg, window, torch.Generator().manual_seed(5), "cpu")
    (s1, a1), (sn, an) = _single_and_sharded(cfg, cube, state, window, cpu_mesh(n), "joint", draws)
    err = tp.rel_err(an["grads"]["sigma"], a1["grads"]["sigma"])
    with capsys.disabled():
        print(f"\nbf16 sharded over {n} ({hash_term}, {chunks} point chunks) against the single step: "
              f"sigma gradients {err:.3e} normwise")
    np.testing.assert_allclose(float(an["loss"]), float(a1["loss"]), rtol=1e-6)
    assert err <= BF16_SHARDED
    assert tp.rel_err(an["grads"]["poses"], a1["grads"]["poses"]) <= BF16_SHARDED
    assert tp.rel_err(sn.opt_sigma.mu, s1.opt_sigma.mu) <= BF16_SHARDED


def test_single_step_keeps_the_weights_rounding_per_pass(monkeypatch):
    """The one-device step never takes the pre-rounded weights: its MLP
    rounds each weight itself, as before; a sharded step rounds them once."""
    calls = []
    round_weights = topt.round_weights
    monkeypatch.setattr(topt, "round_weights", lambda *a: calls.append(1) or round_weights(*a))
    cfg, cube, state, window = _port("off", "bfloat16")
    draws = topt.draw_step(cfg, window, torch.Generator().manual_seed(5), "cpu")
    topt.make_train_step(cfg, cube, "cpu")(state, window, _flags("joint"), _mask(cfg), 0, draws)
    assert calls == []
    tsh.make_sharded_train_step(cfg, cube, cpu_mesh(2))(state, window, _flags("joint"), _mask(cfg), 0, draws)
    assert calls == [1]


@pytest.mark.parametrize("hash_term", ["cell", "packed"])
@pytest.mark.parametrize("n", [2, 8])
def test_dp_point_chunks_across_shards(hash_term, n):
    """``train_point_chunks`` 5, whose chunks (2048 points) the shards'
    blocks (5120 or 1280 points) do not follow: each point takes the corner
    uniform of its place in the window's chunks ("cell"), and the sharded
    step equals the single one."""
    cfg, cube, state, window = _port(hash_term, train_point_chunks=5)
    draws = topt.draw_step(cfg, window, torch.Generator().manual_seed(6), "cpu")
    if hash_term == "cell":
        assert draws.u_enc.shape[-1] == W * 40 * 32 // 5
    single, sharded = _single_and_sharded(cfg, cube, state, window, cpu_mesh(n), "joint", draws)
    _assert_same_step(single, sharded)


def test_shard_u_enc_takes_each_points_window_uniform():
    u = torch.arange(12.0).reshape(1, 12)  # a chunk of 12 points, shared by every chunk
    np.testing.assert_array_equal(topt._shard_u_enc(u, 30, 8, 48).numpy(), [[6, 7, 8, 9, 10, 11, 0, 1]])
    assert topt._shard_u_enc(u, 0, 48, 48) is u


def test_dp_window_not_divisible_runs_whole_on_first_device():
    """A window of 8 over 3 devices runs whole on the first, as JAX
    replicates it: the same result as the single step, one render."""
    cfg, cube, state, window = _port()
    draws = topt.draw_step(cfg, window, torch.Generator().manual_seed(7), "cpu")
    calls = []
    single, sharded = _single_and_sharded(cfg, cube, state, window, cpu_mesh(3), "joint", draws)
    _assert_same_step(single, sharded)
    step = topt.make_mesh_train_step(cfg, cube, [("cpu",)] * 3)
    orig = topt.compute_lidar_loss
    try:
        topt.compute_lidar_loss = lambda render, *a, **k: calls.append(render.weights.shape) or orig(render, *a, **k)
        step(state, window, _flags("joint"), _mask(cfg), 0, draws)
    finally:
        topt.compute_lidar_loss = orig
    assert calls == [(W * 40, 32)]


def test_dp_three_keyframe_window_over_two_devices():
    """A window whose size the mesh does not divide (3 keyframes over 2
    devices) runs whole on the first. The mapper never builds such a window
    here (its windows repeat keyframes up to the window size); this is the
    non-dividing case of the sharded step."""
    cfg, cube, state, window = _port()
    window3 = type(window)(*(t[:3] for t in window))
    draws = topt.draw_step(cfg, window3, torch.Generator().manual_seed(8), "cpu")
    single, sharded = _single_and_sharded(cfg, cube, state, window3, cpu_mesh(2), "joint", draws)
    _assert_same_step(single, sharded)


def test_dp_draws_its_own_numbers_on_the_first_device():
    """Without draws, the sharded step draws the whole window's numbers from
    its generator, as the single step does from the same seed."""
    cfg, cube, state, window = _port()
    outs = []
    for mesh in (None, cpu_mesh(4)):
        gen = torch.Generator().manual_seed(9)
        step = (topt.make_train_step(cfg, cube, "cpu", gen) if mesh is None
                else tsh.make_sharded_train_step(cfg, cube, mesh, generator=gen))
        outs.append(step(state, window, _flags("joint"), _mask(cfg), 0)[1])
    np.testing.assert_allclose(float(outs[1]["loss"]), float(outs[0]["loss"]), rtol=1e-6)
    assert tp.rel_err(outs[1]["grads"]["sigma"], outs[0]["grads"]["sigma"]) <= TOL


def test_non_finite_guard_is_one_verdict_for_the_window():
    """A NaN in one shard's block skips the whole step on every device."""
    cfg, cube, state, window = _port()
    dists = window.dists.clone()
    dists[W - 1] = float("nan")
    bad = window._replace(dists=dists)
    new, aux = tsh.make_sharded_train_step(cfg, cube, cpu_mesh(4))(state, bad, _flags("occ_update"), _mask(cfg), 0)
    assert not bool(aux["finite"]) and int(new.skipped_steps) == 1
    for a, b in zip(tp.leaves((new.params, new.poses, new.occ_grid, new.opt_sigma)),
                    tp.leaves((state.params, state.poses, state.occ_grid, state.opt_sigma))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# apply_updates=False
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_n", [None, 4])
def test_apply_updates_false_keeps_the_state(mesh_n):
    """The loss and the gradients of the updating step; parameters, moments,
    poses and grid come back as they were (the same tensors), and only the
    counters advance, as in the JAX package (``optimizer.py:326``)."""
    cfg, cube, state, window = _port()
    draws = topt.draw_step(cfg, window, torch.Generator().manual_seed(10), "cpu")
    make = ((lambda au: topt.make_train_step(cfg, cube, "cpu", apply_updates=au)) if mesh_n is None
            else (lambda au: tsh.make_sharded_train_step(cfg, cube, cpu_mesh(mesh_n), apply_updates=au)))
    upd_state, upd = make(True)(state, window, _flags("occ_update"), _mask(cfg), 0, draws)
    new, aux = make(False)(state, window, _flags("occ_update"), _mask(cfg), 0, draws)
    assert float(aux["loss"]) == float(upd["loss"])
    for group in ("sigma", "poses"):
        for a, b in zip(tp.leaves(aux["grads"][group]), tp.leaves(upd["grads"][group])):
            np.testing.assert_array_equal(a, b)
    for name in ("params", "poses", "opt_sigma", "opt_intensity", "opt_poses", "occ_grid", "opt_occ"):
        for a, b in zip(topt.tree_leaves(getattr(new, name)), topt.tree_leaves(getattr(state, name))):
            assert a is b, name
    assert int(new.global_step) == int(upd_state.global_step) == 1 and int(new.skipped_steps) == 0
    assert not torch.equal(upd_state.occ_grid, state.occ_grid)


# ---------------------------------------------------------------------------
# hash-table TP (tests/test_tp_sharding.py, case by case)
# ---------------------------------------------------------------------------


def _tp_setup(hash_term="triad_hash_tp"):
    cfg, cube, state, window = _port(hash_term)
    return cfg, cube, state, window


def _run_steps(step, state, window, cfg, n=3):
    flags = topt.TrainStepFlags(freeze_sigma=False, freeze_rgb=True, freeze_poses=False, do_occ_update=True)
    gen = torch.Generator().manual_seed(3)
    losses = []
    for i in range(n):
        draws = topt.draw_step(cfg, window, gen, "cpu")
        state, aux = step(state, window, flags, _mask(cfg), i, draws)
        losses.append(float(aux["loss"]))
    return state, losses


class TestTPSharding:
    def test_triad_table_leaves_get_model_sharding(self):
        """The triad's hash level (2^13 cells) splits over "model"; the CP
        lines and the MLPs stay with the state; Adam moments mirror the
        parameters."""
        cfg, cube, state, window = _tp_setup()
        mesh = cpu_mesh(8, 2)
        where = ttp.mapper_state_shardings(state, mesh)
        assert where.params["sigma"]["table"]["hash"] == ttp.SlabPlacement(tuple(mesh.devices[0, :]))
        assert all(w == mesh.first_device for w in topt.tree_leaves(where.params["sigma"]["table"]["cp"]))
        assert all(w == mesh.first_device for w in topt.tree_leaves(where.params["sigma"]["mlp"]))
        for moments in (where.opt_sigma.mu, where.opt_sigma.nu):
            assert isinstance(moments["table"]["hash"], ttp.SlabPlacement)
            assert all(w == mesh.first_device for w in topt.tree_leaves(moments["table"]["cp"]))
        sharded = ttp.shard_mapper_state(state, mesh)
        for leaf in (sharded.params["sigma"]["table"]["hash"], sharded.opt_sigma.mu["table"]["hash"]):
            assert isinstance(leaf, tfe.TableSlabs) and [tuple(t.shape) for t in leaf] == [(1, 4096, 32)] * 2
        assert isinstance(sharded.params["sigma"]["table"]["cp"], torch.Tensor)

    def test_tp_step_matches_single_device(self):
        """Three steps on a (4, 2) mesh against the single step, with JAX's
        drift bounds (tests/test_tp_sharding.py:111-124)."""
        cfg, cube, state, window = _tp_setup()
        ref_state, ref_losses = _run_steps(topt.make_train_step(cfg, cube, "cpu"), state, window, cfg)
        tp_state, tp_losses = _run_steps(ttp.make_tp_train_step(cfg, cube, cpu_mesh(8, 2)), state, window, cfg)
        np.testing.assert_allclose(tp_losses, ref_losses, rtol=2e-4)
        assert isinstance(tp_state.params["sigma"]["table"]["hash"], tfe.TableSlabs)
        tab = tp.t2n(ttp.gather_mapper_state(tp_state).params["sigma"]["table"]["hash"])
        diff = np.abs(tab - tp.t2n(ref_state.params["sigma"]["table"]["hash"]))
        assert np.mean(diff > 5e-5) < 1e-3
        assert diff.max() < 3 * 0.01
        np.testing.assert_allclose(tp.t2n(tp_state.poses), tp.t2n(ref_state.poses), atol=1e-5)

    def test_state_survives_tp_step(self):
        """The caller's state is not changed: a second program reuses it."""
        cfg, cube, state, window = _tp_setup()
        before = [t.clone() for t in topt.tree_leaves(state)]
        step = ttp.make_tp_train_step(cfg, cube, cpu_mesh(8, 2))
        _run_steps(step, state, window, cfg, n=1)
        assert bool(torch.all(torch.isfinite(state.poses)))
        assert isinstance(state.params["sigma"]["table"]["hash"], torch.Tensor)
        for a, b in zip(topt.tree_leaves(state), before):
            assert torch.equal(a, b)
        _run_steps(step, state, window, cfg, n=1)

    def test_tp4_runs(self):
        cfg, cube, state, window = _tp_setup()
        _, losses = _run_steps(ttp.make_tp_train_step(cfg, cube, cpu_mesh(8, 4)), state, window, cfg, n=2)
        assert np.all(np.isfinite(losses))


@pytest.mark.parametrize("hash_term", ["triad_hash_tp", "fused_tp", "exact_tp", "packed_tp", "cell_tp"])
def test_tp_step_matches_jax(hash_term):
    """One DP x TP step on (4, 2) against JAX's ``make_tp_train_step`` on
    the virtual mesh, JAX's draws handed over: loss 1e-5, the new table
    within lr/5 of JAX's and its delta 1e-3 normwise where |g| >= 1e-6.
    CellHash runs its exact table gradient (level1 picks levels from the
    points' last bits, which the packages' samplers round apart:
    tests/torch_parity.py)."""
    from loner_tpu.parallel.tp import make_dp_tp_mesh as j_mesh, make_tp_train_step as j_tp

    jcfg, jcube, jstate, jwindow, tcfg, tcube, twindow = _setup(hash_term)
    jflags = jopt.TrainStepFlags(*(jnp.asarray(f) for f in CASES["joint"]))
    jnew, jaux = j_tp(jcfg, jcube, j_mesh(8, tp=2))(jstate, jwindow, KEY, jflags, jnp.ones(W), jnp.asarray(0))
    jnew = tp.np_tree(jnew)
    _, jg, _ = tp.jax_loss_and_grads(jcfg, jcube, jstate, jwindow, KEY, True)
    state = state_from_jax(tp.np_tree(jstate), device="cpu")
    new, aux = ttp.make_tp_train_step(tcfg, tcube, cpu_mesh(8, 2))(
        state, twindow, _flags("joint"), _mask(tcfg), 0, tp.torch_draws(tp.jax_step_draws(KEY, jcfg, jwindow)))
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    assert tp.rel_err(ttp.gather_mapper_state(aux["grads"]["sigma"]), jg["sigma"]) <= TOL
    _assert_sigma_update(ttp.gather_mapper_state(new), jnew, state, jstate, jg, tcfg, True)


def test_tp_bf16_step_matches_jax():
    """One DP x TP step on (4, 2) of the hash-on triad with the bf16 MLP
    against JAX's ``make_tp_train_step``, at the bf16 single-step parity's
    bounds."""
    from loner_tpu.parallel.tp import make_dp_tp_mesh as j_mesh, make_tp_train_step as j_tp

    jcfg, jcube, jstate, jwindow, tcfg, tcube, twindow = _setup("triad_hash_tp", "bfloat16")
    assert tcfg.nerf.compute_dtype == jcfg.nerf.compute_dtype == "bfloat16"
    jflags = jopt.TrainStepFlags(*(jnp.asarray(f) for f in CASES["joint"]))
    jnew, jaux = j_tp(jcfg, jcube, j_mesh(8, tp=2))(jstate, jwindow, KEY, jflags, jnp.ones(W), jnp.asarray(0))
    jnew = tp.np_tree(jnew)
    _, jg, jg_poses = tp.jax_loss_and_grads(jcfg, jcube, jstate, jwindow, KEY, True)
    state = state_from_jax(tp.np_tree(jstate), device="cpu")
    new, aux = ttp.make_tp_train_step(tcfg, tcube, cpu_mesh(8, 2))(
        state, twindow, _flags("joint"), _mask(tcfg), 0, tp.torch_draws(tp.jax_step_draws(KEY, jcfg, jwindow)))
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    assert tp.rel_err(ttp.gather_mapper_state(aux["grads"]["sigma"]), jg["sigma"]) <= TOL_BF16
    assert tp.rel_err(aux["grads"]["poses"], jg_poses) <= TOL_BF16
    _assert_sigma_update(ttp.gather_mapper_state(new), jnew, state, jstate, jg, tcfg, True)


def test_no_slab_holds_more_than_its_rows(monkeypatch):
    """Every gather reads, and every table gradient writes, one slab of T /
    tp rows; the step's table gradient and Adam moments stay in slabs."""
    cfg, cube, state, window = _tp_setup("fused_tp")
    rows = {"gather": [], "dtable": []}
    gather, strided, exact = tfe._gather_v_t, tfe._bwd_dtable_strided, tfe._bwd_dtable_exact

    def rec(kind, fn, shape_of):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            rows[kind].append(shape_of(a, out))
            return out
        return wrapped

    monkeypatch.setattr(tfe, "_gather_v_t", rec("gather", gather, lambda a, out: a[0].shape[1]))
    monkeypatch.setattr(tfe, "_bwd_dtable_strided", rec("dtable", strided, lambda a, out: out.shape[1]))
    monkeypatch.setattr(tfe, "_bwd_dtable_exact", rec("dtable", exact, lambda a, out: out.shape[1]))
    new, aux = ttp.make_tp_train_step(cfg, cube, cpu_mesh(8, 4))(state, window, _flags("joint"), _mask(cfg), 0)
    assert rows["gather"] and rows["dtable"]
    assert set(rows["gather"]) == set(rows["dtable"]) == {1024}  # 4096 cells over 4 model devices
    assert len(rows["gather"]) == 2 * 4 and len(rows["dtable"]) == 2 * 4  # 2 data rows x 4 slabs
    for tree in (aux["grads"]["sigma"]["table"], new.params["sigma"]["table"], new.opt_sigma.mu["table"]):
        assert isinstance(tree, tfe.TableSlabs) and [t.shape[1] for t in tree] == [1024] * 4


@pytest.mark.parametrize("impl", ["exact", "packed", "cell"])
def test_alternate_encoder_tables_placed_as_jax(impl):
    """CellHash's (4, 4096, 16) sigma table and its Adam moments go into
    slabs over "model" ((4, 2048, 16) on a (4, 2) mesh); the exact and
    packed masters (4, 2, 2^14) hold 2 on their second-to-last axis, under
    the 4096 from which JAX splits, and stay one tensor on the first
    device."""
    cfg, cube, state, window = _port(f"{impl}_tp")
    mesh = cpu_mesh(8, 2)
    where = ttp.mapper_state_shardings(state, mesh)
    sharded = ttp.shard_mapper_state(state, mesh)
    trees = (where.params["sigma"]["table"], where.opt_sigma.mu["table"], where.opt_sigma.nu["table"])
    leaves = (sharded.params["sigma"]["table"], sharded.opt_sigma.mu["table"], sharded.opt_sigma.nu["table"])
    if impl == "cell":
        assert all(w == ttp.SlabPlacement(tuple(mesh.devices[0, :])) for w in trees)
        for leaf in leaves:
            assert isinstance(leaf, tfe.TableSlabs) and [tuple(t.shape) for t in leaf] == [(4, 2048, 16)] * 2
        assert [tuple(t.shape) for t in sharded.params["intensity"]["table"]] == [(4, 4096, 16)] * 2
    else:
        assert all(w == mesh.first_device for w in trees)
        for leaf in leaves + (sharded.params["intensity"]["table"],):
            assert isinstance(leaf, torch.Tensor) and not isinstance(leaf, tfe.TableSlabs)
            assert leaf.device == mesh.first_device and leaf.shape[-2] == 2
        assert tuple(sharded.params["sigma"]["table"].shape) == (4, 2, 1 << 14)


@pytest.mark.parametrize("bwd", ["exact", "level1"])
def test_cell_tp_step_matches_single_device(bwd):
    """A CellHash DP x TP step on (4, 2) against the port's single step from
    one state and one set of draws, under both table gradients: the loss
    equal, the sigma table's gradient within 1e-6 of its largest entry.
    Under level1 some points choose a level above 0 in the second slab, so
    a combined index that counted the whole table's rows would show."""
    cfg, cube, state, window = _port("cell_tp")
    cfg = cfg._replace(nerf=cfg.nerf._replace(encoding_bwd=bwd))
    draws = topt.draw_step(cfg, window, torch.Generator().manual_seed(12), "cpu")
    _, single = topt.make_train_step(cfg, cube, "cpu")(state, window, _flags("joint"), _mask(cfg), 0, draws)
    _, sharded = ttp.make_tp_train_step(cfg, cube, cpu_mesh(8, 2))(state, window, _flags("joint"), _mask(cfg), 0,
                                                                    draws)
    assert float(sharded["loss"]) == float(single["loss"])
    slabs = sharded["grads"]["sigma"]["table"]
    assert isinstance(slabs, tfe.TableSlabs) and bool(torch.any(slabs[1][1:] != 0))
    g, g1 = ttp.gather_mapper_state(sharded["grads"]["sigma"])["table"], single["grads"]["sigma"]["table"]
    assert float((g - g1).abs().max()) <= 1e-6 * float(g1.abs().max())
    assert tp.rel_err(sharded["grads"]["poses"], single["grads"]["poses"]) <= TOL


def test_no_cell_slab_holds_more_than_its_rows(monkeypatch):
    """CellHash on a (2, 4) mesh: every gather reads, and every table
    gradient writes, slabs of T / 4 rows; the step's table gradient and Adam
    moments stay in slabs."""
    from loner_tpu_torch.ops import cell_hash as tch

    cfg, cube, state, window = _port("cell_tp")
    rows = {"gather": [], "dtable": []}
    gather, bwd = tch._gather_rows, tch._cell_bwd

    def gather_rec(slabs, idx):
        rows["gather"] += [s.shape[1] for s in slabs]
        return gather(slabs, idx)

    def bwd_rec(*a, **k):
        d_slabs, d_pts = bwd(*a, **k)
        rows["dtable"] += [d.shape[1] for d in d_slabs]
        return d_slabs, d_pts

    monkeypatch.setattr(tch, "_gather_rows", gather_rec)
    monkeypatch.setattr(tch, "_cell_bwd", bwd_rec)
    new, aux = ttp.make_tp_train_step(cfg, cube, cpu_mesh(8, 4))(state, window, _flags("joint"), _mask(cfg), 0)
    assert rows["gather"] == rows["dtable"] == [1024] * (2 * 4)  # 4096 cells over 4 model devices, 2 data rows
    for tree in (aux["grads"]["sigma"]["table"], new.params["sigma"]["table"], new.opt_sigma.mu["table"],
                 new.opt_sigma.nu["table"]):
        assert isinstance(tree, tfe.TableSlabs) and [t.shape[1] for t in tree] == [1024] * 4


@pytest.mark.parametrize("bwd", ["exact", "level1"])
def test_cell_encode_on_slabs_matches_whole_table(bwd):
    """``cell_hash_encode_t`` on 4 slabs against the whole table, with one
    set of corner uniforms: the features bit-equal, d_pts equal, and the
    slabs' gradients joined equal to the whole table's (rtol 1e-6)."""
    from loner_tpu_torch.ops import cell_hash as tch

    cfg = tch.CellHashConfig(n_levels=4, log2_cells=10, base_resolution=4, bwd=bwd)
    rng = np.random.default_rng(13)
    table = torch.as_tensor(rng.uniform(-1, 1, (4, cfg.table_size, 16)).astype(np.float32))
    pts = torch.as_tensor(rng.uniform(0, 1, (3, 3000)).astype(np.float32))
    u = torch.as_tensor(rng.uniform(0, 1, (4, 3000)).astype(np.float32))
    w_out = torch.as_tensor(rng.normal(size=(8, 3000)).astype(np.float32))
    outs, grads = [], []
    for whole in (True, False):
        t = table.clone().requires_grad_(True)
        slabs = t if whole else tfe.TableSlabs(t.chunk(4, dim=1))
        p = pts.clone().requires_grad_(True)
        out = tch.cell_hash_encode_t(slabs, p, cfg, u=u)
        torch.sum(torch.sin(out) * w_out).backward()
        outs.append(out.detach())
        grads.append((t.grad, p.grad))
    np.testing.assert_array_equal(outs[1].numpy(), outs[0].numpy())
    np.testing.assert_array_equal(grads[1][1].numpy(), grads[0][1].numpy())
    np.testing.assert_allclose(grads[1][0].numpy(), grads[0][0].numpy(), rtol=1e-6)
    assert bool(torch.any(grads[1][0][1:, 3 * cfg.table_size // 4:] != 0))  # the last slab, above level 0


def test_tp_table_not_divisible_raises():
    cfg, cube, state, window = _tp_setup()
    with pytest.raises(ValueError, match="not divisible"):
        ttp.shard_mapper_state(state, tsh.Mesh(np.asarray([["cpu"] * 3], object), ("data", "model")))


# ---------------------------------------------------------------------------
# submap-parallel EP (tests/test_submap_parallel.py)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _submaps():
    """tests/test_submap_parallel.py's set-up on both sides: 4 submaps of 2
    keyframes of an 8-pose circle, JAX (windows, poses) and the port's."""
    from loner_tpu.data import synthetic as jsyn
    from loner_tpu.data.scan import make_lidar_scan, sky_scan
    from loner_tpu.geometry import se3 as jse3
    from loner_tpu.geometry.world_cube import compute_world_cube
    from loner_tpu.mapping.keyframe import KeyFrame, stack_window
    from loner_tpu_torch.mapping import keyframe as tkf
    from test_submap_parallel import tiny_cfg as j_tiny_cfg

    scene = jsyn.Scene.default()
    poses, ts = jsyn.circular_trajectory(n_poses=8, radius=6.0, z=1.5)
    cube = compute_world_cube(poses, ray_range=(1.0, 40.0), rebase_to_first_pose=False)
    jcfg = j_tiny_cfg(float(cube.scale_factor))
    jw, tw, p6s = [], [], []
    for s in range(4):
        kfs = []
        for k in range(2):
            i = 2 * s + k
            dirs, dists, stamps, hit = jsyn.simulate_scan(scene, poses[i], ts[i], n_channels=4, n_azimuth=64,
                                                          max_range=40.0)
            scan = make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=256)
            sky = sky_scan(dirs[~hit][:16], 41.0, ts[i], pad_to=16)
            kfs.append(KeyFrame(scan=scan, timestamp=ts[i], pose_index=k, tracked_pose=poses[i], gt_pose=poses[i],
                                sky=sky))
        jw.append(stack_window(kfs, n_sky_pad=16))
        tw.append(tkf.stack_window([tkf.KeyFrame(scan=k.scan, timestamp=k.timestamp, pose_index=k.pose_index,
                                                 tracked_pose=k.tracked_pose, gt_pose=k.gt_pose, sky=k.sky)
                                    for k in kfs], n_sky_pad=16, device="cpu"))
        p6s.append(np.stack([np.asarray(jse3.matrix_to_pose(jnp.asarray(poses[2 * s + k], jnp.float32)))
                             for k in range(2)]))
    from loner_tpu_torch.geometry.world_cube import compute_world_cube as t_cube
    from loner_tpu_torch.mapping.optimizer import MapperConfig
    from loner_tpu_torch.models.hash_encoding import HashEncodingConfig
    from loner_tpu_torch.models.nerf import NeRFConfig
    from loner_tpu_torch.models.occupancy_grid import OccGridConfig

    tcfg = MapperConfig(
        nerf=NeRFConfig(num_colors=1, pos_encoding_sigma=HashEncodingConfig(n_levels=4, log2_hashmap_size=13),
                        pos_encoding_intensity=HashEncodingConfig(n_levels=2, log2_hashmap_size=10),
                        sigma_hidden_dim=16, intensity_hidden_dim=16, intensity_hidden_layers=1,
                        compute_dtype=jcfg.nerf.compute_dtype),
        occ=OccGridConfig(voxel_size=16), ray_range=(1.0, 40.0), world_scale=float(cube.scale_factor), window_size=2,
        max_keyframes=8, rays_per_kf=64, sky_rays_per_kf=8, n_samples_train=32, n_samples_test=32)
    tcube = t_cube(poses, ray_range=(1.0, 40.0), rebase_to_first_pose=False)
    return jcfg, cube, jw, tcfg, tcube, tw, p6s


def _ep_states(cfg, p6s):
    out = []
    for i, p6 in enumerate(p6s):
        st = topt.init_mapper_state(torch.Generator().manual_seed(10 + i), cfg, "cpu")
        poses = st.poses.clone()
        poses[:2] = torch.as_tensor(p6)
        out.append(st._replace(poses=poses))
    return out


EP_FLAGS = topt.TrainStepFlags(freeze_sigma=False, freeze_rgb=True, freeze_poses=True, do_occ_update=True)


class TestSubmapParallel:
    def test_matches_sequential_per_submap_training(self):
        """Three steps of 4 submaps on a mesh of 4 against training each
        alone, with JAX's drift bounds (tests/test_submap_parallel.py:113)."""
        _, _, _, cfg, cube, windows, p6s = _submaps()
        states = _ep_states(cfg, p6s)
        mask = torch.zeros(cfg.max_keyframes)
        draws = [[topt.draw_step(cfg, windows[i], torch.Generator().manual_seed(7 + 3 * i + it), "cpu")
                  for it in range(3)] for i in range(4)]
        seq_step = topt.make_train_step(cfg, cube, "cpu")
        seq = []
        for i in range(4):
            st = states[i]
            for it in range(3):
                st, _ = seq_step(st, windows[i], EP_FLAGS, mask, it, draws[i][it])
            seq.append(st)
        par_step = tsp.make_submap_parallel_step(cfg, cube, cpu_mesh(4))
        stacked, w = tsp.stack_states(states), tsp.stack_windows(windows)
        for it in range(3):
            stacked, aux = par_step(stacked, w, EP_FLAGS, mask, it, [draws[i][it] for i in range(4)])
        assert aux["loss"].shape == (4,)
        for i, par in enumerate(tsp.unstack_states(stacked, 4)):
            for ls, lp in zip(tp.leaves(seq[i].params), tp.leaves(par.params)):
                diff = np.abs(ls - lp)
                assert np.mean(diff > 5e-5) < 1e-3
                assert diff.max() < 3 * 0.01

    def test_optimize_submaps_parallel_runs_on_mesh(self):
        _, _, _, cfg, cube, windows, p6s = _submaps()
        finals = tsp.optimize_submaps_parallel(cfg, cube, windows, p6s, n_iterations=4, mesh=cpu_mesh(4))
        assert len(finals) == 4
        for st in finals:
            assert int(st.global_step) == 4
            assert all(np.isfinite(x).all() for x in tp.leaves(st.params))

    def test_mesh_divisibility_enforced(self):
        _, _, _, cfg, cube, windows, p6s = _submaps()
        with pytest.raises(ValueError):
            tsp.optimize_submaps_parallel(cfg, cube, windows[:3], p6s[:3], n_iterations=1, mesh=cpu_mesh(8))

    def test_matches_jax_submap_parallel_step(self):
        """One step of 4 submaps against JAX's vmapped, sharded step, each
        submap's draws rebuilt from its key: loss 1e-5 and the new sigma
        parameters within lr/5, their delta 1e-3 normwise."""
        from loner_tpu.mapping.optimizer import init_mapper_state as j_init
        from loner_tpu.parallel.sharding import make_mesh as j_make_mesh
        from loner_tpu.parallel.submaps_parallel import make_submap_parallel_step as j_step
        from loner_tpu.parallel.submaps_parallel import stack_states as j_stack, stack_windows as j_stack_w

        jcfg, jcube, jw, cfg, cube, windows, p6s = _submaps()
        jstates = [j_init(jax.random.PRNGKey(10 + i), jcfg) for i in range(4)]
        jstates = [s._replace(poses=s.poses.at[:2].set(jnp.asarray(p))) for s, p in zip(jstates, p6s)]
        keys = jnp.stack([jax.random.PRNGKey(20 + i) for i in range(4)])
        jflags = jopt.TrainStepFlags(*(jnp.asarray(f) for f in EP_FLAGS))
        jnew, jaux = j_step(jcfg, jcube, j_make_mesh(4))(j_stack(jstates), j_stack_w(jw), keys, jflags,
                                                        jnp.zeros(8), jnp.asarray(0))
        states = [state_from_jax(tp.np_tree(s), device="cpu") for s in jstates]
        draws = [tp.torch_draws(tp.jax_step_draws(keys[i], jcfg, jw[i])) for i in range(4)]
        new, aux = tsp.make_submap_parallel_step(cfg, cube, cpu_mesh(4))(
            tsp.stack_states(states), tsp.stack_windows(windows), EP_FLAGS, torch.zeros(8), 0, draws)
        np.testing.assert_allclose(tp.t2n(aux["loss"]), np.asarray(jaux["loss"]), rtol=1e-5)
        jnew = tp.np_tree(jnew)
        for i, (st, par) in enumerate(zip(states, tsp.unstack_states(new, 4))):
            dt = tp.leaves(topt.tree_map(torch.sub, par.params["sigma"], st.params["sigma"]))
            dj = tp.leaves(jax.tree.map(lambda a, b: a[i] - b, jnew.params["sigma"],
                                        tp.np_tree(jstates[i].params["sigma"])))
            assert tp.rel_err(dt, dj) <= 1e-3
            tp.assert_trees_close(par.params["sigma"], jax.tree.map(lambda a: a[i], jnew.params["sigma"]), rtol=0,
                                  atol=cfg.lr_sigma * 0.2, what=f"submap {i}")


# ---------------------------------------------------------------------------
# the pose graph's and the camera step's mesh forms, meshes, the dry run
# ---------------------------------------------------------------------------


def test_pose_graph_mesh_form_matches_single_and_jax():
    """tests/test_pose_graph.py:67-82 on both sides: 16 poses, a loop
    factor, padded to 16 factors over 8 devices; atol 1e-4, cost 1e-5."""
    from loner_tpu.geometry import se3 as jse3
    from loner_tpu.parallel.pose_graph import make_factors as j_make_factors, solve_pose_graph as j_solve
    from loner_tpu.parallel.sharding import make_mesh as j_make_mesh
    from loner_tpu_torch.parallel import pose_graph as tpg
    from test_pose_graph import make_noisy_chain

    gt, est = make_noisy_chain(16, drift=0.08)
    edges = tpg.odometry_factors_from_tracking(est)
    edges.append((0, 15, np.linalg.inv(gt[0]) @ gt[15], 10.0))
    p0 = np.stack([np.asarray(jse3.matrix_to_pose(jnp.asarray(e, jnp.float32))) for e in est])
    jdist, jcost = j_solve(jnp.asarray(p0), j_make_factors(edges, n_pad=16), n_iters=5, mesh=j_make_mesh(8))
    factors = tpg.make_factors(edges, n_pad=16)
    single, cost_s = tpg.solve_pose_graph(torch.as_tensor(p0), factors, n_iters=5)
    dist, cost_d = tpg.solve_pose_graph(torch.as_tensor(p0), factors, n_iters=5, mesh=cpu_mesh(8))
    np.testing.assert_allclose(tp.t2n(dist), tp.t2n(single), atol=1e-4)
    np.testing.assert_allclose(float(cost_d), float(cost_s), rtol=1e-5)
    np.testing.assert_allclose(tp.t2n(dist), np.asarray(jdist), atol=1e-4)
    np.testing.assert_allclose(float(cost_d), float(jcost), rtol=1e-5)
    with pytest.raises(ValueError, match="do not split"):
        tpg.solve_pose_graph(torch.as_tensor(p0), factors, n_iters=1, mesh=cpu_mesh(3))


def test_camera_step_with_mesh_equals_without():
    """The camera step under a 2-device mesh runs on the mesh's first
    device: the same step as without a mesh from the same draws, every leaf
    left where it was."""
    from loner_tpu_torch.mapping import camera_optimizer as tcam

    cfg, cube, state, _ = _port()
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(2, 6, 8, 1)).astype(np.float32)
    K = np.array([[4.0, 0, 4], [0, 4, 3], [0, 0, 1]])
    cam_poses = np.stack([np.eye(4)] * 2)
    win = tcam.stack_camera_window(imgs, np.ones(imgs.shape[:3], bool), cam_poses, K, device="cpu")
    draws = tcam.draw_camera_step(cfg, win, 32, torch.Generator().manual_seed(2), "cpu")
    outs = [tcam.make_camera_train_step(cfg, cube, n_rays=32, mesh=mesh, device="cpu")(state, win, draws)
            for mesh in (None, cpu_mesh(2))]
    assert float(outs[0][1]["loss"]) == float(outs[1][1]["loss"])
    for a, b in zip(topt.tree_leaves(outs[0][0]), topt.tree_leaves(outs[1][0])):
        assert torch.equal(a, b) and b.device == torch.device("cpu")


def test_meshes():
    """``make_mesh`` on the CPU repeats it; ``Mesh`` keeps repeats and its
    axes; ``make_dp_tp_mesh`` shapes (data, model)."""
    m = tsh.make_mesh(4, device="cpu")
    assert m.shape == {"data": 4} and m.size == 4 and m.along("data") == [torch.device("cpu")] * 4
    m2 = ttp.make_dp_tp_mesh(8, tp=2, device="cpu")
    assert m2.shape == {"data": 4, "model": 2} and m2.first_device == torch.device("cpu")
    with pytest.raises(ValueError):
        ttp.make_dp_tp_mesh(6, tp=4, device="cpu")
    with pytest.raises(ValueError):
        tsh.Mesh(["cpu"] * 2, ("data", "model"))
    cfg, cube, state, window = _port()
    blocks = tsh.shard_window(window, cpu_mesh(4))
    assert [b.window_size for b in blocks] == [2] * 4
    assert torch.equal(torch.cat([b.dists for b in blocks]), window.dists)
    with pytest.raises(ValueError):
        tsh.shard_window(window, cpu_mesh(3))


def test_card_indices_are_checked(monkeypatch):
    """``cuda:<i>`` needs more than i cards (checked at resolution, not at
    first use), so ``make_mesh(n)`` raises when fewer than n exist."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tdevice.resolve_device("cuda:0") == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="1 device"):
        tdevice.resolve_device("cuda:1")
    with pytest.raises(RuntimeError, match="only 1 CUDA device"):
        tsh.make_mesh(2)
    assert tdevice.indexed_device(torch.device("cpu"), 3) == torch.device("cpu")


def test_dryrun_multichip_on_eight_cpus(capsys):
    from loner_tpu_torch.multichip import dryrun_multichip, main

    losses = dryrun_multichip(8, devices=["cpu"] * 8)
    out = capsys.readouterr().out
    assert "dryrun_multichip(8): DP OK, loss=" in out and "dryrun_multichip(8): DPxTP OK, loss=" in out
    assert np.isfinite(losses["dp"]) and np.isfinite(losses["dp_tp"])
    assert main(["2", "--device", "cpu"]).keys() == {"dp"}


@pytest.mark.gpu
def test_dp_step_on_card_matches_single():
    """On the card: the flagship-shaped tiny step over ["cuda:0"] * n
    against the single step on the same draws, and each kernel launched n
    times a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from loner_tpu_torch.ops import cp_kernel, pdf_kernel

    _, tcfg = tp.mapper_configs(1.0, "float32", "off", **SIZES)
    cfg, cube, state, window = flagship(device="cuda", cfg=tcfg, **{**tp.SCAN, "n_keyframes": W})
    draws = topt.draw_step(cfg, window, torch.Generator(device="cuda").manual_seed(1), "cuda")
    flags, mask = _flags("joint"), torch.ones(cfg.max_keyframes, device="cuda")
    s1, a1 = topt.make_train_step(cfg, cube, "cuda")(state, window, flags, mask, 0, draws)
    for n in (2, 4, 8):
        step = tsh.make_sharded_train_step(cfg, cube, tsh.Mesh(["cuda:0"] * n, ("data",)))
        wrappers = (cp_kernel.cp_fwd, cp_kernel.cp_bwd, pdf_kernel.pdf_sample)
        for w in wrappers:
            w.launches = 0
        sn, an = step(state, window, flags, mask, 0, draws)
        torch.cuda.synchronize()
        assert [w.launches for w in wrappers] == [n, n, n]
        np.testing.assert_allclose(float(an["loss"]), float(a1["loss"]), rtol=1e-6)
        assert tp.rel_err(an["grads"]["sigma"], a1["grads"]["sigma"]) <= 1e-4
