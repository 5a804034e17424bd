"""The camera phase of the PyTorch port against the JAX package: the SH
encoding, the intensity branch of the field, the colour render, the camera
loss, camera rays and frustum cubes, pixel sampling, image upsampling, one
camera train step from one converted state with the JAX step's own draws,
and the calibration, image-sequence and dynamic-mask data modules
(tests/test_torch_camera_slam.py drives the camera phase in LonerSLAM).
Card tests (marked ``gpu``) hold the camera step on the card against the
CPU."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.data import calibration as jcal
from loner_tpu.data import dynamic_mask as jdm
from loner_tpu.data import synthetic as jsyn
from loner_tpu.geometry import rays as jrays
from loner_tpu.geometry import world_cube as jwc
from loner_tpu.mapping import camera_optimizer as jcam
from loner_tpu.models import losses as jlosses
from loner_tpu.models import nerf as jnerf
from loner_tpu.models import rendering as jrender
from loner_tpu.models import sampling as jsampling
from loner_tpu.models import sh_encoding as jsh
from loner_tpu_torch.convert import state_from_jax
from loner_tpu_torch.data import calibration as tcal
from loner_tpu_torch.data import dataset as tdataset
from loner_tpu_torch.data import dynamic_mask as tdm
from loner_tpu_torch.geometry import rays as trays
from loner_tpu_torch.geometry import world_cube as twc
from loner_tpu_torch.geometry.rays import RayBundle
from loner_tpu_torch.mapping import camera_optimizer as tcam
from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.models import losses as tlosses
from loner_tpu_torch.models import nerf as tnerf
from loner_tpu_torch.models import rendering as trender
from loner_tpu_torch.models import sh_encoding as tsh

import torch_parity as tp
from torch_parity import two_threads  # noqa: F401 (autouse: two torch threads)

KEY = jax.random.PRNGKey(21)
B, H, W = 2, 12, 16
K_CAM = np.array([[W / 2, 0, W / 2], [0, W / 2, H / 2], [0, 0, 1.0]])
# camera looks forward: z_cam = +x_lidar (write_synthetic_images' convention)
T_LC = np.eye(4)
T_LC[:3, :3] = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
N_RAYS = 64
# Normwise relative bounds of tests/test_torch_train_step.py: f32 sums in
# other orders; bf16 MLP operands one bf16 ulp apart on a rounding boundary
TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def T(a):
    return torch.as_tensor(np.array(a))


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _setup(dtype, hash_term="off"):
    """The small flagship of both packages with three colours (and the field
    of ``hash_term``, its tables scaled from their init to O(0.1) as in
    tests/test_torch_train_step.py), a fresh JAX state of that field at the
    flagship's poses, and a window of B random images at the two keyframes'
    camera poses."""
    from loner_tpu.mapping import optimizer as jopt

    jcfg, jcube, jstate, _ = tp.jax_flagship_tiny(dtype, hash_term=hash_term)
    jcfg = jcfg._replace(nerf=jcfg.nerf._replace(num_colors=3))
    _, tcfg = tp.mapper_configs(float(jcube.scale_factor), dtype, hash_term)
    tcfg = tcfg._replace(nerf=tcfg.nerf._replace(num_colors=3))
    jstate = jopt.init_mapper_state(jax.random.PRNGKey(3), jcfg)._replace(poses=jstate.poses)
    if hash_term != "off":
        jstate = jstate._replace(params={b: {**p, "table": p["table"] * 1e3} for b, p in jstate.params.items()})
    poses, _ = jsyn.circular_trajectory(n_poses=tp.SCAN["n_keyframes"], radius=6.0, z=1.5)
    tcube = twc.compute_world_cube(poses, ray_range=tp.RAY_RANGE, rebase_to_first_pose=False)
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    masks = rng.uniform(size=(B, H, W)) > 0.2
    cam_poses = np.stack(poses) @ T_LC
    jwin = jcam.stack_camera_window(images, masks, cam_poses, K_CAM)
    twin = tcam.stack_camera_window(images, masks, cam_poses, K_CAM, device="cpu")
    return jcfg, jcube, jstate, jwin, tcfg, tcube, twin


def _jax_camera_draws(key, cfg, n_rays):
    """The numbers one JAX camera step draws from ``key``, rebuilt by
    repeating its key splits (``camera_optimizer.py:164,105-108``, the OGM
    sampler's ``sampling.py:151`` as ``torch_parity.jax_step_draws``), the
    encoders' keys as their two words (the intensity one folded,
    ``nerf.py:237``), and under "cell" the corner uniforms the intensity
    encoder's backward draws from the folded key in each point chunk."""
    k_pix, k_samp, k_enc = jax.random.split(key, 3)
    kb, ky, kx = jax.random.split(k_pix, 3)
    half = cfg.n_samples_train // 2
    k_unif, k_pdf = jax.random.split(k_samp)

    def words(k):
        return np.asarray(k, np.uint32).astype(np.int64)

    return tcam.CameraDraws(
        bi=T(np.asarray(jax.random.randint(kb, (n_rays,), 0, B)).astype(np.int64)),
        yi=T(np.asarray(jax.random.randint(ky, (n_rays,), 0, H)).astype(np.int64)),
        xi=T(np.asarray(jax.random.randint(kx, (n_rays,), 0, W)).astype(np.int64)),
        u_strat=T(jax.random.uniform(k_unif, (n_rays, half), dtype=jnp.float32)),
        u_pdf=T(jax.random.uniform(k_pdf, (n_rays, half), dtype=jnp.float32)),
        enc_key=T(words(k_enc)),
        enc_key_intensity=T(words(jax.random.fold_in(k_enc, 1))),
        u_enc_intensity=T(jax.random.uniform(jax.random.fold_in(k_enc, 1), (
            cfg.nerf.pos_encoding_intensity.n_levels, n_rays * cfg.n_samples_train // cfg.nerf.point_chunks)))
        if cfg.nerf.encoding_impl == "cell" else None,
    )


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode_matches_jax(degree):
    d = _unit(np.random.default_rng(degree), 257)
    out = tsh.sh_encode_t(T(d), degree)
    assert out.shape == (degree**2, 257)
    np.testing.assert_allclose(out.numpy(), np.asarray(jsh.sh_encode_t(jnp.asarray(d), degree)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tsh.sh_encode(T(d), degree).numpy(), np.asarray(jsh.sh_encode(jnp.asarray(d), degree)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_query_nerf_matches_jax(dtype):
    """Both packages' transposed query from one parameter tree: the three
    colour rows and the sigma row, and the colour rows' gradient with
    respect to the intensity parameters (none reaches sigma's)."""
    jcfg, _, jstate, _, tcfg, _, _ = _setup(dtype)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.9, 0.9, size=(3, 300)).astype(np.float32)
    dirs = _unit(rng, 300).T.copy()
    jout = np.asarray(jax.jit(lambda p: jnerf.query_nerf_t(p, jnp.asarray(pts), jnp.asarray(dirs), jcfg.nerf))(
        jstate.params))
    tparams = state_from_jax(tp.np_tree(jstate), device="cpu").params
    tout = tnerf.query_nerf_t(tparams, T(pts), T(dirs), tcfg.nerf)
    assert tout.shape == jout.shape == (4, 300)
    assert tp.rel_err([tout[:3].detach()], [jout[:3]]) <= TOL[dtype]
    np.testing.assert_allclose(tout[3].detach().numpy(), jout[3], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tnerf.query_nerf(tparams, T(pts.T), T(dirs.T), tcfg.nerf).detach().numpy(), jout.T,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tnerf.query_nerf_t(tparams, T(pts), None, tcfg.nerf, sigma_only=True)[0].numpy(),
                               jout[3], rtol=1e-4, atol=1e-5)

    w = rng.normal(size=(3, 300)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jnerf.query_nerf_t(p, jnp.asarray(pts), jnp.asarray(dirs),
                                                                jcfg.nerf)[:3] * w)))(jstate.params)
    sigma = [x.requires_grad_(True) for x in topt.tree_leaves(tparams["sigma"])]
    intensity = [x.requires_grad_(True) for x in topt.tree_leaves(tparams["intensity"])]
    loss = torch.sum(tnerf.query_nerf_t(tparams, T(pts), T(dirs), tcfg.nerf)[:3] * T(w))
    g = torch.autograd.grad(loss, sigma + intensity, allow_unused=True)
    assert all(x is None for x in g[:len(sigma)])
    assert all(float(np.abs(a).max()) == 0 for a in tp.leaves(tp.np_tree(jg["sigma"])))
    assert tp.rel_err(list(g[len(sigma):]), tp.leaves(tp.np_tree(jg["intensity"]))) <= TOL[dtype]


def _bundle(rng, n, scale=1.0):
    o = rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)
    d = _unit(rng, n)
    near = np.full(n, 0.05, np.float32)
    far = np.full(n, 1.2, np.float32)
    return dict(origins=o, directions=d, viewdirs=d, near=near, far=far, valid=rng.uniform(size=n) > 0.1,
                depth=np.zeros(n, np.float32))


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_colour_render_and_camera_loss_match_jax(dtype):
    """``render_rays(sigma_only=False)`` in two point chunks and
    ``compute_camera_loss`` from the same rays, samples and parameters:
    rgb, depth and weights, and the loss."""
    jcfg, _, jstate, _, tcfg, _, _ = _setup(dtype)
    rng = np.random.default_rng(2)
    b = _bundle(rng, 40)
    z = np.sort(rng.uniform(0.05, 1.2, size=(40, 16)).astype(np.float32), axis=1)
    jb = jrays.RayBundle(**{k: jnp.asarray(v) for k, v in b.items()})
    jout = jrender.render_rays(jstate.params, jb, jnp.asarray(z), jcfg.nerf._replace(point_chunks=2),
                               sigma_only=False, detach_sigma=True)
    tparams = state_from_jax(tp.np_tree(jstate), device="cpu").params
    tb = RayBundle(**{k: T(v) for k, v in b.items()})
    tout = trender.render_rays(tparams, tb, T(z), tcfg.nerf, point_chunks=2, sigma_only=False)
    assert tout.rgb.shape == (40, 3) and tout.raw.shape == (4, 40, 16)
    assert tp.rel_err([tout.rgb.detach()], [np.asarray(jout.rgb)]) <= TOL[dtype]
    np.testing.assert_allclose(tout.weights.detach().numpy(), np.asarray(jout.weights), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tout.depth.detach().numpy(), np.asarray(jout.depth), rtol=1e-5, atol=1e-5)

    target = rng.uniform(size=(40, 3)).astype(np.float32)
    jl, jaux = jlosses.compute_camera_loss(jout, jnp.asarray(target), jb.valid, jcfg.loss._replace(cam_lambda=0.5))
    tl, taux = tlosses.compute_camera_loss(tout, T(target), tb.valid, tcfg.loss._replace(cam_lambda=0.5))
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL[dtype])
    assert float(taux["cam_l1"]) == float(tl)
    # the loss alone, on fixed inputs: to 1e-6
    rgb = rng.uniform(size=(40, 3)).astype(np.float32)
    jl2, _ = jlosses.compute_camera_loss(jout._replace(rgb=jnp.asarray(rgb)), jnp.asarray(target), jb.valid, jcfg.loss)
    tl2, _ = tlosses.compute_camera_loss(tout._replace(rgb=T(rgb)), T(target), tb.valid, tcfg.loss)
    np.testing.assert_allclose(float(tl2), float(jl2), rtol=0, atol=1e-6)


def test_sample_camera_rays_matches_jax():
    """The JAX step's pixel draws through both packages' samplers: the
    targets exactly, the rays within 1e-6, the same valid set (masked
    pixels and short rays invalid)."""
    jcfg, jcube, _, jwin, tcfg, tcube, twin = _setup("float32")
    kp = jax.random.split(KEY, 3)[0]
    jb, jt = jcam._sample_camera_rays(jwin, jcube, jcfg, N_RAYS, kp)
    d = _jax_camera_draws(KEY, jcfg, N_RAYS)
    tb, tt = tcam._sample_camera_rays(twin, tcube, tcfg, d.bi, d.yi, d.xi)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for name in ("origins", "directions", "viewdirs", "near", "far", "depth"):
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), rtol=0, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
    assert 0 < int(tb.valid.sum()) < N_RAYS


def test_camera_rays_and_directions_match_jax():
    """``camera_ray_directions`` (integer pixel coordinates) and
    ``build_camera_rays`` to 1e-6."""
    jd = np.asarray(jrays.camera_ray_directions(H, W, jnp.asarray(K_CAM, jnp.float32)))
    td = trays.camera_ray_directions(H, W, T(K_CAM.astype(np.float32)))
    assert td.shape == (H * W, 3)
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=1e-6)
    poses, _ = jsyn.circular_trajectory(n_poses=4, radius=6.0, z=1.5)
    jcube = jwc.compute_world_cube(poses, ray_range=tp.RAY_RANGE)
    tcube = twc.compute_world_cube(poses, ray_range=tp.RAY_RANGE)
    pose = (poses[2] @ T_LC).astype(np.float32)
    jb = jrays.build_camera_rays(jnp.asarray(jd), jnp.asarray(pose), jcube, tp.RAY_RANGE)
    tb = trays.build_camera_rays(td, T(pose), tcube, tp.RAY_RANGE)
    for name in jb._fields:
        a, e = getattr(tb, name).numpy(), np.asarray(getattr(jb, name))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, e, err_msg=name)
        else:
            np.testing.assert_allclose(a, e, rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tb.viewdirs.numpy(), tb.directions.numpy())


@pytest.mark.parametrize("rebase", [True, False])
def test_camera_world_cube_matches_jax(rebase):
    """The world cube from camera frustums (``camera_to_lidar``,
    ``intrinsic``, ``image_size``): the same scale and shift as the JAX
    package's, and not the lidar cube's."""
    poses, _ = jsyn.circular_trajectory(n_poses=8, radius=5.0, z=1.5)
    kw = dict(ray_range=(1.0, 40.0), camera_to_lidar=np.linalg.inv(T_LC), intrinsic=K_CAM, image_size=(H, W),
              rebase_to_first_pose=rebase)
    j = jwc.compute_world_cube(poses, **kw).as_dict()
    t = twc.compute_world_cube(poses, **kw).as_dict()
    np.testing.assert_allclose(t["scale_factor"], j["scale_factor"], rtol=1e-6)
    np.testing.assert_allclose(t["shift"], j["shift"], rtol=0, atol=1e-5)
    lidar = twc.compute_world_cube(poses, ray_range=(1.0, 40.0), rebase_to_first_pose=rebase).as_dict()
    assert lidar["scale_factor"] != t["scale_factor"]
    np.testing.assert_allclose(jwc._camera_frustum_corners(K_CAM, H, W, 1.0, 40.0),
                               twc._camera_frustum_corners(K_CAM, H, W, 1.0, 40.0), rtol=0, atol=0)


@pytest.mark.parametrize("factor", [1, 2, 3])
def test_upsample_images_matches_jax(factor):
    rng = np.random.default_rng(factor)
    images = rng.uniform(size=(2, 5, 7, 3)).astype(np.float32)
    masks = rng.uniform(size=(2, 5, 7)) > 0.5
    j = jcam.upsample_images(images, masks, K_CAM, factor)
    t = tcam.upsample_images(images, masks, K_CAM, factor)
    for a, e in zip(t, j):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(e, np.float64), rtol=0, atol=1e-6)
    tw = tcam.stack_camera_window(images, masks, np.stack([np.eye(4)] * 2), K_CAM, upsample=factor, device="cpu")
    jw = jcam.stack_camera_window(images, masks, np.stack([np.eye(4)] * 2), K_CAM, upsample=factor)
    for a, e in zip(tw, jw):
        np.testing.assert_allclose(tp.t2n(a), np.asarray(e), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the camera train step
# ---------------------------------------------------------------------------


def _jax_camera_loss_and_grads(cfg, cube, state, window, key, n_rays):
    """The loss and intensity gradients of the JAX camera step's forward
    (which its step does not return), by the same calls with the same keys."""
    k_pix, k_samp, k_enc = jax.random.split(key, 3)

    def fwd(params):
        bundle, target = jcam._sample_camera_rays(window, cube, cfg, n_rays, k_pix)
        z = jsampling.occ_grid_sampler_z_vals(k_samp, bundle, state.occ_grid, cfg.n_samples_train, cfg.perturb)
        render = jrender.render_rays(params, bundle, z, cfg.nerf, sigma_only=False, detach_sigma=True, key=k_enc)
        return jlosses.compute_camera_loss(render, target, bundle.valid, cfg.loss)[0]

    loss, g = jax.jit(jax.value_and_grad(fwd))(state.params)
    return float(loss), tp.np_tree(g)


def _adam(chain):
    return next(s for s in jax.tree.leaves(chain, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))


def _check_camera_step_against_jax(dtype, hash_term="off"):
    """One camera step from one converted state with the JAX step's draws:
    the loss, the intensity gradients, the new intensity parameters and
    Adam moments and count, ``global_step`` and ``skipped_steps``; sigma,
    the poses, the occupancy grid and the other Adam groups untouched."""
    jcfg, jcube, jstate, jwin, tcfg, tcube, twin = _setup(dtype, hash_term)
    jstate = jstate._replace(global_step=jnp.asarray(7, jnp.int32))
    jnew, jaux = jcam.make_camera_train_step(jcfg, jcube, n_rays=N_RAYS)(jstate, jwin, KEY)
    jnew = tp.np_tree(jnew)
    jloss, jg = _jax_camera_loss_and_grads(jcfg, jcube, jstate, jwin, KEY, N_RAYS)

    state = state_from_jax(tp.np_tree(jstate), device="cpu")
    step = tcam.make_camera_train_step(tcfg, tcube, n_rays=N_RAYS, device="cpu")
    new, aux = step(state, twin, _jax_camera_draws(KEY, jcfg, N_RAYS))

    tol = TOL[dtype]
    assert bool(aux["finite"])
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=tol)
    np.testing.assert_allclose(float(aux["loss"]), jloss, rtol=tol)
    np.testing.assert_allclose(float(aux["cam_l1"]), float(jaux["cam_l1"]), rtol=tol)
    assert tp.rel_err(aux["grads"]["intensity"], jg["intensity"]) <= tol
    assert all(float(np.abs(a).max()) == 0 for a in tp.leaves(jg["sigma"]))
    assert int(new.global_step) == int(jnew.global_step) == 8
    assert int(new.skipped_steps) == int(jnew.skipped_steps) == 0
    ja = _adam(jnew.opt_intensity)
    assert int(new.opt_intensity.count) == int(ja.count) == 1
    dt = tp.leaves(topt.tree_map(torch.sub, new.params["intensity"], state.params["intensity"]))
    dj = tp.leaves(jax.tree.map(np.subtract, jnew.params["intensity"], tp.np_tree(jstate.params["intensity"])))
    assert tp.rel_err(dt, dj) <= max(tol, 1e-3)
    tp.assert_trees_close(new.params["intensity"], jnew.params["intensity"], rtol=0, atol=tcfg.lr_rgb * 0.2,
                          what="intensity")
    assert tp.rel_err(new.opt_intensity.mu, ja.mu) <= tol
    assert tp.rel_err(new.opt_intensity.nu, ja.nu) <= 2 * tol
    tp.assert_trees_close(new.params["sigma"], state.params["sigma"], 0, 0, "sigma")
    for name in ("opt_sigma", "opt_poses", "opt_occ"):
        assert int(getattr(new, name).count) == 0, name
    assert torch.equal(new.poses, state.poses) and torch.equal(new.occ_grid, state.occ_grid)
    tp.assert_trees_close(jnew.params["sigma"], tp.np_tree(jstate.params["sigma"]), 0, 0, "JAX sigma")
    np.testing.assert_array_equal(jnew.poses, np.asarray(jstate.poses))
    return aux, jg


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_camera_step_matches_jax(dtype):
    """One camera step of the default (triad) field against the JAX step's."""
    _check_camera_step_against_jax(dtype)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_decoupled_fused_camera_step_matches_jax(dtype):
    """One camera step of LONER's decoupled field (``torch_parity.HASH
    ["fused_rgb"]``: FusedHash in both branches with the exact table
    gradient, SH of degree 4, a 4-layer colour MLP; the configuration of
    the benchmark's camera cell, which tests/test_torch_camera_rgb.py holds
    against the benchmark's plain reference) against the JAX step's, by the
    same checks and bounds as the default field's; the intensity table's
    gradient is among the gradients compared, and is not all zero."""
    aux, jg = _check_camera_step_against_jax(dtype, "fused_rgb")
    _, _, _, _, tcfg, _, _ = _setup(dtype, "fused_rgb")
    n = tcfg.nerf
    assert (n.encoding_impl, n.encoding_bwd, n.sh_degree, n.intensity_hidden_layers) == ("fused", "exact", 4, 4)
    assert len(aux["grads"]["intensity"]["mlp"]["w"]) == len(jg["intensity"]["mlp"]["w"]) == 5
    assert float(np.abs(tp.t2n(aux["grads"]["intensity"]["table"])).max()) > 0


@pytest.mark.parametrize("hash_term", ["cell", "packed", "exact"])
def test_camera_step_with_an_alternate_encoder_matches_jax(hash_term):
    """The camera step with the alternate encoders in both branches: the
    loss, the L1 and the intensity gradients (the table's included; under
    "cell" its corner-sampled gradient from the JAX step's own uniforms)."""
    jcfg, jcube, jstate, jwin, tcfg, tcube, twin = _setup("float32", hash_term)
    assert jcfg.nerf.encoding_impl == tcfg.nerf.encoding_impl == hash_term
    jnew, jaux = jcam.make_camera_train_step(jcfg, jcube, n_rays=N_RAYS)(jstate, jwin, KEY)
    jloss, jg = _jax_camera_loss_and_grads(jcfg, jcube, jstate, jwin, KEY, N_RAYS)
    state = state_from_jax(tp.np_tree(jstate), device="cpu")
    new, aux = tcam.make_camera_train_step(tcfg, tcube, n_rays=N_RAYS, device="cpu")(
        state, twin, _jax_camera_draws(KEY, jcfg, N_RAYS))
    assert bool(aux["finite"]) and int(jnew.skipped_steps) == 0
    np.testing.assert_allclose(float(aux["loss"]), jloss, rtol=TOL["float32"])
    np.testing.assert_allclose(float(aux["cam_l1"]), float(jaux["cam_l1"]), rtol=TOL["float32"])
    assert tp.rel_err(aux["grads"]["intensity"], jg["intensity"]) <= TOL["float32"]
    assert float(np.abs(tp.t2n(aux["grads"]["intensity"]["table"])).max()) > 0
    assert int(new.opt_intensity.count) == 1 and int(new.global_step) == int(jnew.global_step)


def test_camera_step_skips_a_non_finite_step_and_draws_its_own():
    """A NaN image leaves the intensity parameters and moments as they
    were and counts the step in both counters; the step draws from its
    generator when given no draws, and ``optimize_intensity`` lowers the
    L1 on a learnable window."""
    _, _, jstate, _, tcfg, tcube, twin = _setup("float32")
    state = state_from_jax(tp.np_tree(jstate), device="cpu")
    bad = twin._replace(intensities=torch.full_like(twin.intensities, float("nan")))
    step = tcam.make_camera_train_step(tcfg, tcube, n_rays=N_RAYS, device="cpu")
    new, aux = step(state, bad)
    assert not bool(aux["finite"])
    assert int(new.global_step) == 1 and int(new.skipped_steps) == 1
    tp.assert_trees_close(new.params["intensity"], state.params["intensity"], 0, 0, "intensity")
    assert int(new.opt_intensity.count) == 0
    # a flat grey target: the colour head learns it in a few steps
    grey = twin._replace(intensities=torch.full_like(twin.intensities, 0.3), masks=torch.ones_like(twin.masks))
    l1 = []
    state = tcam.optimize_intensity(tcfg, tcube, state, grey, n_iterations=20, n_rays=N_RAYS, log_every=10,
                                    log_fn=lambda m: l1.append(float(m.rsplit(" ", 1)[1])), device="cpu")
    assert int(state.global_step) == 20 and len(l1) == 2 and l1[1] < l1[0]


def test_render_fn_with_colours_matches_jax():
    """The eval render with the intensity branch (``sigma_only=False``):
    colours and depth against the JAX package's render, no gradient."""
    jcfg, _, jstate, _, tcfg, _, _ = _setup("float32")
    rng = np.random.default_rng(4)
    b = _bundle(rng, 32)
    jb = jrays.RayBundle(**{k: jnp.asarray(v) for k, v in b.items()})
    cfg_j = jcfg._replace(n_samples_test=32)
    cfg_t = tcfg._replace(n_samples_test=32)
    jout = topt_j_render(cfg_j)(jstate.params, jstate.occ_grid, jb, KEY)
    u = torch.from_numpy(tp.jax_render_u_pdf(KEY, 32, 32))
    state = state_from_jax(tp.np_tree(jstate), device="cpu")
    out = topt.make_render_fn(cfg_t, sigma_only=False, device="cpu")(state.params, state.occ_grid,
                                                                      RayBundle(**{k: T(v) for k, v in b.items()}),
                                                                      u_pdf=u)
    assert out.rgb.shape == (32, 3) and not out.rgb.requires_grad
    np.testing.assert_allclose(out.rgb.numpy(), np.asarray(jout.rgb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(jout.depth), rtol=1e-5, atol=1e-5)


def topt_j_render(cfg):
    from loner_tpu.mapping import optimizer as jopt

    return jopt.make_render_fn(cfg, test=True, sigma_only=False)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_camera_step_on_card_matches_cpu(dtype):
    """One camera step on the card and on the CPU from one state with the
    same draws: the intensity gradients within 1e-4 (f32 MLP) or 2^-8 (bf16
    MLP) normwise, the bounds of PERF.md section 2; the loss within 1e-5
    relative with the f32 MLP, and within 5e-4 with the bf16 MLP, whose
    operands can round one bf16 ulp apart where the rays and samples the
    two devices build differ by ulps (ROADMAP queue C: 8.2e-6 to 1.27e-4
    over five full-width runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, jstate, _, tcfg, tcube, twin = _setup(dtype)
    draws = _jax_camera_draws(KEY, _setup(dtype)[0], N_RAYS)
    out = {}
    for dev in ("cpu", "cuda"):
        state = state_from_jax(tp.np_tree(jstate), device=dev)
        win = tcam.CameraWindow(*(t.to(dev) for t in twin))
        step = tcam.make_camera_train_step(tcfg, tcube, n_rays=N_RAYS, device=dev)
        out[dev] = step(state, win, topt.tree_map(lambda t: t.to(dev), draws))
    (_, a_cpu), (new, a_gpu) = out["cpu"], out["cuda"]
    assert new.global_step.device.type == "cuda"
    tol = 1e-4 if dtype == "float32" else 2.0**-8
    loss_rel = abs(float(a_gpu["loss"]) - float(a_cpu["loss"])) / abs(float(a_cpu["loss"]))
    grad_rel = tp.rel_err(a_gpu["grads"]["intensity"], a_cpu["grads"]["intensity"])
    print(f"camera step card against CPU, {dtype} MLP: loss {loss_rel:.3e} relative, gradients {grad_rel:.3e}")
    assert loss_rel <= (1e-5 if dtype == "float32" else 5e-4)
    assert grad_rel <= tol


# ---------------------------------------------------------------------------
# data: calibration, image sequences, dynamic masks
# ---------------------------------------------------------------------------


def _calibration():
    return dict(K=np.array([[400.0, 0, 320], [0, 410, 180], [0, 0, 1]]),
                distortion=np.array([-0.2, 0.05, 0.001, -0.002, 0.01]), width=640, height=360,
                lidar_to_camera=T_LC)


def test_calibration_round_trips_and_undistortion_match_jax(tmp_path):
    """``CameraCalibration.scaled``, ``as_dict`` and ``from_dict`` and the
    yaml file in both directions; ``undistort_points`` and
    ``undistorted_pixel_rays`` against the JAX package's (1e-9 and 1e-6);
    the OpenCV-yaml loader and the Fusion Portable directory layout."""
    tc = tcal.CameraCalibration(**_calibration())
    jc = jcal.CameraCalibration(**_calibration())
    for s in (1.0, 0.5):
        assert tc.scaled(s).as_dict() == jc.scaled(s).as_dict()
    assert tcal.CameraCalibration.from_dict(jc.as_dict()).as_dict() == jc.as_dict()
    import yaml

    (tmp_path / "c.yaml").write_text(yaml.safe_dump(jc.as_dict()))
    assert tcal.load_calibration_yaml(str(tmp_path / "c.yaml")).as_dict() == jc.as_dict()

    rng = np.random.default_rng(5)
    pix = rng.uniform([0, 0], [640, 360], size=(500, 2))
    np.testing.assert_allclose(tcal.undistort_points(pix, tc.K, tc.distortion),
                               jcal.undistort_points(pix, jc.K, jc.distortion), rtol=0, atol=1e-9)
    small = tc.scaled(0.05)
    np.testing.assert_allclose(tcal.undistorted_pixel_rays(small), jcal.undistorted_pixel_rays(jc.scaled(0.05)),
                               rtol=0, atol=1e-6)

    # Fusion Portable's calib/ouster00.yaml and calib/frame_cam00.yaml
    calib = tmp_path / "fp" / "calib"
    calib.mkdir(parents=True)

    def mat(rows, cols, data):
        return f"!!opencv-matrix\n  rows: {rows}\n  cols: {cols}\n  dt: d\n  data: {list(map(float, data))}\n"

    (calib / "ouster00.yaml").write_text(
        "%YAML:1.0\n---\nquaternion_sensor_frame_cam00: " + mat(1, 4, [0.5, -0.5, 0.5, -0.5])
        + "translation_sensor_frame_cam00: " + mat(1, 3, [0.1, -0.05, 0.2]))
    (calib / "frame_cam00.yaml").write_text(
        "%YAML:1.0\n---\nimage_width: 1024\nimage_height: 768\ndistortion_model: radtan\n"
        + "camera_matrix: " + mat(3, 3, [600, 0, 512, 0, 601, 384, 0, 0, 1])
        + "distortion_coefficients: " + mat(1, 5, [-0.1, 0.02, 0.0, 0.001, 0.0])
        + "projection_matrix: " + mat(3, 4, [590, 0, 510, 0, 0, 592, 380, 0, 0, 0, 1, 0]))
    for s in (1.0, 0.5):
        t = tcal.load_fusion_portable_calibration(str(tmp_path / "fp"), s).as_dict()
        j = jcal.load_fusion_portable_calibration(str(tmp_path / "fp"), s).as_dict()
        np.testing.assert_allclose(t.pop("lidar_to_camera"), j.pop("lidar_to_camera"), rtol=0, atol=1e-7)
        assert t == j


def test_image_sequences_read_across_packages(tmp_path):
    """Images written by either package's ``write_synthetic_images`` load
    in the other's ``ImageSequence`` (the same images, masks, timestamps
    and intrinsics), and a distorted calibration is rectified alike."""
    # imported here: it imports orbax, which the card tests must not need
    from loner_tpu.data import dataset as jdataset

    kw = dict(n_poses=4, height=12, width=16)
    jroot = jdataset.write_synthetic_images(str(tmp_path / "j"), **kw)
    troot = tdataset.write_synthetic_images(str(tmp_path / "t"), **kw)
    for root in (jroot, troot):
        js, ts = jdataset.ImageSequence(root), tdataset.ImageSequence(root)
        assert len(js) == len(ts) == 4
        np.testing.assert_array_equal(ts.K, js.K)
        for (ti, tm, tt), (ji, jm, jt) in zip(ts, js):
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tm, jm)
            assert tt == jt
    for (ti, tm, tt), (ji, jm, jt) in zip(tdataset.ImageSequence(troot), jdataset.ImageSequence(jroot)):
        np.testing.assert_allclose(ti, ji, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tm, jm)
        assert tt == jt
    # a distorted calibration: both rectify by the same remap
    import yaml

    c = yaml.safe_load(open(f"{troot}/calibration.yaml"))
    c["distortion"] = [-0.1, 0.01, 0.0, 0.0, 0.0]
    (tmp_path / "t" / "calibration.yaml").write_text(yaml.safe_dump(c))
    for (ti, tm, _), (ji, jm, _) in zip(tdataset.ImageSequence(troot), jdataset.ImageSequence(troot)):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tm, jm)


def test_dynamic_masks_match_jax(tmp_path):
    """The box mask, the motion-residual masks, their combination and the
    write-back into a sequence's image files, against the JAX package's;
    the LK masks too when OpenCV is present, and both raise without it."""
    from loner_tpu.data import dataset as jdataset

    rng = np.random.default_rng(6)
    T_cb = np.eye(4)
    T_cb[:3, 3] = [0.0, 0.0, 6.0]
    for size in ((2.0, 2.0, 2.0), (30.0, 1.0, 1.0)):
        np.testing.assert_array_equal(
            tdm.geometric_box_mask(K_CAM, T_cb, (0, 0, 0), size, H, W),
            jdm.geometric_box_mask(K_CAM, T_cb, (0, 0, 0), size, H, W))
    frames = [rng.uniform(0.2, 0.3, size=(H, W, 3)).astype(np.float32) for _ in range(5)]
    frames[2][3:7, 4:9] = 0.9  # an object that moves
    tm = tdm.motion_residual_masks(frames)
    jm = jdm.motion_residual_masks(frames)
    for a, e in zip(tm, jm):
        np.testing.assert_array_equal(a, e)
    assert not tm[2][4, 5]
    for a, e in zip(tdm.combine_masks(tm, jm), jdm.combine_masks(jm, tm)):
        np.testing.assert_array_equal(a, e)
    seeds = np.array([[6.0, 5.0]])
    if tdm._HAS_CV2:
        for a, e in zip(tdm.lk_region_masks(frames, seeds), jdm.lk_region_masks(frames, seeds)):
            np.testing.assert_array_equal(a, e)
    else:
        with pytest.raises(RuntimeError, match="cv2"):
            tdm.lk_region_masks(frames, seeds)
    root = jdataset.write_synthetic_images(str(tmp_path / "seq"), n_poses=5, height=H, width=W)
    tdm.write_masks_into_sequence(root, tm)
    for (_, m, _), want in zip(jdataset.ImageSequence(root), tm):
        np.testing.assert_array_equal(m, want)
