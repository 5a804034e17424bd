"""The port's map tools against the JAX package on the CPU: the "adjusted"
compositing, the renderers (virtual lidar scans, camera images, the global
cloud), the voxel downsample, the mesher (splat, surface nets, end to end)
and the render utilities (loner_tpu_torch/models/rendering.py,
analysis/{renderer,mesher,render_utils}.py). The JAX side's renders draw
their inverse-CDF uniforms from a key; the port is handed the same numbers
(``torch_parity.jax_render_u_pdf``). Two card tests hold a render chunk and
B1/B3 on a scan render's inputs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.analysis import mesher as jmesher
from loner_tpu.analysis import render_utils as jutils
from loner_tpu.analysis import renderer as jrenderer
from loner_tpu.models import rendering as jrendering
from loner_tpu_torch.analysis import mesher as tmesher
from loner_tpu_torch.analysis import render_utils as tutils
from loner_tpu_torch.analysis import renderer as trenderer
from loner_tpu_torch.convert import state_from_jax
from loner_tpu_torch.geometry.world_cube import compute_world_cube
from loner_tpu_torch.models import rendering as trendering

import torch_parity as tp
from test_adjusted_rendering import _reference_adjusted_depth

two_threads = tp.two_threads
POSE = np.array([[0.8, -0.6, 0.0, 1.0], [0.6, 0.8, 0.0, 0.5], [0.0, 0.0, 1.0, 1.5], [0.0, 0.0, 0.0, 1.0]])
K = np.array([[8.0, 0.0, 8.0], [0.0, 8.0, 6.0], [0.0, 0.0, 1.0]])
DISTORTION = np.array([-0.2, 0.05, 0.001, -0.002, 0.01])


# ---------------------------------------------------------------------------
# the adjusted compositing
# ---------------------------------------------------------------------------


def _profiles(kind: str):
    """(sigmas (N, S), z (N, S)) of one family of test profiles: the random
    multi-peak profiles of tests/test_adjusted_rendering.py, a sharp wall
    (every threshold crossed at one sample: all rise deltas 0), or coarse
    step profiles where some thresholds share a crossing (tied deltas)."""
    rng = np.random.default_rng(3)
    if kind == "random":
        n, s = 256, 96
        z = np.sort(rng.uniform(1.0, 30.0, size=(n, s)), axis=1)
        sigmas = np.zeros((n, s))
        for r in range(n):
            for _ in range(rng.integers(0, 4)):
                c, w, a = rng.uniform(2.0, 28.0), rng.uniform(0.1, 2.0), rng.uniform(0.1, 30.0)
                sigmas[r] += a * np.exp(-0.5 * ((z[r] - c) / w) ** 2)
        return sigmas, z
    if kind == "sharp_wall":
        z = np.tile(np.linspace(1.0, 20.0, 64), (8, 1))
        sigmas = np.zeros_like(z)
        for r in range(8):
            sigmas[r, z[r] >= 5.0 + r] = 500.0
        return sigmas, z
    n, s = 512, 12
    z = np.tile(np.linspace(1.0, 12.0, s), (n, 1))
    sigmas = rng.choice([0.0, 0.05, 0.1, 0.2, 0.5, 1.0, 3.0], size=(n, s))
    return sigmas, z


def _rise_deltas(sigmas, z):
    """The four rise deltas of each ray (numpy), as the reference builds them."""
    n = sigmas.shape[0]
    deltas = np.concatenate([z[:, 1:] - z[:, :-1], np.full((n, 1), 1e10)], axis=1)
    alphas = 1 - np.exp(-deltas * np.maximum(sigmas, 0.0))
    T = np.cumprod(np.concatenate([np.ones((n, 1)), 1 - alphas + 1e-10], axis=1), axis=1)[:, :-1]
    Ts = np.concatenate([np.ones((n, 1)), T[:, :-1]], axis=1)
    d = []
    for th in (0.9, 0.8, 0.7, 0.6, 0.501):
        m = ~(T > th) & (Ts > th)
        d.append(np.where(m.any(1), z[np.arange(n), np.argmax(m, 1)], 0.0))
    d = np.stack(d)
    return d[1:] - d[:-1]


@pytest.mark.parametrize("kind", ["random", "sharp_wall", "tied"])
def test_composite_peak_adjusted_matches_jax(kind):
    """Depth within rtol 1e-4 / atol 1e-5 of the JAX package's and of the
    per-ray transcription of the reference (the bounds of
    tests/test_adjusted_rendering.py); weights, opacity and rgb equal to the
    port's ``composite_t``. The sharp walls (all four rise deltas 0, so
    m1 / |m1 + m2| is 0/0 = NaN) keep the depth of the first sample past
    the wall: not dropped. The
    step profiles have tied deltas (a stable sort decides the order)."""
    sigmas, z = _profiles(kind)
    n = sigmas.shape[0]
    rays_d = np.tile(np.array([[1.0, 0.0, 0.0]]), (n, 1))
    _, jdepth, jw, jop, jvar = jrendering.composite_peak_adjusted(
        jnp.asarray(sigmas, jnp.float32)[None], jnp.asarray(z, jnp.float32), jnp.asarray(rays_d, jnp.float32),
        sigma_only=True)
    raw_t = torch.as_tensor(sigmas, dtype=torch.float32)[None]
    zt, dt = torch.as_tensor(z, dtype=torch.float32), torch.as_tensor(rays_d, dtype=torch.float32)
    rgb, depth, w, op, var = trendering.composite_peak_adjusted(raw_t, zt, dt, sigma_only=True)
    np.testing.assert_allclose(tp.t2n(depth), np.asarray(jdepth), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tp.t2n(depth), _reference_adjusted_depth(sigmas, z, rays_d), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tp.t2n(var), np.asarray(jvar), rtol=1e-4, atol=1e-5)
    crgb, _, cw, cop, _ = trendering.composite_t(raw_t, zt, dt, sigma_only=True)
    assert torch.equal(w, cw) and torch.equal(op, cop) and torch.equal(rgb, crgb)
    np.testing.assert_allclose(tp.t2n(w), np.asarray(jw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp.t2n(op), np.asarray(jop), rtol=1e-5, atol=1e-6)
    rise = _rise_deltas(sigmas, z)
    if kind == "sharp_wall":
        assert np.all(rise == 0)
        wall = z[np.arange(n), np.argmax(sigmas > 0, axis=1) + 1]  # the first sample past the wall
        np.testing.assert_array_equal(tp.t2n(depth), wall.astype(np.float32))
    if kind == "tied":
        tied = np.array([len(set(rise[:, r])) < 4 and len(set(rise[:, r])) > 1 for r in range(n)])
        assert tied.sum() >= 50, tied.sum()


def test_render_rays_refuses_an_unknown_strategy():
    z = torch.linspace(0.1, 1.0, 8)[None].repeat(2, 1)
    with pytest.raises(ValueError, match="Unknown render strategy"):
        trendering.render_rays({}, None, z, None, render_strategy="median")


# ---------------------------------------------------------------------------
# the renderers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _maps():
    """(jcfg, jcube, jstate, tcfg, tcube, tstate): the tiny flagship of
    torch_parity in both packages with a random occupancy grid, 24 samples
    a ray in the eval render and 16 in training, the field as initialised
    (its depths spread over the range: some rays terminate, some do not)."""
    jcfg, jcube, jstate, _ = tp.jax_flagship_tiny("float32")
    occ = np.random.default_rng(0).normal(0, 3, jstate.occ_grid.shape).astype(np.float32)
    jstate = jstate._replace(occ_grid=jnp.asarray(occ))
    jcfg = jcfg._replace(n_samples_test=24, n_samples_train=16)
    _, tcfg = tp.mapper_configs(float(jcube.scale_factor))
    tcfg = tcfg._replace(n_samples_test=24, n_samples_train=16)
    tcube = compute_world_cube(tp.jsyn.circular_trajectory(n_poses=tp.SCAN["n_keyframes"], radius=6.0, z=1.5)[0],
                               ray_range=tp.RAY_RANGE, rebase_to_first_pose=False)
    assert tcube.as_dict() == jcube.as_dict()
    return jcfg, jcube, jstate, tcfg, tcube, state_from_jax(tp.np_tree(jstate), device="cpu")


def _chunk_u_pdf(n_rays: int, chunk: int, n_samples: int, key=None) -> torch.Tensor:
    """The JAX ``_render_chunked``'s inverse-CDF uniforms of every real ray:
    its key split once a chunk, each chunk's render drawing for the padded
    chunk."""
    key = jax.random.PRNGKey(0) if key is None else key
    rows = []
    for s in range(0, n_rays, chunk):
        key, sub = jax.random.split(key)
        rows.append(tp.jax_render_u_pdf(sub, chunk, n_samples)[: min(chunk, n_rays - s)])
    return torch.from_numpy(np.concatenate(rows))


def _near_threshold(depth_m, var_m2, cfg, var_threshold):
    """Rays within 1e-6 (relative) of a keep threshold: the variance's or
    0.99 of the range's far end."""
    far = cfg.ray_range[1] * 0.99
    near_far = np.abs(depth_m - far) <= 1e-6 * far
    near_var = np.abs(var_m2 - var_threshold) <= 1e-6 * var_threshold if var_threshold else False
    return near_far | near_var


def test_render_lidar_scan_matches_jax():
    """A virtual 8 x 64 sweep in chunks of 200 (a padded tail on the JAX
    side) from the same state and uniforms: depth and variance within 1e-5
    (relative), the keep masks equal but for rays within 1e-6 of a
    threshold (counted: none here), the kept points within 1e-4 m."""
    jcfg, jcube, jstate, tcfg, tcube, tstate = _maps()
    j = jrenderer.render_lidar_scan(jcfg, jcube, jstate, POSE, n_channels=8, n_azimuth=64, chunk=200)
    u = _chunk_u_pdf(512, 200, tcfg.n_samples_test)
    t = trenderer.render_lidar_scan(tcfg, tcube, tstate, POSE, n_channels=8, n_azimuth=64, chunk=200, u_pdf=u)
    np.testing.assert_allclose(t["depth"], j["depth"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t["variance"], j["variance"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t["directions"], j["directions"])
    edge = _near_threshold(j["depth"], j["variance"], jcfg, 1e-2)
    assert np.array_equal(t["keep"] & ~edge, j["keep"] & ~edge) and edge.sum() == 0
    assert 0 < t["keep"].sum() < len(t["keep"])  # some rays kept, some dropped
    np.testing.assert_allclose(t["points"], j["points"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("variant", ["rgb_peak", "distortion", "adjusted"])
def test_render_camera_image_matches_jax(variant, monkeypatch):
    """A 12 x 16 image in chunks of 80 from the same state and uniforms,
    with the intensity branch and the peak-consistency map, on the distorted
    pixel grid, or composited by the adjusted strategy: every map within
    1e-5 (relative). The adjusted depth is held so on the pixels whose depth
    turns on no near-tie (``torch_parity.adjusted_tie_rays``, from the
    port's samples: counted and bounded), and the port's compositing of its
    own samples against the JAX package's on every pixel."""
    jcfg, jcube, jstate, tcfg, tcube, tstate = _maps()
    kw = {"rgb_peak": dict(rgb=True, peak_consistency=True), "distortion": dict(rgb=False, distortion=DISTORTION),
          "adjusted": dict(rgb=False, render_strategy="adjusted")}[variant]
    j = jrenderer.render_camera_image(jcfg, jcube, jstate, POSE, K, 12, 16, chunk=80, **kw)
    u = _chunk_u_pdf(12 * 16, 80, tcfg.n_samples_test)
    seen = []
    adjusted = trendering._STRATEGIES["adjusted"]

    def recording(raw_t, z_vals, rays_d, far, *a):
        seen.append((raw_t, z_vals, rays_d, far))
        return adjusted(raw_t, z_vals, rays_d, far, *a)

    monkeypatch.setitem(trendering._STRATEGIES, "adjusted", recording)
    t = trenderer.render_camera_image(tcfg, tcube, tstate, POSE, K, 12, 16, chunk=80, u_pdf=u, **kw)
    assert sorted(t) == sorted(j)
    tie = np.zeros(12 * 16, bool)
    if variant == "adjusted":
        raw, z, d, far = (torch.cat(x, dim=-2 if i == 0 else 0) for i, x in enumerate(zip(*seen)))
        tie = tp.adjusted_tie_rays(tp.t2n(z), tp.t2n(raw[0]), tp.t2n(d))
        assert tie.sum() <= 0.25 * len(tie), tie.sum()
        _, jd, _, _, _ = jrendering.composite_peak_adjusted(*(jnp.asarray(tp.t2n(x)) for x in (raw, z, d, far)),
                                                           sigma_only=True)
        np.testing.assert_allclose(t["depth"].ravel(), np.asarray(jd) * tcfg.world_scale, rtol=1e-5, atol=1e-5)
        assert np.any(t["depth"] == 0) and np.any(t["depth"] > 0)
    tie = tie.reshape(12, 16)
    for k in j:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
        np.testing.assert_allclose(t[k][~tie], j[k][~tie], rtol=1e-5, atol=1e-5, err_msg=k)


def test_assemble_global_cloud_matches_jax():
    """Two poses' 8 x 32 sweeps merged and voxel-averaged at 0.5 m, every
    scan with the uniforms of key 0 (as the JAX package renders each scan):
    the same voxels, their means within 1e-4 m."""
    jcfg, jcube, jstate, tcfg, tcube, tstate = _maps()
    poses = np.stack([POSE, POSE])
    poses[1, 0, 3] += 2.0
    kw = dict(voxel_size=0.5, n_channels=8, n_azimuth=32, chunk=128)
    j = jrenderer.assemble_global_cloud(jcfg, jcube, jstate, poses, **kw)
    t = trenderer.assemble_global_cloud(tcfg, tcube, tstate, poses, u_pdf=_chunk_u_pdf(256, 128, tcfg.n_samples_test),
                                        **kw)
    assert len(t) == len(j) > 0
    order = lambda c: c[np.lexsort(np.floor(c / 0.5).T)]  # noqa: E731
    np.testing.assert_allclose(order(t), order(j), rtol=0, atol=1e-4)


def test_voxel_downsample_matches_jax():
    pts = np.random.default_rng(0).uniform(-5, 5, (4000, 3))
    t, j = trenderer.voxel_downsample(pts, 0.7), jrenderer.voxel_downsample(pts, 0.7)
    assert t.shape == j.shape and len(t) < len(pts)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-12)
    assert len(trenderer.voxel_downsample(np.zeros((0, 3)), 0.1)) == 0


# ---------------------------------------------------------------------------
# the mesher
# ---------------------------------------------------------------------------


def test_splat_and_surface_nets_match_jax():
    """The max-splat on the same points and weights (a sphere's samples,
    points outside the grid, bounds given and not) equal to the JAX grid
    bit for bit, and surface nets on it equal."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(50000, 3))
    pts = (0.5 * v / np.linalg.norm(v, axis=1, keepdims=True) + rng.normal(0, 0.02, (50000, 3))).astype(np.float32)
    pts[:100] *= 3.0  # outside [-1, 1]^3
    w = rng.uniform(0, 1, 50000).astype(np.float32)
    for bounds in (None, (np.array([-0.7, -0.6, -0.8]), np.array([0.7, 0.8, 0.6]))):
        jg, jlo, jvox = jmesher.splat_weights_to_grid(pts, w, 48, bounds)
        tg, tlo, tvox = tmesher.splat_weights_to_grid(pts, w, 48, bounds)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tlo, jlo)
        np.testing.assert_array_equal(tvox, jvox)
        for level in (0.1, 0.5):
            jv, jf = jmesher.surface_nets(jg, level, jlo, jvox)
            tv, tf = tmesher.surface_nets(tg, level, tlo, tvox)
            np.testing.assert_array_equal(tv, jv)
            np.testing.assert_array_equal(tf, jf)
            assert len(tf) > 100 and tf.max() < len(tv)


def test_get_mesh_matches_jax(monkeypatch):
    """The mesh of two poses' 8 x 32 sweeps at the train step's samples,
    grid 32, from the same state and uniforms: the splatted grids agree to
    1e-5 (relative) and in their cells' side of the level (cells that differ
    are counted: none here), so the vertices are within 1e-5 of the scale
    and the faces equal."""
    jcfg, jcube, jstate, tcfg, tcube, tstate = _maps()
    poses = np.stack([POSE, np.eye(4)])
    grids = {}

    def recording(mod, name):
        fn = mod.surface_nets

        def surface_nets(grid, *a):
            grids[name] = grid
            return fn(grid, *a)

        monkeypatch.setattr(mod, "surface_nets", surface_nets)

    recording(jmesher, "jax")
    recording(tmesher, "port")
    jv, jf = jmesher.Mesher(jcfg, jcube, jstate).get_mesh(poses, resolution=32, level=0.05, n_channels=8,
                                                         n_azimuth=32, chunk=192)
    key, rows = jax.random.PRNGKey(0), []
    for _ in poses:  # per pose: a chunk of 192 rays and a padded one of 64
        for n in (192, 64):
            key, sub = jax.random.split(key)
            rows.append(tp.jax_render_u_pdf(sub, 192, tcfg.n_samples_train)[:n])
    mesher = tmesher.Mesher(tcfg, tcube, tstate)
    tv, tf = mesher.get_mesh(poses, resolution=32, level=0.05, n_channels=8, n_azimuth=32, chunk=192,
                             u_pdf=torch.from_numpy(np.concatenate(rows)))
    np.testing.assert_allclose(grids["port"], grids["jax"], rtol=1e-5, atol=1e-6)
    flipped = int(np.sum((grids["port"] > 0.05) != (grids["jax"] > 0.05)))
    assert flipped == 0, flipped
    assert len(tv) > 50 and set(mesher.last_timings) == {"render_s", "splat_s", "surface_nets_s"}
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5 * tcfg.world_scale)
    np.testing.assert_array_equal(tf, jf)


def test_ply_and_pcd_writers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    verts, faces, pts = rng.normal(size=(30, 3)), rng.integers(0, 30, (20, 3)), rng.normal(size=(40, 3))
    for mod, name in ((jmesher, "j"), (tmesher, "t")):
        mod.save_ply(str(tmp_path / f"{name}.ply"), verts, faces)
        mod.save_pcd(str(tmp_path / f"{name}.pcd"), pts)
    for ext in ("ply", "pcd"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()


# ---------------------------------------------------------------------------
# the render utilities
# ---------------------------------------------------------------------------


def test_render_utils_match_jax(tmp_path):
    """``depth_colormap`` bit-equal, ``interpolate_camera_path`` within
    1e-12 (spins, no interpolation, stationary key poses), and the PNG and
    GIF writers' files read back equal to the JAX package's."""
    import imageio.v2 as imageio

    d = np.random.default_rng(0).uniform(0, 60, (16, 24))
    for kw in ({}, dict(min_depth=0.0, max_depth=5.0)):
        np.testing.assert_array_equal(tutils.depth_colormap(d, **kw), jutils.depth_colormap(d, **kw))
    poses = np.tile(np.eye(4), (7, 1, 1))
    poses[:, 0, 3] = np.linspace(0.0, 30.0, 7)
    poses[3] = poses[2]  # a stationary pair
    poses[5, :3, :3] = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    for kw in (dict(velocity=2.0, fps=4.0, spin_spacing_m=10.0, spin_duration_s=1.0), dict(no_interp=True),
               dict(spin_spacing_m=None)):
        (tp_, ts_), (jp_, js_) = tutils.interpolate_camera_path(poses, **kw), jutils.interpolate_camera_path(poses, **kw)
        assert ts_ == js_
        np.testing.assert_allclose(tp_, jp_, rtol=0, atol=1e-12)
    rgb = np.random.default_rng(1).uniform(0, 1, (16, 24, 1))
    frames = [jutils.depth_colormap(d + i) for i in range(3)]
    for mod, name in ((jutils, "j"), (tutils, "t")):
        mod.save_depth_png(d, str(tmp_path / f"{name}_d.png"))
        mod.save_rgb_png(rgb, str(tmp_path / f"{name}_rgb.png"))
        mod.write_video(frames, str(tmp_path / f"{name}_v.gif"), fps=2)
    for f in ("d.png", "rgb.png", "v.gif"):
        np.testing.assert_array_equal(np.asarray(imageio.mimread(tmp_path / f"t_{f}")),
                                      np.asarray(imageio.mimread(tmp_path / f"j_{f}")))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_render_chunk_on_card_matches_cpu():
    """One virtual sweep of 8 x 128 rays at 2048 samples a ray (the yaml's
    n_samples_test) on the card and on the CPU from the same state and
    uniforms, within 6e-5 (relative; chip_smoke.py holds its full-width
    chunk on a trained map part by part, ``_render_card_vs_cpu``, PERF.md):
    the whole render (each device builds its rays and samples),
    and the render from the CPU's rays and samples, which on this untrained
    map's mostly transparent rays reads 1.9e-5 (the transmittance is a
    product of 2048 factors, taken in another order on each device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from loner_tpu_torch.geometry.rays import build_lidar_rays
    from loner_tpu_torch.models import sampling

    _, _, _, tcfg, tcube, tstate = _maps()
    tcfg = tcfg._replace(n_samples_test=2048)
    u = torch.rand((1024, 1024), generator=torch.Generator().manual_seed(0))
    cpu = trenderer.render_lidar_scan(tcfg, tcube, tstate, POSE, n_channels=8, n_azimuth=128, u_pdf=u)
    card_state = tp.topt.tree_map(lambda x: x.cuda(), tstate)
    card = trenderer.render_lidar_scan(tcfg, tcube, card_state, POSE, n_channels=8, n_azimuth=128, u_pdf=u)
    np.testing.assert_allclose(card["depth"], cpu["depth"], rtol=6e-5, atol=6e-5)
    with torch.no_grad():
        dirs = torch.as_tensor(cpu["directions"], dtype=torch.float32)
        b = build_lidar_rays(dirs, torch.zeros(len(dirs)), torch.as_tensor(POSE, dtype=torch.float32), tcube,
                             tcfg.ray_range)
        z = sampling.occ_grid_sampler_z_vals(b, tstate.occ_grid, tcfg.n_samples_test, 0.0, None, u)
        d_cpu = trendering.render_rays(tstate.params, b, z, tcfg.nerf).depth
        d_card = trendering.render_rays(card_state.params, type(b)(*(t.cuda() for t in b)), z.cuda(), tcfg.nerf).depth
    np.testing.assert_allclose(tp.t2n(d_card), tp.t2n(d_cpu), rtol=6e-5, atol=6e-5 / tcfg.world_scale)


@pytest.mark.gpu
def test_cp_fwd_and_pdf_sample_on_a_scan_render_inputs():
    """B1 and B3 on the inputs a virtual sweep's render gives them on the
    card (8 x 128 rays, 2048 samples): B1 within 1e-5 of its features'
    scale, B3 within 1e-6 of their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from loner_tpu_torch.models import sampling
    from loner_tpu_torch.ops import cp_kernel, pdf_kernel

    _, _, _, tcfg, tcube, tstate = _maps()
    tcfg = tcfg._replace(n_samples_test=2048)
    card_state = tp.topt.tree_map(lambda x: x.cuda(), tstate)
    seen = {}
    fwd, pdf = cp_kernel.cp_fwd, sampling.pdf_sample

    def rec(name, fn):
        def call(*args):
            seen.setdefault(name, tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return fn(*args)

        call.launches = 0  # the wrapper counts its launches through its module name
        return call

    cp_kernel.cp_fwd, sampling.pdf_sample = rec("cp_fwd", fwd), rec("pdf_sample", pdf)
    try:
        trenderer.render_lidar_scan(tcfg, tcube, card_state, POSE, n_channels=8, n_azimuth=128)
    finally:
        cp_kernel.cp_fwd, sampling.pdf_sample = fwd, pdf
    lines, pts, res, nf = seen["cp_fwd"]
    ref = cp_kernel.cp_encode_ref(lines, pts, res)
    assert pts.shape[1] == 1024 * 2048 // tcfg.nerf.point_chunks
    assert float((cp_kernel.cp_fwd(lines, pts, res, nf) - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))
    bins, cdf, u, eps = seen["pdf_sample"]
    assert u.shape == (1024, 1024)
    assert float((pdf_kernel.pdf_sample(bins, cdf, u, eps) - pdf_kernel.pdf_sample_ref(bins, cdf, u, eps)).abs().max()) <= 1e-6
