"""CP feature-line encode of the PyTorch port (loner_tpu_torch/ops/cp_kernel.py)
against the JAX package: the plain forward and the hand-written plain
backward against ``cp_encode_ref``, its VJP, and the Pallas kernels
``_fwd_pallas`` / ``_bwd_pallas`` run in TPU interpret mode, at the
tolerances of tests/test_cp_kernel.py. The card tests hold kernels B1/B2
against the plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from loner_tpu.ops import cp_kernel as jcp
from loner_tpu_torch.ops import cp_kernel as tcp

SIZES = {"small": ((4, 8), 4, 97), "flagship": ((16, 32, 64, 128), 16, 300)}


def _inputs(res, f, n, seed=0):
    rng = np.random.default_rng(seed)
    lines = np.zeros((3 * len(res), f, 128), np.float32)
    for i, r in enumerate(np.repeat(res, 3)):
        lines[i, :, :r] = 1.0 + 0.1 * rng.standard_normal((f, r))
    pts = rng.uniform(size=(3, n)).astype(np.float32)
    pts[:, 0], pts[:, 1] = 0.0, 1.0  # exact clip bounds
    pts[0, 2], pts[1, 3] = -0.25, 1.5  # outside the cube
    g = rng.standard_normal((len(res) * f, n)).astype(np.float32)
    return lines, pts, g


@pytest.mark.parametrize("size", sorted(SIZES))
def test_fwd_matches_jax_ref_and_pallas(size):
    res, f, n = SIZES[size]
    lines, pts, _ = _inputs(res, f, n)
    out = tcp.cp_encode_ref(torch.as_tensor(lines), torch.as_tensor(pts), res).numpy()
    ref = np.asarray(jcp.cp_encode_ref(jnp.asarray(lines), jnp.asarray(pts), res))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jcp._fwd_pallas(jnp.asarray(lines), jnp.asarray(pts), res, f))
    np.testing.assert_allclose(out, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_bwd_ref_matches_pallas_bwd(size):
    res, f, n = SIZES[size]
    lines, pts, g = _inputs(res, f, n)
    dl, dp = tcp.cp_bwd_ref(torch.as_tensor(lines), torch.as_tensor(pts), torch.as_tensor(g), res, f)
    with pltpu.force_tpu_interpret_mode():
        dl_k, dp_k = jcp._bwd_pallas(jnp.asarray(lines), jnp.asarray(pts), jnp.asarray(g), res, f)
    np.testing.assert_allclose(dl.numpy(), np.asarray(dl_k), rtol=1e-4, atol=1e-4)
    # same semantics as the kernel, clip bounds included (zero there)
    np.testing.assert_allclose(dp.numpy(), np.asarray(dp_k), rtol=2e-3, atol=5e-4)
    assert np.all(dp.numpy()[:, :2] == 0.0)


def test_bwd_ref_matches_vjp_of_jax_ref():
    res, f, n = SIZES["flagship"]
    lines, pts, g = _inputs(res, f, n)
    _, vjp = jax.vjp(lambda l, p: jcp.cp_encode_ref(l, p, res), jnp.asarray(lines), jnp.asarray(pts))
    dl_ref, dp_ref = vjp(jnp.asarray(g))
    dl, dp = tcp.cp_bwd_ref(torch.as_tensor(lines), torch.as_tensor(pts), torch.as_tensor(g), res, f)
    np.testing.assert_allclose(dl.numpy(), np.asarray(dl_ref), rtol=1e-4, atol=1e-4)
    # autodiff of the reference keeps half a slope at the exact clip bounds
    # (points 0 and 1), where the kernels' backward is zero
    np.testing.assert_allclose(dp.numpy()[:, 2:], np.asarray(dp_ref)[:, 2:], rtol=2e-3, atol=5e-4)


def _bwd_kernel_bf16_in_jnp(lines, pts, g, res, f):
    """dlines of ``_bwd_kernel`` with mm="bf16", its arithmetic written out in
    jnp outside Pallas: the kernel's lerp (``_axis_lerp``), its hat matrix
    (``_build_w``) and a bf16 x bf16 product accumulated in f32."""
    n = pts.shape[1]
    pad = (-n) % 128
    out = []
    for lvl, r in enumerate(res):
        gl = g[lvl * f : (lvl + 1) * f]
        feats = [
            jcp._axis_lerp(lines[3 * lvl + a], jnp.pad(pts[a : a + 1], ((0, 0), (0, pad))), r, f)[0][:, :n]
            for a in range(3)
        ]
        for a in range(3):
            go = gl * feats[(a + 1) % 3] * feats[(a + 2) % 3]
            w = jcp._build_w(pts[a], r, n).astype(jnp.bfloat16)
            out.append(jax.lax.dot_general(
                go.astype(jnp.bfloat16), w, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
            ))
    return np.asarray(jnp.stack(out))


def test_bwd_ref_bf16_matches_pallas_bwd_bf16():
    """mm="bf16": g*feat_b*feat_c and the hat weights rounded to bf16 before
    the dlines product, as in _bwd_kernel. Against the kernel's arithmetic
    written out in jnp the products of bf16 operands are exact in f32 and
    only the summation order differs: rtol/atol 1e-5. Against _bwd_pallas in
    interpret mode, whose CPU emulation of the bf16 product rounds more than
    the f32-accumulating matrix unit: within one bf16 ulp (2^-7) of the
    largest entry. dpts is not affected by the knob."""
    res, f, n = SIZES["flagship"]
    lines, pts, g = _inputs(res, f, n, seed=1)
    dl, dp = tcp.cp_bwd_ref(torch.as_tensor(lines), torch.as_tensor(pts), torch.as_tensor(g), res, f, mm="bf16")
    dl = dl.numpy()
    np.testing.assert_allclose(
        dl, _bwd_kernel_bf16_in_jnp(jnp.asarray(lines), jnp.asarray(pts), jnp.asarray(g), res, f),
        rtol=1e-5, atol=1e-5,
    )
    with pltpu.force_tpu_interpret_mode():
        dl_k, dp_k = jcp._bwd_pallas(jnp.asarray(lines), jnp.asarray(pts), jnp.asarray(g), res, f, mm="bf16")
    dl_k = np.asarray(dl_k)
    assert np.abs(dl - dl_k).max() <= 2.0**-7 * np.abs(dl_k).max()
    np.testing.assert_allclose(dp.numpy(), np.asarray(dp_k), rtol=2e-3, atol=5e-4)
    dl32, _ = tcp.cp_bwd_ref(torch.as_tensor(lines), torch.as_tensor(pts), torch.as_tensor(g), res, f)
    assert not np.array_equal(dl, dl32.numpy())  # the knob changes the product


def test_encode_autograd_matches_jax_grad():
    res, f, n = SIZES["small"]
    lines, pts, g = _inputs(res, f, n, seed=2)
    lt = torch.as_tensor(lines).requires_grad_(True)
    pt = torch.as_tensor(pts).requires_grad_(True)
    out = tcp.cp_encode_t(lt, pt, res, f)
    torch.sum(out * torch.as_tensor(g)).backward()
    gl, gp = jax.grad(
        lambda l, p: jnp.sum(jcp.cp_encode_t(l, p, res, f) * jnp.asarray(g)), argnums=(0, 1)
    )(jnp.asarray(lines), jnp.asarray(pts))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jcp.cp_encode_ref(jnp.asarray(lines), jnp.asarray(pts), res)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pt.grad.numpy()[:, 2:], np.asarray(gp)[:, 2:], rtol=2e-3, atol=5e-4)
    # padded tail rows never receive gradient
    for lvl, r in enumerate(res):
        for a in range(3):
            assert float(lt.grad[3 * lvl + a, :, r:].abs().sum()) == 0.0


def test_init_cp_lines_layout():
    res, f = (4, 8, 128), 3
    lines = tcp.init_cp_lines(torch.Generator().manual_seed(0), res, f, device="cpu")
    assert lines.shape == (9, f, 128) and lines.dtype == torch.float32
    for i, r in enumerate(np.repeat(res, 3)):
        assert float(lines[i, :, r:].abs().sum()) == 0.0
        assert abs(float(lines[i, :, :r].mean()) - 1.0) < 0.2
    with pytest.raises(ValueError):
        tcp.init_cp_lines(torch.Generator().manual_seed(0), (129,), f, device="cpu")


def test_cpu_tensors_take_the_plain_path_uncounted():
    res, f, n = SIZES["small"]
    lines, pts, g = _inputs(res, f, n)
    before = (tcp.cp_fwd.launches, tcp.cp_bwd.launches)
    out = tcp.cp_fwd(torch.as_tensor(lines), torch.as_tensor(pts), res, f)
    dl, dp = tcp.cp_bwd(torch.as_tensor(lines), torch.as_tensor(pts), torch.as_tensor(g), res, f)
    assert torch.equal(out, tcp.cp_encode_ref(torch.as_tensor(lines), torch.as_tensor(pts), res))
    assert (tcp.cp_fwd.launches, tcp.cp_bwd.launches) == before
    with pytest.raises(ValueError):
        tcp.cp_encode_t(torch.as_tensor(lines), torch.as_tensor(pts), res, f, mm="f16")


# every CP configuration in the repo: the flagship triad,
# tests/torch_parity.py's TRIAD and tests/test_torch_isolation.py's triad
CP_CONFIGS = {"flagship": ((16, 32, 64, 128), 16), "parity": ((4, 8), 4), "isolation": ((4,), 2)}


@pytest.mark.parametrize("config", sorted(CP_CONFIGS))
def test_cp_bwd_plan_fits_every_configuration(config):
    res, f = CP_CONFIGS[config]
    plan = tcp.cp_bwd_plan(res, f)
    assert plan.smem_bytes <= 232_448
    assert plan.tile == plan.runs * plan.run and plan.feature_lanes == min(f, tcp.CP_BWD_MAX_THREADS)
    assert plan.runs * plan.feature_lanes <= plan.threads <= tcp.CP_BWD_MAX_THREADS
    table = -(-3 * sum(res) * (f | 1) // 4) * 4  # padded to 16 bytes
    cells = 4 * len(res) * plan.tile
    parts = 0 if f == 16 else plan.tile * (3 * plan.feature_lanes + 1)
    assert plan.smem_bytes == 4 * (table + 4 * plan.tile + max(cells, parts))


def test_cp_bwd_plan_at_the_flagship():
    """Two blocks an SM at the flagship: 16 runs of 16 points, 256 threads,
    69,440 bytes of shared memory (no partial-sum area at F = 16)."""
    plan = tcp.cp_bwd_plan(*CP_CONFIGS["flagship"])
    assert (plan.run, plan.runs, plan.threads, plan.tile, plan.smem_bytes) == (16, 16, 256, 256, 69_440)
    assert 2 * (plan.smem_bytes + 1024) <= 233_472  # an SM's 228 KB, 1 KB reserved per block


@pytest.mark.parametrize("res", [(16, 32, 64, 128, 16, 32, 64, 128, 16), (129,), (1,), ()])
def test_cp_bwd_plan_refuses_what_the_kernel_does_not_take(res):
    with pytest.raises(ValueError):
        tcp.cp_bwd_plan(res, 4)


def test_cp_bwd_plan_refuses_a_table_too_large_for_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        tcp.cp_bwd_plan((128,) * 8, 16)
    with pytest.raises(ValueError):
        tcp.cp_bwd_plan((4,), 0)


@pytest.mark.parametrize("f", [1, 2, 5, 16, 33, 300])
def test_cp_bwd_plan_gives_whole_warps(f):
    plan = tcp.cp_bwd_plan((4, 8), f)
    assert plan.threads % 32 == 0
    assert plan.threads - 32 < plan.runs * plan.feature_lanes <= plan.threads


def _card_points(kind, res, n, rng):
    """(3, N) points: uniform, all in one cell of every level, or on cell
    boundaries of every level with 0, 1 and points outside the cube."""
    if kind == "uniform":
        return rng.uniform(size=(3, n)).astype(np.float32)
    if kind == "one_cell":
        return (0.5 + 1e-3 * rng.uniform(size=(3, n))).astype(np.float32)
    r = rng.choice(np.asarray(res), size=(3, n))
    pts = (rng.integers(0, r) / (r - 1)).astype(np.float32)
    pts[:, : min(n, 4)] = np.array([0.0, 1.0, -0.25, 1.5], np.float32)[: min(n, 4)]
    return pts


_T = tcp.cp_bwd_plan(*CP_CONFIGS["flagship"]).tile
FLAG_RES = CP_CONFIGS["flagship"][0]
BWD_CARD_CASES = {
    "rays": ("rays", FLAG_RES, 16, None),
    "uniform_n100003": ("uniform", FLAG_RES, 16, 100_003),
    "uniform_n100000": ("uniform", FLAG_RES, 16, 100_000),
    "one_cell": ("one_cell", FLAG_RES, 16, 4096),
    "boundaries": ("boundaries", FLAG_RES, 16, 5000),
    **{f"n{n}": ("uniform", FLAG_RES, 16, n) for n in (1, 31, 33, _T - 1, _T + 1)},
    "f2": ("uniform", FLAG_RES, 2, 10_000),
    "f5": ("uniform", FLAG_RES, 5, 10_001),
    "f300_chunks": ("uniform", (4,), 300, 1000),
    "l1_res2": ("boundaries", (2,), 16, 3000),
    "l1_res128": ("uniform", (128,), 16, 3000),
    "l8": ("uniform", (2, 4, 8, 16, 32, 64, 128, 128), 2, 20_000),
    "l8_f5": ("boundaries", (16, 16, 32, 32, 64, 64, 128, 128), 5, 7777),
}


def _card_rays_points():
    """Ray-ordered points built as chip_smoke.py builds them, from the
    flagship's sampler at a reduced ray count (2 keyframes x 80 rays x 512
    samples)."""
    from loner_tpu_torch.flagship import flagship
    from loner_tpu_torch.mapping import optimizer as opt

    dev = torch.device("cuda", 0)
    small = opt.MapperConfig()._replace(window_size=2, max_keyframes=4, rays_per_kf=64, sky_rays_per_kf=16)
    cfg, cube, state, window = flagship(device=dev, cfg=small, n_keyframes=2)
    draws = opt.draw_step(cfg, window, torch.Generator(device=dev).manual_seed(1), dev)
    with torch.no_grad():
        bundle = opt.build_window_rays(state.poses, window, cube.to(dev), cfg, draws.ray_idx, draws.sky_idx)
        z = opt.sampling.occ_grid_sampler_z_vals(bundle, state.occ_grid, cfg.n_samples_train, cfg.perturb,
                                                 draws.u_strat, draws.u_pdf)
        pts = (bundle.origins.T[:, :, None] + bundle.directions.T[:, :, None] * z[None]).reshape(3, -1)
    return ((pts + 1.0) / 2.0).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BWD_CARD_CASES))
def test_cp_kernels_match_plain_on_card(case):
    """B1 bit-equal to its plain version; B2 against ``cp_bwd_ref`` in f32
    and bf16: dlines within 1e-4 of its largest entry (atomics and runs add
    in their own order), dpts within rtol/atol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kind, res, f, n = BWD_CARD_CASES[case]
    rng = np.random.default_rng(sorted(BWD_CARD_CASES).index(case))
    pts = _card_rays_points() if kind == "rays" else torch.as_tensor(_card_points(kind, res, n, rng)).cuda()
    n = pts.shape[1]
    lines = torch.zeros((3 * len(res), f, 128), dtype=torch.float32)
    for i, r in enumerate(np.repeat(res, 3)):
        lines[i, :, :r] = torch.as_tensor(1.0 + 0.1 * rng.standard_normal((f, r)), dtype=torch.float32)
    lines = lines.cuda()
    g = torch.as_tensor(rng.standard_normal((len(res) * f, n)), dtype=torch.float32).cuda()
    before = (tcp.cp_fwd.launches, tcp.cp_bwd.launches)
    out = tcp.cp_fwd(lines, pts, res, f)
    assert torch.equal(out, tcp.cp_encode_ref(lines, pts, res))  # same op order, no FMA
    for mm in ("f32", "bf16"):
        dl, dp = tcp.cp_bwd(lines, pts, g, res, f, mm)
        dl_ref, dp_ref = tcp.cp_bwd_ref(lines, pts, g, res, f, mm)
        assert float((dl - dl_ref).abs().max()) <= 1e-4 * float(dl_ref.abs().max()), mm
        torch.testing.assert_close(dp, dp_ref, rtol=1e-4, atol=1e-4)
        for lvl, r in enumerate(res):  # padded rows get no gradient
            assert float(dl[3 * lvl : 3 * lvl + 3, :, r:].abs().sum()) == 0.0
    torch.cuda.synchronize()
    assert (tcp.cp_fwd.launches, tcp.cp_bwd.launches) == (before[0] + 1, before[1] + 2)


@pytest.mark.gpu
def test_cp_wrappers_reject_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res, f, n = SIZES["small"]
    lines, pts, g = (torch.as_tensor(a).cuda() for a in _inputs(res, f, n))
    with pytest.raises(ValueError):
        tcp.cp_fwd(lines, pts.double(), res, f)
    with pytest.raises(ValueError):
        tcp.cp_fwd(lines, pts.T.contiguous().T, res, f)  # not contiguous
    with pytest.raises(ValueError):
        tcp.cp_fwd(lines.cpu(), pts, res, f)
    with pytest.raises(ValueError):
        tcp.cp_bwd(lines, pts, g[:, :-1].contiguous(), res, f)


def test_fwd_gather_ref_matches_pallas_lane_gather_probe():
    """``cp_fwd_gather_ref`` against the lane-gather probe's Pallas kernel
    (``scripts/bench_lane_gather.py::_gather_fwd_kernel``, with that script's
    grid and block specs) in TPU interpret mode: within 1e-6, and within
    1e-5 of the JAX ``cp_encode_ref``; points at 0, at 1 and outside the cube."""
    from functools import partial

    from jax.experimental import pallas as pl

    import torch_parity as tp

    mod = tp.load_script("bench_lane_gather")
    res, f = SIZES["flagship"][:2]  # the probe's F = 16, its lines (12, 16, 128)
    n, c = 4096, 2048
    lines, pts, _ = _inputs(res, f, n)
    nl = len(res)
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            partial(mod._gather_fwd_kernel, resolutions=res, n_features=f),
            grid=(n // c,),
            in_specs=[
                pl.BlockSpec((3, c), lambda j: (0, j), memory_space=pltpu.VMEM),
                pl.BlockSpec((3 * nl, f, mod.R), lambda j: (0, 0, 0), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((nl * f, c), lambda j: (0, j), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((nl * f, n), jnp.float32),
        )
        pallas = np.asarray(call(jnp.asarray(pts), jnp.asarray(lines)))
    out = tcp.cp_fwd_gather_ref(torch.as_tensor(lines), torch.as_tensor(pts), res).numpy()
    np.testing.assert_allclose(out, pallas, rtol=1e-6, atol=1e-6)
    ref = np.asarray(jcp.cp_encode_ref(jnp.asarray(lines), jnp.asarray(pts), res))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_fwd_gather_cpu_tensors_take_the_plain_path_uncounted():
    res, f, n = SIZES["small"]
    lines, pts, _ = (torch.as_tensor(a) for a in _inputs(res, f, n))
    before = tcp.cp_fwd_gather.launches
    assert torch.equal(tcp.cp_fwd_gather(lines, pts, res, f), tcp.cp_fwd_gather_ref(lines, pts, res))
    assert tcp.cp_fwd_gather.launches == before


@pytest.mark.gpu
def test_cp_fwd_gather_matches_plain_and_b1_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res, f, n = SIZES["flagship"]
    for seed, n_pts in ((0, n), (1, 100_003)):
        lines, pts, _ = (torch.as_tensor(a).cuda() for a in _inputs(res, f, n_pts, seed))
        before = tcp.cp_fwd_gather.launches
        out = tcp.cp_fwd_gather(lines, pts, res, f)
        # same op order, no FMA: bit-identical to the plain version and B1
        assert torch.equal(out, tcp.cp_fwd_gather_ref(lines, pts, res))
        assert torch.equal(out, tcp.cp_fwd(lines, pts, res, f))
        torch.cuda.synchronize()
        assert tcp.cp_fwd_gather.launches == before + 1
    with pytest.raises(ValueError):
        tcp.cp_fwd_gather(lines, pts.double(), res, f)
