"""FusedHash encoder of the PyTorch port (loner_tpu_torch/ops/fused_encoder.py)
against the JAX package, at two small shapes: the 4-level FusedHash of
tests/test_fused_encoder.py (F=2, 2^10 cells, base 4: levels 0-1 dense) and
the triad's fat-row hash level (L=1, F=4, 2^10 cells). Cell ids bit-equal;
the plain forward and point gradient against the jnp references and the
Pallas kernels in TPU interpret mode; the exact and strided table gradients;
the key fallback; the whole autograd encode against ``jax.grad``; the exact
table gradient's slabs, launch plan and run share. The card tests hold
kernels B4/B5 and the table-gradient kernel against their plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from loner_tpu.ops import fused_encoder as jfe
from loner_tpu_torch.ops import fused_encoder as tfe

CFGS = {
    "fused": dict(n_levels=4, log2_cells=10, base_resolution=4, per_level_scale=2.0, slot_period=16, bwd_stride=2),
    "triad_hash": dict(n_levels=1, log2_cells=10, base_resolution=512, per_level_scale=2.0, slot_period=16,
                       bwd_stride=8, n_features=4),
}
KEYS = ((0, 0), (3, 1), (4294967295, 2654435761))
T = torch.as_tensor


def _cfgs(name, **kw):
    return jfe.FusedHashConfig(**CFGS[name], **kw), tfe.FusedHashConfig(**CFGS[name], **kw)


def _inputs(cfg, n=256, seed=0):
    """O(1) table values (the JAX test's scale), points in the cube with edge
    points (0, 1, and outside it on both sides), and a feature gradient."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, size=(cfg.n_levels, cfg.table_size, cfg.row_width)).astype(np.float32)
    pts = rng.uniform(0.01, 0.99, size=(3, n)).astype(np.float32)
    pts[:, 1], pts[:, 2] = 0.0, 1.0
    pts[0, 3], pts[1, 4], pts[2, 5] = -0.3, 1.2, 1.0 - 1e-7
    g = rng.standard_normal((cfg.output_dim, n)).astype(np.float32)
    return table, pts, g


def _jv(table, pts, cfg):
    return jfe._gather_v_t(jnp.asarray(table).astype(jnp.bfloat16), jnp.asarray(pts), cfg)


def _tv(table, pts, cfg):
    return tfe._gather_v_t(T(table).to(torch.bfloat16), T(pts), cfg)


def test_config_matches_jax():
    for name in CFGS:
        jc, tc = _cfgs(name)
        assert tuple(jc) == tuple(tc)
        assert (jc.table_size, jc.output_dim, jc.row_width) == (tc.table_size, tc.output_dim, tc.row_width)
        np.testing.assert_array_equal(jc.level_scales(), tc.level_scales())
        np.testing.assert_array_equal(jc.level_resolutions(), tc.level_resolutions())
        np.testing.assert_array_equal(jc.level_is_dense(), tc.level_is_dense())
    assert list(_cfgs("fused")[1].level_is_dense()) == [True, True, False, False]
    flagship = tfe.FusedHashConfig()
    assert flagship.level_scales()[15] == 524287.0 and list(np.nonzero(flagship.level_is_dense())[0]) == [0, 1]


@pytest.mark.parametrize("name", sorted(CFGS))
def test_cell_ids_match_jax_bit_for_bit(name):
    jc, tc = _cfgs(name)
    _, pts, _ = _inputs(tc, n=512)
    for lvl, res in enumerate(tc.level_resolutions()):
        res = int(res)
        got = tfe._level_indices(T(pts), tc, lvl).numpy()
        np.testing.assert_array_equal(got, np.asarray(jfe._level_indices(jnp.asarray(pts), jc, lvl)))
        assert got.min() >= 0 and got.max() < tc.table_size
        # edge cells of the hash and the dense index: 0, res - 1, and large cells
        cells = np.array([[0, res - 1, res - 1, 0, 7, res // 2],
                          [0, res - 1, 0, res - 1, res - 2, 1],
                          [0, res - 1, res - 1, res - 1, 3, res - 3]], np.int32)
        for dense in (False, True):
            want = np.asarray(jfe._cell_ids(jnp.asarray(cells), res, dense, tc.table_size))
            np.testing.assert_array_equal(tfe._cell_ids(T(cells).long(), res, dense, tc.table_size).numpy(), want)
    # the clip: a point outside the cube takes the edge cell
    cells, _ = tfe._cell_frac(T(pts), tc.level_scales()[-1], int(tc.level_resolutions()[-1]))
    jcells, _ = jfe._cell_frac(jnp.asarray(pts), float(jc.level_scales()[-1]), int(jc.level_resolutions()[-1]))
    np.testing.assert_array_equal(cells.numpy(), np.asarray(jcells))
    assert cells[0, 3] == 0 and cells[1, 4] == int(tc.level_resolutions()[-1]) - 1


@pytest.mark.parametrize("name", sorted(CFGS))
def test_interp_fwd_ref_matches_jax_and_pallas(name):
    jc, tc = _cfgs(name)
    table, pts, _ = _inputs(tc)
    v_t = _tv(table, pts, tc)
    jv = _jv(table, pts, jc)
    np.testing.assert_array_equal(v_t.float().numpy(), np.asarray(jv.astype(jnp.float32)))
    out = tfe.interp_fwd_ref(T(pts), v_t, tc).numpy()
    np.testing.assert_allclose(out, np.asarray(jfe._interp_fwd_ref(jnp.asarray(pts), jv, jc)), rtol=1e-5, atol=1e-5)
    scales = jnp.asarray(jc.level_scales()).reshape(-1, 1)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jfe._interp_fwd_pallas(jnp.asarray(pts), jv, jc, scales))
    np.testing.assert_allclose(out, pallas, rtol=1e-5, atol=1e-5)
    assert torch.equal(tfe.interp_fwd(T(pts), v_t, tc), T(out))  # CPU tensors take the plain version


@pytest.mark.parametrize("name", sorted(CFGS))
def test_dpts_ref_matches_jax_and_pallas(name):
    jc, tc = _cfgs(name)
    table, pts, g = _inputs(tc)
    v_t, jv = _tv(table, pts, tc), _jv(table, pts, jc)
    d = tfe.dpts_ref(T(pts), v_t, T(g), tc).numpy()
    np.testing.assert_allclose(d, np.asarray(jfe._dpts_ref(jnp.asarray(pts), jv, jnp.asarray(g), jc)),
                               rtol=1e-4, atol=1e-4)
    scales = jnp.asarray(jc.level_scales()).reshape(-1, 1)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jfe._dpts_pallas(jnp.asarray(pts), jv, jnp.asarray(g), jc, scales))
    np.testing.assert_allclose(d, pallas, rtol=1e-4, atol=1e-4)
    assert torch.equal(tfe.interp_dpts(T(pts), v_t, T(g), tc), T(d))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_table_gradients_match_jax(name):
    """Exact and strided table gradients, the strided one for given key
    words; scatter sums run in other orders (1e-5 normwise)."""
    jc, tc = _cfgs(name)
    n = 16 * tc.slot_period  # 16 rays of S samples
    _, pts, g = _inputs(tc, n=n, seed=1)
    exact = tfe._bwd_dtable_exact(T(pts), T(g), tc).numpy()
    assert exact.dtype == np.float32
    assert _rel(exact, np.asarray(jfe._bwd_dtable_exact(jnp.asarray(pts), jnp.asarray(g), jc))) <= 1e-5
    for words in KEYS:
        got = tfe._bwd_dtable_strided(T(pts), T(g), torch.tensor(words, dtype=torch.int64), tc).numpy()
        want = np.asarray(jfe._bwd_dtable_strided(jnp.asarray(pts), jnp.asarray(g), jnp.asarray(words, jnp.uint32), jc))
        assert np.count_nonzero(want) > 0
        assert _rel(got, want) <= 1e-5, words


@pytest.mark.parametrize("name", sorted(CFGS))
def test_strided_gradient_mean_is_the_exact_gradient(name):
    jc, tc = _cfgs(name)
    _, pts, g = _inputs(tc, n=8 * tc.slot_period, seed=2)
    exact = tfe._bwd_dtable_exact(T(pts), T(g), tc)
    l, k = tc.n_levels, tc.bwd_stride
    acc = sum(tfe._bwd_dtable_strided(T(pts), T(g), torch.tensor([rot, phase]), tc)
              for rot in range(l) for phase in range(k))
    np.testing.assert_allclose((acc / (l * k)).numpy(), exact.numpy(), rtol=1e-3, atol=1e-5)


def test_key_fallback_matches_jax_bit_for_bit():
    """Without a key the two words come from the first 8 points' mantissa
    bits, summed with uint32 wraparound."""
    rng = np.random.default_rng(4)
    for n in (3, 8, 100):
        pts = rng.uniform(0.0, 1.0, size=(3, n)).astype(np.float32)
        b = jax.lax.bitcast_convert_type(jnp.asarray(pts[:, : min(8, n)]), jnp.uint32)  # fused_encoder.py:445-452
        h0 = jnp.bitwise_xor(b[0] * jnp.uint32(2654435761), b[1] * jnp.uint32(805459861))
        h1 = jnp.bitwise_xor(h0, b[2] * jnp.uint32(3674653429))
        want = np.asarray(jnp.stack([h0.sum(dtype=jnp.uint32), h1.sum(dtype=jnp.uint32)])).astype(np.int64)
        np.testing.assert_array_equal(tfe.key_data_from_points(T(pts)).numpy(), want)


def _jax_encode_grads(table, pts, g, cfg, key):
    jkey = None if key is None else jnp.asarray(key, jnp.uint32)
    out, (gt, gp) = jax.value_and_grad(
        lambda t, p: jnp.sum(jfe.fused_hash_encode_t(t, p, cfg, jkey) * g), argnums=(0, 1)
    )(jnp.asarray(table), jnp.asarray(pts))
    return np.asarray(jfe.fused_hash_encode_t(jnp.asarray(table), jnp.asarray(pts), cfg, jkey)), np.asarray(gt), np.asarray(gp)


def _torch_encode_grads(table, pts, g, cfg, key):
    tt, pt = T(table).clone().requires_grad_(True), T(pts).clone().requires_grad_(True)
    tkey = None if key is None else torch.tensor(key, dtype=torch.int64)
    out = tfe.fused_hash_encode_t(tt, pt, cfg, tkey)
    torch.sum(out * T(g)).backward()
    return out.detach().numpy(), tt.grad.numpy(), pt.grad.numpy()


@pytest.mark.parametrize("key", [None, KEYS[2]])
@pytest.mark.parametrize("bwd", ["strided", "exact"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_encode_matches_jax_grad(name, bwd, key):
    jc, tc = _cfgs(name, bwd=bwd)
    table, pts, g = _inputs(tc, n=4 * tc.slot_period, seed=3)
    table *= 1e-2
    out, gt, gp = _torch_encode_grads(table, pts, g, tc, key)
    jout, jgt, jgp = _jax_encode_grads(table, pts, g, jc, key)
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-6)
    assert _rel(gt, jgt) <= 1e-5
    np.testing.assert_allclose(gp, jgp, rtol=1e-4, atol=1e-4 * float(np.abs(jgp).max()))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_save_residual_off_matches_on(name):
    _, tc = _cfgs(name)
    table, pts, g = _inputs(tc, n=2 * tc.slot_period, seed=5)
    on = _torch_encode_grads(table, pts, g, tc, KEYS[1])
    off = _torch_encode_grads(table, pts, g, tc._replace(save_residual=False), KEYS[1])
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def test_frozen_points_skip_the_point_gradient():
    """Points that need no gradient (a pose-frozen step) get none, and the
    table gradient is unchanged."""
    _, tc = _cfgs("fused")
    table, pts, g = _inputs(tc, n=2 * tc.slot_period, seed=6)
    tt = T(table).clone().requires_grad_(True)
    torch.sum(tfe.fused_hash_encode_t(tt, T(pts), tc, torch.tensor(KEYS[1])) * T(g)).backward()
    np.testing.assert_array_equal(tt.grad.numpy(), _torch_encode_grads(table, pts, g, tc, KEYS[1])[1])


def test_init_fused_table():
    _, tc = _cfgs("fused")
    t = tfe.init_fused_table(torch.Generator().manual_seed(0), tc, device="cpu")
    assert t.shape == (4, 1024, 16) and t.dtype == torch.float32
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 5e-5


def _ray_samples(n_rays, s, seed):
    """(3, n_rays * s) points as rays of s samples sorted in depth, each
    ray's samples contiguous (render_rays's layout), inside the unit cube."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(0.3, 0.7, size=(3, n_rays, 1))
    dirs = rng.standard_normal((3, n_rays, 1))
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True)
    depth = np.sort(rng.uniform(0.0, 0.3, size=(1, n_rays, s)), axis=-1)
    return T((origins + dirs * depth).reshape(3, -1).astype(np.float32))


@pytest.mark.parametrize("nf", [2, 16])
def test_exact_table_gradient_slabs_are_rows_of_the_whole(nf):
    """The gradient of a slab [row0, row0 + rows) is those rows of the whole
    table's gradient, at dense levels (0-1) and hashed ones (2-3)."""
    _, tc = _cfgs("fused", n_features=nf, bwd="exact")
    assert list(tc.level_is_dense()) == [True, True, False, False]
    _, pts, g = _inputs(tc, n=300, seed=7)
    whole = tfe._bwd_dtable_exact(T(pts), T(g), tc)
    t = tc.table_size
    for row0, rows in ((0, t // 2), (t // 2, t // 2), (t // 4, t // 2), (t - 3, 3)):
        slab = tfe._bwd_dtable_exact(T(pts), T(g), tc, row0, rows)
        assert slab.shape == (tc.n_levels, rows, tc.row_width)
        np.testing.assert_array_equal(slab.numpy(), whole[:, row0 : row0 + rows].numpy())
    # dense levels 0-1 index 4^3 and 8^3 cells
    assert torch.count_nonzero(whole[0, 64:]) == torch.count_nonzero(whole[1, 512:]) == 0
    assert torch.count_nonzero(whole[2:]) > 0


@pytest.mark.parametrize("nf", range(1, 33))
def test_exact_table_gradient_plan_takes_every_width(nf):
    """Every row of 8F floats is whole float4s: 2F vector atomics a run."""
    plan = tfe.dtable_exact_plan(16, nf, 2_359_296, 1 << 16, 1 << 16)
    assert plan == tfe.DtablePlan(blocks=9216, vec4_per_run=2 * nf)
    assert tfe.dtable_exact_plan(1, nf, 257, 1, 1).blocks == 2


@pytest.mark.parametrize("args", [
    (16, 0, 100, 1024, 1024), (16, 33, 100, 1024, 1024), (0, 2, 100, 1024, 1024), (33, 2, 100, 1024, 1024),
    (16, 2, 1 << 26, 1024, 1024),  # 2^26 points x 16 levels x 2 features = 2^31 elements of g
    (16, 16, 1 << 23, 1024, 1024),  # 2^23 x 16 x 16 = 2^31
    (32, 32, 100, 1 << 18, 1 << 18),  # a gradient of 32 x 2^18 x 256 = 2^31 elements
    (16, 2, 100, 1000, 1000),  # not a power of two
    (16, 2, -1, 1024, 1024),
])
def test_exact_table_gradient_plan_refuses_32_bit_overflow(args):
    with pytest.raises(ValueError):
        tfe.dtable_exact_plan(*args)


def test_exact_table_gradient_plan_limits_are_just_inside():
    tfe.dtable_exact_plan(16, 2, (1 << 26) - 1, 1024, 1024)
    tfe.dtable_exact_plan(32, 32, 100, (1 << 18) - 1, 1 << 18)
    tfe.dtable_exact_plan(16, 16, (1 << 23) - 1, 1024, 1024)
    tfe.dtable_exact_plan(1, 1, 0, 0, 1 << 31)


def test_run_share_of_one_cell_groups():
    """All points in one cell: every lane but the first of each aligned
    32-point group folds into its run's head, and a run never crosses a
    group's boundary (a ragged last group counts its own lanes)."""
    _, tc = _cfgs("fused")
    for n, folded in ((32, 31), (64, 62), (96 + 8, 93 + 7)):
        share = tfe.dtable_run_share(torch.full((3, n), 0.4), tc)
        assert share["levels"] == [folded / n] * tc.n_levels
        assert share["overall"] == pytest.approx(folded / n)
    # two cells alternating within every group: nothing folds
    pts = torch.full((3, 64), 0.4)
    pts[:, 1::2] = 0.9
    assert tfe.dtable_run_share(pts, tc)["overall"] == 0.0


def test_run_share_of_shuffled_and_sorted_points():
    """Points shuffled across the cells of a fine level fold almost never;
    rays of depth-sorted samples fold more than the same points permuted."""
    tc = tfe.FusedHashConfig(n_levels=4, log2_cells=16, base_resolution=64)
    _, pts, _ = _inputs(tc, n=4096, seed=8)
    assert tfe.dtable_run_share(T(pts), tc)["overall"] < 0.01
    _, tc = _cfgs("fused")
    rays = _ray_samples(64, 64, seed=9)
    sorted_share = tfe.dtable_run_share(rays, tc)
    perm = torch.randperm(rays.shape[1], generator=torch.Generator().manual_seed(0))
    permuted = tfe.dtable_run_share(rays[:, perm], tc)
    assert sorted_share["overall"] > permuted["overall"] + 0.2
    assert all(a >= b for a, b in zip(sorted_share["levels"], permuted["levels"]))
    assert sorted_share["levels"][0] >= sorted_share["levels"][-1]


def _dtable64(pts, g, cfg, row0=0, rows=None):
    """The exact table gradient's terms (f32 products, as both versions
    form them) summed in float64, on the CPU."""
    pts, g = pts.cpu(), g.cpu()
    rows = cfg.table_size if rows is None else rows
    d = torch.zeros((cfg.n_levels, rows, cfg.row_width), dtype=torch.float64)
    nf = cfg.n_features
    for lvl, scale in enumerate(cfg.level_scales()):
        upd = tfe._row_updates(pts, g[nf * lvl : nf * lvl + nf], scale).double()
        tfe._scatter_rows(d[lvl], tfe._level_indices(pts, cfg, lvl), upd, row0, cfg.table_size)
    return d


def _check_dtable_on_card(pts, g, cfg, row0=0, rows=None, against_plain=True):
    """The kernel against the float64 sum of the same terms and against the
    plain version, normwise and by the largest error over the largest entry:
    both sum f32 terms by f32 additions in other orders (the kernel a tree
    inside each warp's run, then atomics in a varying order), 1e-5. Where
    one entry sums 10^5 terms the plain version's own f32 sum drifts from
    float64 by more than that: hold the kernel against float64 alone."""
    before = tfe._bwd_dtable_exact.launches
    got = tfe._bwd_dtable_exact(pts, g, cfg, row0, rows)
    torch.cuda.synchronize()
    assert tfe._bwd_dtable_exact.launches == before + 1
    want64 = _dtable64(pts, g, cfg, row0, rows)
    plain = tfe.dtable_exact_ref(pts, g, cfg, row0, rows).cpu()
    got = got.cpu()
    assert got.shape == plain.shape and got.dtype == torch.float32
    scale = float(want64.abs().max())
    for ref in (want64, plain.double()) if against_plain else (want64,):
        assert _rel(got, ref.numpy()) <= 1e-5
        assert float((got.double() - ref).abs().max()) <= 1e-5 * scale
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CFGS))
def test_fused_kernels_match_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, tc = _cfgs(name)
    for seed, n in ((0, 256), (1, 100_003)):
        table, pts, g = (T(a).cuda() for a in _inputs(tc, n=n, seed=seed))
        v_t = tfe._gather_v_t(table.to(torch.bfloat16), pts, tc)
        before = (tfe.interp_fwd.launches, tfe.interp_dpts.launches)
        out = tfe.interp_fwd(pts, v_t, tc)
        torch.testing.assert_close(out, tfe.interp_fwd_ref(pts, v_t, tc), rtol=1e-5, atol=1e-5)
        d = tfe.interp_dpts(pts, v_t, g, tc)
        ref = tfe.dpts_ref(pts, v_t, g, tc)
        torch.testing.assert_close(d, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
        torch.cuda.synchronize()
        assert (tfe.interp_fwd.launches, tfe.interp_dpts.launches) == (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError):
        tfe.interp_fwd(pts, v_t.float(), tc)
    with pytest.raises(ValueError):
        tfe.interp_fwd(pts, v_t.cpu(), tc)
    # the exact table gradient: F of the configuration and 16, N a multiple
    # of 32 and not, rays of sorted samples, a table in two slabs
    for cfg in (tc, tc._replace(n_features=16)):
        for seed, n in ((0, 256), (1, 100_003)):
            _, pts, g = (T(a).cuda() for a in _inputs(cfg, n=n, seed=seed))
            _check_dtable_on_card(pts, g, cfg)
        pts = _ray_samples(781, 128, seed=2).cuda()
        g = torch.randn((cfg.output_dim, pts.shape[1]), generator=torch.Generator().manual_seed(3)).cuda()
        whole = _check_dtable_on_card(pts, g, cfg)
        t = cfg.table_size
        halves = [_check_dtable_on_card(pts, g, cfg, r0, t // 2) for r0 in (0, t // 2)]
        assert torch.count_nonzero(torch.cat(halves, dim=1)) == torch.count_nonzero(whole)
    # the worst case: every point in one cell, one row a level takes every term
    n = 100_003
    pts = torch.full((3, n), 0.37, device="cuda")
    g = torch.rand((tc.output_dim, n), generator=torch.Generator().manual_seed(4)).cuda()
    got = _check_dtable_on_card(pts, g, tc, against_plain=False)
    assert int((got.abs().sum(-1) > 0).sum()) == tc.n_levels
    with pytest.raises(ValueError):
        tfe._bwd_dtable_exact(pts, g.double(), tc)
    with pytest.raises(ValueError):
        tfe._bwd_dtable_exact(pts, g.cpu(), tc)
