"""FusedHash encoder of the PyTorch port (loner_tpu_torch/ops/fused_encoder.py)
against the JAX package, at two small shapes: the 4-level FusedHash of
tests/test_fused_encoder.py (F=2, 2^10 cells, base 4: levels 0-1 dense) and
the triad's fat-row hash level (L=1, F=4, 2^10 cells). Cell ids bit-equal;
the plain forward and point gradient against the jnp references and the
Pallas kernels in TPU interpret mode; the exact and strided table gradients;
the key fallback; the whole autograd encode against ``jax.grad``. The card
tests hold kernels B4/B5 against their plain versions."""
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
