"""The three alternate hash encoders of the PyTorch port against the JAX
package: the exact hash grid (loner_tpu_torch/models/hash_encoding.py), the
bf16 pair-packed one (ops/hash_encode_fast.py) and CellHash
(ops/cell_hash.py), on the same numpy-seeded tables and points.

Held: corner indices and cell rows bit-equal (dense and hashed levels, the
finest level of the flagship config, points at 0 and 1), CellHash's jitter
level choice bit-equal, the forward within 1e-6 of its largest entry, the
table and point gradients within 1e-5 of their largest entry, and the
corner-sampled backward from JAX's own uniforms with the (level, point)
pairs whose uniform ties the corner CDF (``corner_ties``) left out. Then the
JAX package's own checks of these encoders (tests/test_hash_fast.py,
tests/test_cell_hash.py), drawn from torch generators, and one card test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.models import hash_encoding as jhe
from loner_tpu.ops import cell_hash as jch
from loner_tpu.ops import hash_encode_fast as jhf
from loner_tpu_torch.models import hash_encoding as the
from loner_tpu_torch.ops import cell_hash as tch
from loner_tpu_torch.ops import hash_encode_fast as thf

from torch_parity import two_threads  # noqa: F401

T = torch.as_tensor
# 6 levels from 16: level 0 dense (16^3 = 2^12), 1-5 hashed
HASH = dict(n_levels=6, log2_hashmap_size=12)
# CellHash of the JAX tests: 4 levels from base 4, 2^10 cells (0-1 dense)
CELL = dict(n_levels=4, log2_cells=10, base_resolution=4)


def _points(n: int, seed: int) -> np.ndarray:
    """(3, n) points in [0, 1] with the cube's faces (0 and 1) and a point an
    ulp under 1."""
    pts = np.random.default_rng(seed).uniform(0.0, 1.0, (3, n)).astype(np.float32)
    pts[:, 0], pts[:, 1] = 0.0, 1.0
    pts[0, 2], pts[1, 3], pts[2, 4] = 0.0, 1.0, np.float32(1.0 - 2**-24)
    return pts


def _table(shape, seed: int) -> np.ndarray:
    """O(1) table values (the JAX tests' 1e4 x init), so bf16 errors are relative."""
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(np.float32)


def _jax_grads(fn, table, pts, g):
    out, vjp = jax.vjp(fn, jnp.asarray(table), jnp.asarray(pts))
    d_table, d_pts = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(d_table), np.asarray(d_pts)


def _torch_grads(fn, table, pts, g):
    tt, pt = T(table).clone().requires_grad_(True), T(pts).clone().requires_grad_(True)
    out = fn(tt, pt)
    torch.sum(out * T(g)).backward()
    return out.detach().numpy(), tt.grad.numpy(), pt.grad.numpy()


def _close(a, b, share: float, what: str):
    """a within ``share`` of b's largest entry."""
    scale = float(np.abs(b).max())
    assert scale > 0, what
    err = float(np.abs(a - b).max())
    assert err <= share * scale, f"{what}: max abs err {err:.3e} of {scale:.3e}"


def corner_ties(w: np.ndarray, u: np.ndarray, tol: float = 1e-6) -> np.ndarray:
    """(L, N) bool: the (level, point) pairs whose corner draw ``u > cumsum(w)``
    turns on a uniform within ``tol`` of the CDF (w (L, 8, N), u (L, N)),
    where the two packages' sums, in other orders, may pick corners an ulp
    apart. Elsewhere the corner choice must agree."""
    cdf = np.cumsum(np.asarray(w, np.float64), axis=1)
    return np.any(np.abs(cdf - np.asarray(u, np.float64)[:, None, :]) <= tol, axis=1)


def _cotangent(n_levels: int, n: int, seed: int, ties=None, level1: bool = False) -> np.ndarray:
    """(L*2, N) cotangent, zero on tied (level, point) pairs (under level1:
    on every level of a point whose chosen level ties)."""
    g = np.random.default_rng(seed).standard_normal((n_levels, 2, n)).astype(np.float32)
    if ties is not None:
        tied = np.broadcast_to(ties[:1] if level1 else ties, (n_levels, n))
        g[np.broadcast_to(tied[:, None, :], g.shape)] = 0.0
    return g.reshape(2 * n_levels, n)


# ---------------------------------------------------------------------------
# indices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("enc", [dict(HASH), {}], ids=["6_levels", "flagship_sigma"])
def test_corner_indices_bit_equal(enc):
    """Every level's corner indices (exact encoder), level-fused indices
    (packed) and cell rows (CellHash at the same capacity), dense and hashed,
    up to the flagship's finest level (resolution 2^19)."""
    jcfg, tcfg = jhe.HashEncodingConfig(**enc), the.HashEncodingConfig(**enc)
    assert jcfg == tuple(tcfg)
    dense = tcfg.level_is_dense()
    assert dense.any() and not dense.all()
    pts = _points(512, 0)
    for lvl in range(tcfg.n_levels):
        s, res = tcfg.level_scales()[lvl], int(tcfg.level_resolutions()[lvl])
        jcells = jnp.floor(jnp.asarray(pts) * jnp.float32(s) + 0.5).astype(jnp.int32)
        jidx = np.asarray(jhe._corner_indices_t(jcells, res, bool(dense[lvl]), tcfg.table_size))
        tcells, _ = the._level_cells(T(pts), s)
        np.testing.assert_array_equal(np.asarray(jcells), tcells.numpy(), err_msg=f"cells, level {lvl}")
        tidx = the._corner_indices_t(tcells, res, bool(dense[lvl]), tcfg.table_size).numpy()
        np.testing.assert_array_equal(tidx, jidx, err_msg=f"level {lvl}")
    jf, jw = jhf._fused_indices(jnp.asarray(pts), jcfg)
    tf, tw = thf._fused_indices(T(pts), tcfg)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-7)

    ccfg = dict(n_levels=tcfg.n_levels, log2_cells=tcfg.log2_hashmap_size - 2)
    jc, tc = jch.CellHashConfig(**ccfg), tch.CellHashConfig(**ccfg)
    assert not tc.level_is_dense().all() and (tc.level_is_dense().any() or enc)  # the flagship's: 2 dense
    for lvl in range(tc.n_levels):
        s, res = tc.level_scales()[lvl], int(tc.level_resolutions()[lvl])
        jcells, _ = jch._cell_and_frac(jnp.asarray(pts), float(s), res)
        jrows = np.asarray(jch._cell_ids(jcells, res, bool(tc.level_is_dense()[lvl]), tc.table_size))
        tcells, _ = tch._cell_and_frac(T(pts), s, res)
        trows = tch._cell_ids(tcells, res, bool(tc.level_is_dense()[lvl]), tc.table_size).numpy()
        np.testing.assert_array_equal(trows, jrows, err_msg=f"cell rows, level {lvl}")
    np.testing.assert_array_equal(tch._level_rows(T(pts), tc).numpy(), np.stack(
        [np.asarray(jch._cell_ids(jch._cell_and_frac(jnp.asarray(pts), float(s), int(r))[0], int(r), bool(d),
                                  jc.table_size))
         for s, r, d in zip(jc.level_scales(), jc.level_resolutions(), jc.level_is_dense())]))


@pytest.mark.parametrize("n_levels", [4, 16, 5])
def test_jitter_level_choice_bit_equal(n_levels):
    pts = _points(4096, 1)
    pts[:, 5:9] = np.float32(0.5)  # equal coordinates: the same bits
    np.testing.assert_array_equal(tch._jitter_level_choice(T(pts), n_levels).numpy(),
                                  np.asarray(jch._jitter_level_choice(jnp.asarray(pts), n_levels)))


# ---------------------------------------------------------------------------
# forward and gradients against JAX
# ---------------------------------------------------------------------------


def _encoders():
    """name -> (table shape, jax encode(table, pts), torch encode(table, pts))."""
    jcfg, tcfg = jhe.HashEncodingConfig(**HASH), the.HashEncodingConfig(**HASH)
    hshape = (tcfg.n_levels, 2, tcfg.table_size)
    enc = {
        "exact": (hshape, lambda t, p: jhe.hash_encode_t(t, p, jcfg), lambda t, p: the.hash_encode_t(t, p, tcfg)),
        "packed": (hshape, lambda t, p: jhf.hash_encode_packed_t(t, p, jcfg, None),
                   lambda t, p: thf.hash_encode_packed_t(t, p, tcfg, None)),
    }
    for bwd in ("exact", "level1"):
        jc, tc = jch.CellHashConfig(**CELL, bwd=bwd), tch.CellHashConfig(**CELL, bwd=bwd)
        enc[f"cell_{bwd}"] = ((tc.n_levels, tc.table_size, 16),
                              lambda t, p, jc=jc: jch.cell_hash_encode_t(t, p, jc),
                              lambda t, p, tc=tc: tch.cell_hash_encode_t(t, p, tc))
    return enc


@pytest.mark.parametrize("name", ["exact", "packed", "cell_exact", "cell_level1"])
def test_encoder_matches_jax(name):
    """The forward within 1e-6 and both gradients within 1e-5 of their
    largest entry."""
    shape, jfn, tfn = _encoders()[name]
    table, pts = _table(shape, 2), _points(1027, 3)
    g = np.random.default_rng(4).standard_normal((2 * shape[0], pts.shape[1])).astype(np.float32)
    jout, jdt, jdp = _jax_grads(jfn, table, pts, g)
    tout, tdt, tdp = _torch_grads(tfn, table, pts, g)
    _close(tout, jout, 1e-6, "forward")
    _close(tdt, jdt, 1e-5, "d_table")
    _close(tdp, jdp, 1e-5, "d_pts")
    assert np.array_equal(tdt != 0, jdt != 0)


def _sampled_case(name):
    """(table shape, jax encode(t, p, key), torch encode(t, p, u), the
    weights (L, 8, N) the corner draw reads from a point set, level1?)."""
    if name == "packed":
        jcfg, tcfg = jhe.HashEncodingConfig(**HASH), the.HashEncodingConfig(**HASH)
        return ((tcfg.n_levels, 2, tcfg.table_size), lambda t, p, k: jhf.hash_encode_packed_t(t, p, jcfg, k),
                lambda t, p, u: thf.hash_encode_packed_t(t, p, tcfg, u=u),
                lambda pts: thf._fused_indices(T(pts), tcfg)[1].numpy(), False)
    bwd = name.split("_", 1)[1]
    jc, tc = jch.CellHashConfig(**CELL, bwd=bwd), tch.CellHashConfig(**CELL, bwd=bwd)

    def weights(pts):
        if bwd == "level1":
            choice = tch._jitter_level_choice(T(pts), tc.n_levels)
            scale = T(tc.level_scales().astype(np.float32))[choice]
            scaled = T(pts) * scale[None] + 0.5
            return tch._trilinear_w(scaled - torch.floor(scaled)).numpy()[None]
        return np.stack([tch._trilinear_w(tch._cell_and_frac(T(pts), s, int(r))[1]).numpy()
                         for s, r in zip(tc.level_scales(), tc.level_resolutions())])

    return ((tc.n_levels, tc.table_size, 16), lambda t, p, k: jch.cell_hash_encode_t(t, p, jc, k),
            lambda t, p, u: tch.cell_hash_encode_t(t, p, tc, u=u), weights, bwd == "level1")


@pytest.mark.parametrize("name", ["packed", "cell_exact", "cell_level1"])
def test_corner_sampled_backward_matches_jax(name):
    """JAX draws uniform(key, (L, N)) inside its backward; the port is handed
    those uniforms. The (level, point) pairs whose uniform ties the corner
    CDF (for level1: the points whose chosen level's does) get a zero
    cotangent on both sides; everything else is held as the exact backward."""
    shape, jfn, tfn, weights, level1 = _sampled_case(name)
    table, pts = _table(shape, 5), _points(1031, 6)
    n_levels, n = shape[0], pts.shape[1]
    key = jax.random.PRNGKey(17)
    u = np.array(jax.random.uniform(key, (n_levels, n)))
    ties = corner_ties(weights(pts), u[:1] if level1 else u)
    g = _cotangent(n_levels, n, 7, ties, level1)
    print(f"{name}: {int(ties.sum())} tied (level, point) pairs of {ties.size}")
    jout, jdt, jdp = _jax_grads(lambda t, p: jfn(t, p, key), table, pts, g)
    tout, tdt, tdp = _torch_grads(lambda t, p: tfn(t, p, T(u)), table, pts, g)
    _close(tout, jout, 1e-6, "forward")
    _close(tdt, jdt, 1e-5, "d_table")
    _close(tdp, jdp, 1e-5, "d_pts")
    assert np.array_equal(tdt != 0, jdt != 0)
    # the same key's draws from a torch generator: the same forward, another
    # corner choice in the table gradient
    tt = T(table).clone().requires_grad_(True)
    k = torch.tensor([3, 4])
    if name == "packed":
        out = thf.hash_encode_packed_t(tt, T(pts), the.HashEncodingConfig(**HASH), k)
    else:
        out = tch.cell_hash_encode_t(tt, T(pts), tch.CellHashConfig(**CELL, bwd=name.split("_", 1)[1]), k)
    torch.sum(out * T(g)).backward()
    np.testing.assert_array_equal(out.detach().numpy(), tout)
    assert np.isfinite(tt.grad.numpy()).all() and not np.array_equal(tt.grad.numpy(), tdt)


def test_key_draws_repeat_per_call():
    """Without ``u`` the uniforms come from a generator seeded from the key
    words in each call: two calls (two equal point chunks) draw the same."""
    a = thf.uniforms_from_key(torch.tensor([5, 2**32 - 1]), (4, 100), "cpu")
    b = thf.uniforms_from_key(torch.tensor([5, 2**32 - 1]), (4, 100), "cpu")
    c = thf.uniforms_from_key(torch.tensor([6, 2**32 - 1]), (4, 100), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


def test_init_tables():
    g = torch.Generator().manual_seed(0)
    h = the.init_hash_table(g, the.HashEncodingConfig(**HASH), device="cpu")
    c = tch.init_cell_table(g, tch.CellHashConfig(**CELL), device="cpu")
    assert h.shape == (6, 2, 4096) and c.shape == (4, 1024, 16)
    for t in (h, c):
        assert t.dtype == torch.float32 and float(t.abs().max()) <= 1e-4 and float(t.std()) > 5e-5
    pts = T(_points(64, 8))
    np.testing.assert_allclose(the.hash_encode(h, pts.T, the.HashEncodingConfig(**HASH)).numpy(),
                               the.hash_encode_t(h, pts, the.HashEncodingConfig(**HASH)).T.numpy())


# ---------------------------------------------------------------------------
# the JAX package's own checks (tests/test_hash_fast.py, tests/test_cell_hash.py)
# ---------------------------------------------------------------------------


def _unbiased(encode, table, pts, trials=64):
    """Median over the table entries with a gradient over 5% of the largest
    of |mean of ``trials`` sampled gradients - exact| / largest."""
    def grad(k):
        t = T(table).clone().requires_grad_(True)
        torch.sum(encode(t, T(pts), k) ** 2).backward()
        return t.grad.numpy().astype(np.float64)

    exact = grad(None)
    gen = torch.Generator().manual_seed(0)
    mean = sum(grad(torch.randint(0, 2**32, (2,), generator=gen)) for _ in range(trials)) / trials
    denom = np.abs(exact).max() + 1e-9
    mask = np.abs(exact) > denom * 0.05
    return float(np.median(np.abs(mean[mask] - exact[mask]) / denom))


def test_packed_forward_unchanged_by_key():
    cfg = the.HashEncodingConfig(**HASH)
    table, pts = T(_table((6, 2, 4096), 9)), T(_points(513, 10))
    assert torch.equal(thf.hash_encode_packed_t(table, pts, cfg), thf.hash_encode_packed_t(table, pts, cfg,
                                                                                          torch.tensor([3, 0])))


def test_packed_table_grad_unbiased():
    cfg = the.HashEncodingConfig(**HASH)
    err = _unbiased(lambda t, p, k: thf.hash_encode_packed_t(t, p, cfg, k), _table((6, 2, 4096), 11),
                    _points(513, 12))
    assert err < 0.15, err


def _cell_setup():
    cfg = tch.CellHashConfig(n_levels=4, log2_cells=10)
    return cfg, T(_table((4, 1024, 16), 13)), T(_points(257, 14))


def test_cell_vertex_weights():
    """At a cell's min corner (frac 0) a level's output is corner 0's features."""
    cfg, table, _ = _cell_setup()
    s = float(cfg.level_scales()[0])
    p = torch.full((3, 1), 1.5 / s)
    out = tch.cell_hash_encode_t(table, p, cfg)
    cells, frac = tch._cell_and_frac(p, s, int(cfg.level_resolutions()[0]))
    np.testing.assert_allclose(frac.numpy(), 0.0, atol=1e-5)
    idx = int(tch._cell_ids(cells, int(cfg.level_resolutions()[0]), bool(cfg.level_is_dense()[0]),
                            cfg.table_size)[0])
    np.testing.assert_allclose(out[0:2, 0].numpy(), table[0, idx, 0:2].numpy(), atol=2e-2, rtol=2e-2)


def test_cell_continuity_within_cell():
    cfg, table, _ = _cell_setup()
    p = torch.tensor([[0.4031], [0.5017], [0.6013]])
    a, b = tch.cell_hash_encode_t(table, p, cfg), tch.cell_hash_encode_t(table, p + 1e-6, cfg)
    assert float((a - b).abs().max()) < 1e-2


def test_cell_gradients_match_numerical():
    cfg, table, pts = _cell_setup()
    p1 = pts[:, 10:27]

    def loss(t, p):
        return float(torch.sum(torch.sin(tch.cell_hash_encode_t(t, p, cfg))))

    t = table.clone().requires_grad_(True)
    torch.sum(torch.sin(tch.cell_hash_encode_t(t, p1, cfg))).backward()
    g = t.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    eps = 1e-2
    for lv, ti, fi in np.argwhere(np.abs(g) > 1e-4)[:5]:
        tp_, tm = table.clone(), table.clone()
        tp_[lv, ti, fi] += eps
        tm[lv, ti, fi] -= eps
        num = (loss(tp_, p1) - loss(tm, p1)) / (2 * eps)
        assert abs(num - g[lv, ti, fi]) < 0.15 * max(abs(num), 1.0), (num, g[lv, ti, fi])
    p9 = pts[:, 10:19].clone().requires_grad_(True)
    torch.sum(torch.sin(tch.cell_hash_encode_t(table, p9, cfg))).backward()
    eps = 1e-4
    for a in range(3):
        pp, pm = p9.detach().clone(), p9.detach().clone()
        pp[a, 3] += eps
        pm[a, 3] -= eps
        num = (loss(table, pp) - loss(table, pm)) / (2 * eps)
        assert abs(num - float(p9.grad[a, 3])) < 0.25 * max(abs(num), 2.0), (a, num, float(p9.grad[a, 3]))


def test_cell_corner_scatter_unbiased():
    cfg, table, pts = _cell_setup()
    err = _unbiased(lambda t, p, k: tch.cell_hash_encode_t(t, p, cfg, k), table.numpy(), pts.numpy())
    assert err < 0.15, err


def test_cell_level1_table_grad_unbiased():
    """Averaged over coordinate jitter, the level1 table gradient matches the
    exact one."""
    c_exact = tch.CellHashConfig(**CELL)
    c_l1 = c_exact._replace(bwd="level1")
    gen = torch.Generator().manual_seed(0)
    table = tch.init_cell_table(gen, c_exact, device="cpu")
    w_out = torch.randn((c_exact.output_dim, 1), generator=gen)
    base = torch.rand((3, 512), generator=gen) * 0.9 + 0.05

    def grad(cfg, pts):
        t = table.clone().requires_grad_(True)
        torch.sum(tch.cell_hash_encode_t(t, pts, cfg) * w_out).backward()
        return t.grad.double()

    acc_exact = torch.zeros(table.shape, dtype=torch.float64)
    acc_l1 = torch.zeros(table.shape, dtype=torch.float64)
    for _ in range(64):
        pts = base + torch.rand(base.shape, generator=gen) * 1e-3
        acc_exact += grad(c_exact, pts)
        acc_l1 += grad(c_l1, pts)
    assert float((acc_l1 - acc_exact).abs().mean() / acc_exact.abs().mean()) < 0.35


def test_cell_level1_point_grad_identical():
    c_exact = tch.CellHashConfig(**CELL)
    gen = torch.Generator().manual_seed(1)
    table = tch.init_cell_table(gen, c_exact, device="cpu")
    pts = torch.rand((3, 64), generator=gen) * 0.8 + 0.1

    def gp(cfg):
        p = pts.clone().requires_grad_(True)
        torch.sum(torch.sin(tch.cell_hash_encode_t(table, p, cfg))).backward()
        return p.grad

    torch.testing.assert_close(gp(c_exact._replace(bwd="level1")), gp(c_exact), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["exact", "packed", "packed_corner", "cell_exact", "cell_level1",
                                  "cell_level1_corner"])
def test_encoder_on_card_matches_cpu(name):
    """Each encoder and backward mode on the card against the CPU on the same
    table, points, cotangent and uniforms: the forward and the point
    gradient within 1e-6 and 1e-5 of their largest entry, the table
    gradient (summed by atomics on the card, in a varying order) within
    1e-5 normwise, tied corners left out as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    base = name.removesuffix("_corner")
    corner = name.endswith("_corner")
    if corner:
        shape, _, tfn, weights, level1 = _sampled_case(base)
    else:
        shape, _, fn = _encoders()[base]
        tfn, level1 = (lambda t, p, u: fn(t, p)), False
    table, pts = _table(shape, 15), _points(100_003, 16)
    n_levels, n = shape[0], pts.shape[1]
    u = np.random.default_rng(17).uniform(size=(n_levels, n)).astype(np.float32)
    ties = corner_ties(weights(pts), u[:1] if level1 else u) if corner else None
    g = _cotangent(n_levels, n, 18, ties, level1)
    res = {}
    for dev in ("cpu", "cuda"):
        tt = T(table).to(dev).requires_grad_(True)
        pt = T(pts).to(dev).requires_grad_(True)
        out = tfn(tt, pt, T(u).to(dev) if corner else None)
        torch.sum(out * T(g).to(dev)).backward()
        res[dev] = [x.detach().cpu().numpy() for x in (out, tt.grad, pt.grad)]
    (oc, dtc, dpc), (og, dtg, dpg) = res["cpu"], res["cuda"]
    _close(og, oc, 1e-6, "forward")
    assert np.linalg.norm(dtg - dtc) <= 1e-5 * np.linalg.norm(dtc), "d_table"
    _close(dpg, dpc, 1e-5, "d_pts")

