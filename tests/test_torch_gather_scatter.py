"""Row scatter-add and table lookups of the PyTorch port
(loner_tpu_torch/ops/gather_scatter.py) against the Pallas probe kernels of
``scripts/``: ``row_scatter_add`` against ``bench_pallas_scatter._mk`` run in
TPU interpret mode, and each gather, bit for bit, against the jnp expression
of the Pallas body it replaces. Also: the wrappers refuse what the kernels do
not take, a CPU tensor takes the plain version uncounted, and (on a card)
each kernel agrees with its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as tp
from loner_tpu_torch.ops import gather_scatter as gs

# ---------------------------------------------------------------------------
# P1: row scatter-add against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

SCATTER = dict(N=1024, T=128, C=256)  # rows, table rows, rows per grid step
VARIANTS = [(1, "float32"), (2, "float32"), (4, "bfloat16"), (8, "bfloat16")]


@pytest.fixture(scope="module")
def p1():
    """bench_pallas_scatter with its module sizes set small (``_mk`` reads
    them when it traces), and its inputs."""
    mod = tp.load_script("bench_pallas_scatter")
    for k, v in SCATTER.items():
        setattr(mod, k, v)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, SCATTER["T"], SCATTER["N"]).astype(np.int32)
    idx[:2] = (0, SCATTER["T"] - 1)
    upd = rng.standard_normal((SCATTER["N"], 16)).astype(np.float32)
    exact = np.zeros((SCATTER["T"], 16), np.float64)
    np.add.at(exact, idx, upd)
    return mod, idx, upd, exact


@pytest.mark.parametrize("nshadow,acc", VARIANTS)
def test_row_scatter_add_matches_pallas_p1(p1, nshadow, acc):
    """f32 accumulators within 1e-6 of the largest entry (same sums, same
    order). bf16 accumulators within 1e-2 of the largest entry of the f32
    sum, the bound the Pallas kernel itself meets: the two round the running
    bf16 sums at places that need not agree (interpret mode may keep them
    wider between steps)."""
    mod, idx, upd, exact = p1
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(mod._mk(nshadow, getattr(jnp, acc))(jnp.asarray(upd), jnp.asarray(idx)))
    out = gs.row_scatter_add(torch.as_tensor(idx), torch.as_tensor(upd), SCATTER["T"], nshadow,
                             getattr(torch, acc)).numpy()
    scale = np.abs(exact).max()
    if acc == "float32":
        assert np.abs(out - pallas).max() <= 1e-6 * np.abs(pallas).max()
        assert np.abs(out - exact).max() <= 1e-6 * scale
    else:
        assert np.abs(pallas - exact).max() <= 1e-2 * scale
        assert np.abs(out - pallas).max() <= 1e-2 * scale
        assert np.abs(out - exact).max() <= 1e-2 * scale
        assert not np.array_equal(out, exact.astype(np.float32))  # the sums did round to bf16


# ---------------------------------------------------------------------------
# P2-P6: each gather bit-equal to the jnp body of its Pallas kernel
# ---------------------------------------------------------------------------


def _indices(rng, shape, hi):
    ix = rng.integers(0, hi, shape).astype(np.int32)
    ix.reshape(-1)[:2] = (0, hi - 1)  # the first and the last index
    return ix


def _rows_case(kind, t, w, n, rng):
    table = rng.standard_normal((t, w)).astype(np.float32)
    ix = _indices(rng, (n,), t)
    if kind == "row_gather_tala":  # bench_gather.k_tala
        want = jnp.take_along_axis(jnp.asarray(table), jnp.broadcast_to(jnp.asarray(ix)[:, None], (n, w)), axis=0)
        return want, gs.row_gather(torch.as_tensor(table), torch.as_tensor(ix))
    if kind == "row_gather_take":  # bench_gather.k_take
        want = jnp.take(jnp.asarray(table), jnp.asarray(ix), axis=0)
        return want, gs.row_gather(torch.as_tensor(table), torch.as_tensor(ix))
    table_t = np.ascontiguousarray(table.T)  # bench_gather.k_tala_t
    want = jnp.take_along_axis(jnp.asarray(table_t), jnp.broadcast_to(jnp.asarray(ix)[None, :], (w, n)), axis=1)
    return want, gs.col_gather(torch.as_tensor(table_t), torch.as_tensor(ix))


def _two_stage_indices(kind, rng, shape):
    """Uniform draws in [0, R), every index equal (one m a row), or rows whose
    m are all distinct (``arange(C)`` plus random multiples of C below R)."""
    k, rows, cols = shape
    if kind == "two_stage_gather_all_equal":
        return np.full(shape, rows - 1, np.int32)
    if kind == "two_stage_gather_all_distinct":
        return (np.arange(cols) + cols * rng.integers(0, rows // cols, shape)).astype(np.int32)
    return _indices(rng, shape, rows)


def _sublane_inputs(kind, rows, rng):
    """(tab, idx) of a sublane gather: 128 columns, or the column count a
    ``_cols_<n>`` kind names; every index equal for ``_all_equal``; ``tab`` a
    view 4 bytes past a 16-byte boundary for ``_offset_view``."""
    cols = int(kind.split("_cols_")[1].split("_")[0]) if "_cols_" in kind else 128
    tab = rng.standard_normal((rows, cols)).astype(np.float32)
    ix = np.full((rows, cols), rows - 1, np.int32) if "_all_equal" in kind else _indices(rng, (rows, cols), rows)
    t = torch.as_tensor(tab)
    if "_offset_view" in kind:
        t = torch.cat([torch.zeros(1), t.reshape(-1)])[1:].view(rows, cols)
        assert t.data_ptr() % 16 == 4
    return tab, ix, t


def _slab_case(kind, rows, chunks, rng):
    tab = rng.standard_normal((rows, 128)).astype(np.float32)
    if kind == "lane_gather":  # k_lane of bench_honest, bench_dyngather, bench_gather2
        ix = _indices(rng, (rows, 128), 128)
        want = jnp.take_along_axis(jnp.asarray(tab), jnp.asarray(ix), axis=1)
        return want, gs.lane_gather(torch.as_tensor(tab), torch.as_tensor(ix))
    if kind.startswith("sublane_gather"):  # bench_dyngather.k_sub
        tab, ix, t = _sublane_inputs(kind, rows, rng)
        want = jnp.take_along_axis(jnp.asarray(tab), jnp.asarray(ix), axis=0)
        return want, gs.sublane_gather(t, torch.as_tensor(ix))
    ix = _two_stage_indices(kind, rng, (chunks, rows, 128))  # bench_dyngather.k2, chunk by chunk
    outs = []
    for c in range(chunks):
        idx = jnp.asarray(ix[c])
        g = jnp.take_along_axis(jnp.asarray(tab), idx, axis=0)
        outs.append(jnp.take_along_axis(g, idx % 128, axis=1))
    return jnp.stack(outs), gs.two_stage_gather(torch.as_tensor(tab), torch.as_tensor(ix))


ROW_SHAPES = [(256, 8, 1000), (8, 16, 37), (100, 3, 1001)]  # (T, W, N)
SLAB_SHAPES = [(8, 3), (64, 2)]  # (rows, chunks of the two-stage lookup)
# each slab lookup at each shape, and the two-stage lookup's index patterns
# at 128 columns: one m a row, and all m distinct (R >= C)
SLAB_CASES = [(kind, rows, chunks) for kind in ("lane_gather", "sublane_gather", "two_stage_gather")
              for rows, chunks in SLAB_SHAPES] + [("two_stage_gather_all_equal", 8, 3),
                                                  ("two_stage_gather_all_distinct", 256, 2)]
# the sublane gather's edges: rows not a multiple of a block's, other column
# counts (136, 4, 1024, 512), every index equal, and a table view 4 bytes
# off a 16-byte boundary
SLAB_CASES += [("sublane_gather", 4099, 1), ("sublane_gather_cols_136", 64, 1), ("sublane_gather_cols_4", 64, 1),
               ("sublane_gather_all_equal", 512, 1), ("sublane_gather_offset_view", 64, 1),
               ("sublane_gather_cols_1024", 64, 1), ("sublane_gather_cols_512", 1000, 1)]


@pytest.mark.parametrize("t,w,n", ROW_SHAPES)
@pytest.mark.parametrize("kind", ["row_gather_tala", "row_gather_take", "col_gather"])
def test_row_and_col_gathers_equal_pallas_bodies(kind, t, w, n):
    want, got = _rows_case(kind, t, w, n, np.random.default_rng(t + n))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind,rows,chunks", SLAB_CASES)
def test_slab_gathers_equal_pallas_bodies(kind, rows, chunks):
    want, got = _slab_case(kind, rows, chunks, np.random.default_rng(rows))
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# argument checks and dispatch
# ---------------------------------------------------------------------------


WRAPPERS = ["col_gather", "lane_gather", "row_gather", "row_scatter_add", "sublane_gather", "two_stage_gather"]


def _args():
    """Good arguments of each wrapper (CPU tensors)."""
    rng = np.random.default_rng(0)
    tab = torch.as_tensor(rng.standard_normal((8, 128)).astype(np.float32))
    ix = torch.as_tensor(_indices(rng, (8, 128), 8))
    table = torch.as_tensor(rng.standard_normal((16, 8)).astype(np.float32))
    rows_ix = torch.as_tensor(_indices(rng, (20,), 16))
    return {
        "row_scatter_add": (rows_ix, torch.as_tensor(rng.standard_normal((20, 16)).astype(np.float32)), 16),
        "row_gather": (table, rows_ix),
        "col_gather": (table.T.contiguous(), rows_ix),
        "lane_gather": (tab, ix % 8),
        "sublane_gather": (tab, ix),
        "two_stage_gather": (tab, ix[None].repeat(2, 1, 1)),
    }


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_refuse_bad_arguments(name):
    fn, args = getattr(gs, name), _args()[name]
    fn(*args)  # the good arguments pass
    f_pos, i_pos = (1, 0) if name == "row_scatter_add" else (0, 1)

    def with_arg(pos, value):
        return tuple(value if k == pos else a for k, a in enumerate(args))

    bad = [
        with_arg(i_pos, args[i_pos].long()),  # int64 indices
        with_arg(f_pos, args[f_pos].double()),  # f64 values
        with_arg(i_pos, args[i_pos][None]),  # indices of a shape that does not fit
        with_arg(f_pos, args[f_pos].T.contiguous().T),  # not contiguous
        with_arg(f_pos, args[f_pos][None]),  # a 3-d table
    ]
    for a in bad:
        with pytest.raises(ValueError):
            fn(*a)


def test_row_scatter_add_refuses_bad_options():
    idx, upd, t = _args()["row_scatter_add"]
    for kw in (dict(nshadow=0), dict(acc_dtype=torch.float16)):
        with pytest.raises(ValueError):
            gs.row_scatter_add(idx, upd, t, **kw)
    with pytest.raises(ValueError):
        gs.row_scatter_add(idx, upd, 0)


def test_cpu_tensors_take_the_plain_path_uncounted():
    args = _args()
    refs = {"row_scatter_add": gs.row_scatter_add_ref, "row_gather": gs.row_gather_ref,
            "col_gather": gs.col_gather_ref, "lane_gather": gs.lane_gather_ref,
            "sublane_gather": gs.sublane_gather_ref, "two_stage_gather": gs.two_stage_gather_ref}
    for name, a in args.items():
        fn = getattr(gs, name)
        before = fn.launches
        assert torch.equal(fn(*a), refs[name](*a))
        assert fn.launches == before


def test_plain_versions_raise_on_an_index_out_of_range():
    tab = torch.zeros((8, 128))
    ix = torch.zeros((8, 128), dtype=torch.int32)
    ix[3, 5] = 128
    with pytest.raises(RuntimeError):
        gs.lane_gather(tab, ix)
    with pytest.raises(RuntimeError):
        gs.sublane_gather(tab, ix)


def _offset_views(device="cpu"):
    """(T, W) = (64, 8) views of one buffer at offsets of 0 and 1 floats."""
    buf = torch.arange(64 * 8 + 4, dtype=torch.float32, device=device)
    return buf[:64 * 8].view(64, 8), buf[1:1 + 64 * 8].view(64, 8)


def test_row_gather_moves_float4s_only_from_an_aligned_table():
    aligned, shifted = _offset_views()
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 4
    assert gs.float4_rows(aligned)
    assert not gs.float4_rows(shifted)  # a view 4 bytes in takes the float path
    assert not gs.float4_rows(torch.zeros((64, 6)))  # rows of 6 floats
    idx = torch.as_tensor(_indices(np.random.default_rng(1), (50,), 64))
    assert torch.equal(gs.row_gather(shifted, idx), shifted[idx.long()])


# ---------------------------------------------------------------------------
# row_scatter_add's kernel paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_row_scatter_add_plan_takes_vector_atomics_on_whole_float4s(w):
    buf = torch.zeros(64 * w + 4)
    aligned, shifted = buf[:64 * w].view(64, w), buf[1:1 + 64 * w].view(64, w)
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 4
    assert gs.row_scatter_add_plan(w, aligned.data_ptr() % 16 == 0) == "vector"
    assert gs.row_scatter_add_plan(w, shifted.data_ptr() % 16 == 0) == "scalar"  # a view 4 bytes off


@pytest.mark.parametrize("w", [1, 3, 6, 17])
def test_row_scatter_add_plan_takes_scalar_atomics_otherwise(w):
    assert gs.row_scatter_add_plan(w, True) == "scalar"


# W = 16 (the probe), 8, 3 (scalar path), 32; N = 1; an update view 4 bytes
# off a 16-byte boundary
SCATTER_EDGES = [(16, 1000, 0), (8, 1000, 0), (3, 1000, 0), (32, 1000, 0), (16, 1, 0), (16, 1000, 1)]


def _scatter_edge(w, n, offset, rng, t=64, device="cpu", normal=False):
    """(idx, upd, exact sum): small-integer updates, whose partial sums are
    exact in bf16 while an entry takes at most 12 rows (or normal draws and
    their float64 sum), as a view ``offset`` floats into its buffer."""
    idx = _indices(rng, (n,), t) if n > 1 else np.array([t - 1], np.int32)
    upd = (rng.standard_normal((n, w)) if normal else rng.integers(-4, 5, (n, w))).astype(np.float32)
    exact = np.zeros((t, w), np.float64 if normal else np.float32)
    np.add.at(exact, idx, upd)
    buf = torch.zeros(n * w + offset, device=device)
    buf[offset:] = torch.as_tensor(upd).reshape(-1)
    return (torch.as_tensor(idx).to(device), buf[offset:].view(n, w), torch.as_tensor(exact).to(device))


@pytest.mark.parametrize("w,n,offset", SCATTER_EDGES)
@pytest.mark.parametrize("nshadow,acc", VARIANTS)
def test_row_scatter_add_edge_shapes_give_exact_sums(w, n, offset, nshadow, acc):
    idx, upd, exact = _scatter_edge(w, n, offset, np.random.default_rng(w + n + offset))
    out = gs.row_scatter_add(idx, upd, exact.shape[0], nshadow, getattr(torch, acc))
    assert torch.equal(out, exact)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_gather_scatter_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    cases = []
    for t, w, n in ROW_SHAPES + [(1000, 3, 100_003)]:
        table = torch.as_tensor(rng.standard_normal((t, w)).astype(np.float32)).cuda()
        ix = torch.as_tensor(_indices(rng, (n,), t)).cuda()
        cases += [(gs.row_gather, gs.row_gather_ref, (table, ix)),
                  (gs.col_gather, gs.col_gather_ref, (table.T.contiguous(), ix))]
    # col_gather's edges: W = 1, 3, 8 and 300 (bands of 32 columns, the
    # last of 12); N a multiple of 4 (float4 stores) or not, under one
    # block of 256 points; T off the transpose's 32-row tile
    for t, w, n in [(77, 1, 1000), (77, 1, 5), (1000, 3, 64), (4099, 8, 4099), (4099, 8, 200), (45, 300, 1003),
                    (45, 300, 512)]:
        table_t = torch.as_tensor(rng.standard_normal((w, t)).astype(np.float32)).cuda()
        cases.append((gs.col_gather, gs.col_gather_ref, (table_t, torch.as_tensor(_indices(rng, (n,), t)).cuda())))
    for rows, chunks in SLAB_SHAPES + [(4096, 5)]:
        tab = torch.as_tensor(rng.standard_normal((rows, 128)).astype(np.float32)).cuda()
        ix = torch.as_tensor(_indices(rng, (chunks, rows, 128), rows)).cuda()
        cases += [(gs.lane_gather, gs.lane_gather_ref, (tab, ix[0] % 128)),
                  (gs.sublane_gather, gs.sublane_gather_ref, (tab, ix[0].contiguous())),
                  (gs.two_stage_gather, gs.two_stage_gather_ref, (tab, ix))]
    # two_stage_gather's edges: C = 128, 1, 37 and 150 (scalar paths),
    # 1000 (above the block's 256 threads) and 2500 (three pieces of 1024
    # columns); K = 1 and 36; uniform, all-equal and all-distinct m (R >= C);
    # an index view 4 bytes off a 16-byte boundary (scalar path at C = 128)
    for k, r, c in [(36, 256, 128), (1, 128, 128), (2, 50, 1), (3, 40, 37), (2, 150, 150), (2, 1000, 1000),
                    (1, 2500, 2500)]:
        tab = torch.as_tensor(rng.standard_normal((r, c)).astype(np.float32)).cuda()
        for kind in ("two_stage_gather", "two_stage_gather_all_equal", "two_stage_gather_all_distinct"):
            ix = torch.as_tensor(_two_stage_indices(kind, rng, (k, r, c))).cuda()
            cases.append((gs.two_stage_gather, gs.two_stage_gather_ref, (tab, ix)))
    # sublane_gather at the probe's slabs and on the edges: rows not a
    # multiple of a block's, 136 and 4 columns, 8192 rows; each on uniform
    # and all-equal indices and on a table view 4 bytes off a 16-byte boundary
    for rows, cols in [(8, 128), (512, 128), (4096, 128), (4099, 128), (512, 136), (512, 4), (8192, 128)]:
        for kind in ("sublane_gather", "sublane_gather_all_equal", "sublane_gather_offset_view"):
            _, ix, tab = _sublane_inputs(f"{kind}_cols_{cols}", rows, rng)
            tab, ix = tab.cuda(), torch.as_tensor(ix).cuda()
            if kind.endswith("_offset_view"):
                tab = torch.cat([torch.zeros(1, device="cuda"), tab.reshape(-1)])[1:].view(rows, cols)
            assert torch.equal(gs.sublane_gather(tab, ix), torch.gather(tab, 0, ix.long())), (rows, cols, kind)
            cases.append((gs.sublane_gather, gs.sublane_gather_ref, (tab, ix)))
    tab = torch.as_tensor(rng.standard_normal((64, 128)).astype(np.float32)).cuda()
    buf = torch.as_tensor(_indices(rng, (2 * 64 * 128 + 1,), 64)).cuda()
    cases.append((gs.two_stage_gather, gs.two_stage_gather_ref, (tab, buf[1:].view(2, 64, 128))))
    ix = torch.as_tensor(_indices(rng, (1000,), 64)).cuda()
    cases += [(gs.row_gather, gs.row_gather_ref, (view, ix)) for view in _offset_views("cuda")]
    for fn, ref, a in cases:
        before = fn.launches
        assert torch.equal(fn(*a), ref(*a)), fn.__name__
        assert fn.launches == before + 1
    # Updates whose every partial sum is exact in bf16 (small integers, 12
    # rows an entry, sums below 2^8): any order of the atomics gives the
    # exact sum, so every variant equals its plain version bit for bit.
    t, k = 4096, 12
    idx = torch.as_tensor(rng.permutation(np.repeat(np.arange(t, dtype=np.int32), k))).cuda()
    upd = torch.as_tensor(rng.integers(-4, 5, (t * k, 16)).astype(np.float32)).cuda()
    exact = torch.zeros((t, 16), device="cuda").index_add_(0, idx.long(), upd)
    for nshadow, acc in VARIANTS:
        before = gs.row_scatter_add.launches
        out = gs.row_scatter_add(idx, upd, t, nshadow, getattr(torch, acc))
        assert gs.row_scatter_add.launches == before + 1
        assert torch.equal(out, gs.row_scatter_add_ref(idx, upd, t, nshadow, getattr(torch, acc)))
        assert torch.equal(out, exact)
    # the edges (vector and scalar paths, W = 16, 8, 3, 32, N = 1, an update
    # view 4 bytes off): exact sums, 4096 rows into 512 (8 an entry)
    for w, n, offset in SCATTER_EDGES:
        eidx, eupd, eexact = _scatter_edge(w, 4096 if n > 1 else 1, offset, rng, 512, "cuda")
        for nshadow, acc in VARIANTS:
            out = gs.row_scatter_add(eidx, eupd, 512, nshadow, getattr(torch, acc))
            assert torch.equal(out, gs.row_scatter_add_ref(eidx, eupd, 512, nshadow, getattr(torch, acc)))
            assert torch.equal(out, eexact)
            assert torch.equal(out, torch.zeros_like(out).index_add_(0, eidx.long(), eupd)), (w, n, offset, nshadow)
    # Normal draws at the probe's shapes (4 rows an entry): the atomics add
    # in a varying order. f32 within 1e-6 of the largest entry of its plain
    # version and of the exact sum; bf16, whose running sums round, within
    # 1e-2 of it of the exact sum (1e-2 is about two bf16 ulps of the
    # largest entry, so two orders can differ from each other by more).
    t, n = 65536, 262144
    idx = torch.as_tensor(_indices(rng, (n,), t)).cuda()
    upd = torch.as_tensor(rng.standard_normal((n, 16)).astype(np.float32)).cuda()
    exact = torch.zeros((t, 16), dtype=torch.float64, device="cuda").index_add_(0, idx.long(), upd.double())
    normal = [(idx, upd, exact, t)]
    for w, offset in [(8, 0), (3, 0), (32, 0), (16, 1)]:  # the edges on normal draws, 4 rows an entry
        normal.append((*_scatter_edge(w, 16384, offset, rng, 4096, "cuda", normal=True), 4096))
    for idx, upd, exact, t in normal:
        scale = float(exact.abs().max())
        for nshadow, acc in VARIANTS:
            out = gs.row_scatter_add(idx, upd, t, nshadow, getattr(torch, acc))
            if acc == "float32":
                ref = gs.row_scatter_add_ref(idx, upd, t, nshadow, torch.float32)
                assert float((out - ref).abs().max()) <= 1e-6 * scale
            assert float((out.double() - exact).abs().max()) <= (1e-6 if acc == "float32" else 1e-2) * scale
    torch.cuda.synchronize()
