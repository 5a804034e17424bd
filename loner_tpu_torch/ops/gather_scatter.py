"""Row scatter-add and table lookups: the kernels of the memory probes P1-P6.

The port of the Pallas kernels in ``scripts/`` (CUDA source in
``csrc/gather_scatter.cu``):

* :func:`row_scatter_add` replaces ``bench_pallas_scatter.py``'s ``kernel``
  in ``_mk`` (P1);
* :func:`row_gather` replaces ``bench_gather.py``'s ``k_tala`` and ``k_take``
  (P2a, P2c: one function), :func:`col_gather` its ``k_tala_t`` (P2b);
* :func:`lane_gather` replaces ``k_lane`` of ``bench_honest.py`` (P3),
  ``bench_dyngather.py`` (P4b) and ``bench_gather2.py`` (P6);
  :func:`sublane_gather` replaces ``bench_dyngather.py``'s ``k_sub`` (P4a) and
  :func:`two_stage_gather` its ``k2`` (P4c).

Each wrapper checks every argument (type, shape, contiguity, one device) on
either device, then takes its plain version (``*_ref``) for a CPU tensor and
launches its kernel for a CUDA tensor; ``launches`` counts the calls that
launched. Indices are int32, as the kernels take them; the plain versions
widen them to int64 for torch. The kernels do not check that an index is in
range (the probes draw them in range); the plain versions raise on one. The
kernels compute offsets in 32 bits and refuse (RuntimeError) a tensor of
2^31 elements or more. :func:`row_scatter_add` picks its kernel's path
with :func:`row_scatter_add_plan`, which the C entry checks again.
"""
from __future__ import annotations

import torch

from loner_tpu_torch.ops import kernels

_ACC_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def row_scatter_add_ref(idx: torch.Tensor, upd: torch.Tensor, n_rows: int, nshadow: int = 1,
                        acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(n_rows, W) f32: the sum of the rows of ``upd`` (N, W) that share an
    index in ``idx`` (N,). Row i goes into shadow copy ``i % nshadow``; each
    copy adds its rows in order in ``acc_dtype`` (the update cast to it
    first); the copies are summed in order in ``acc_dtype`` and cast to f32."""
    ix = idx.long()
    acc = torch.zeros((nshadow, n_rows, upd.shape[1]), dtype=acc_dtype, device=upd.device)
    for s in range(nshadow):
        # index_put_ accumulates row by row, rounding each sum to acc_dtype
        acc[s].index_put_((ix[s::nshadow],), upd[s::nshadow].to(acc_dtype), accumulate=True)
    total = acc[0]
    for s in range(1, nshadow):
        total = total + acc[s]
    return total.float()


def row_gather_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, W): ``out[p, :] = table[idx[p], :]``."""
    return table[idx.long()]


def col_gather_ref(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(W, N): ``out[:, p] = table_t[:, idx[p]]``."""
    return table_t[:, idx.long()]


def lane_gather_ref(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = tab[i, idx[i, j]]``."""
    return torch.gather(tab, 1, idx.long())


def sublane_gather_ref(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = tab[idx[i, j], j]``."""
    return torch.gather(tab, 0, idx.long())


def two_stage_gather_ref(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(K, R, C): ``out[c, i, j] = tab[idx[c, i, m], m]`` with
    ``m = idx[c, i, j] % C``: a sublane gather of ``tab`` (R, C) by ``idx[c]``,
    then a lane gather of its result by ``idx[c] % C``."""
    ix = idx.long()
    g = torch.gather(tab.expand(ix.shape[0], -1, -1), 1, ix)
    return torch.gather(g, 2, ix % tab.shape[1])


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _launch(name: str, out: torch.Tensor, *args) -> None:
    """Launch ``loner_<name>(*args, stream)`` on ``out``'s device and stream."""
    with torch.cuda.device(out.device):
        rc = getattr(kernels.load(), "loner_" + name)(*args, kernels.stream_ptr(out))
    kernels.check(rc, name)


def _table(tab: torch.Tensor, name: str):
    if tab.dim() != 2:
        raise ValueError(f"{name}: expected a 2-d table, got shape {tuple(tab.shape)}")
    kernels.require(tab, name, torch.float32, device=tab.device)
    return tab.device


def row_scatter_add_plan(w: int, upd_aligned: bool) -> str:
    """The kernel path :func:`row_scatter_add` takes for update rows of ``w``
    floats: ``"vector"`` (a thread and one vector atomic per 16-byte piece)
    where rows are whole float4s, ``w % 4 == 0``, and ``upd`` starts on a
    16-byte boundary (``upd_aligned``); else ``"scalar"`` (a thread and a
    scalar atomic per element)."""
    return "vector" if w % 4 == 0 and upd_aligned else "scalar"


def row_scatter_add(idx: torch.Tensor, upd: torch.Tensor, n_rows: int, nshadow: int = 1,
                    acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(n_rows, W) f32 row sums (see :func:`row_scatter_add_ref`): on CUDA
    the atomic scatter into the shadow copies (:func:`row_scatter_add_plan`
    picks vector or scalar atomics) and a kernel that sums them (one f32
    copy is the output itself: no sum)."""
    dev = _table(upd, "upd")
    kernels.require(idx, "idx", torch.int32, (upd.shape[0],), dev)
    if n_rows < 1 or nshadow < 1:
        raise ValueError(f"n_rows {n_rows} and nshadow {nshadow} must be at least 1")
    if acc_dtype not in _ACC_DTYPES:
        raise ValueError(f"acc_dtype: expected one of {_ACC_DTYPES}, got {acc_dtype}")
    if dev.type == "cpu":
        return row_scatter_add_ref(idx, upd, n_rows, nshadow, acc_dtype)
    n, w = upd.shape
    if n == 0 or w == 0:
        return torch.zeros((n_rows, w), dtype=torch.float32, device=dev)
    bf16 = int(acc_dtype == torch.bfloat16)
    vec = int(row_scatter_add_plan(w, upd.data_ptr() % 16 == 0) == "vector")
    if nshadow == 1 and not bf16:  # the zeroed output is the one f32 accumulator
        out = torch.zeros((n_rows, w), dtype=torch.float32, device=dev)
        _launch("row_scatter_add", out, idx.data_ptr(), upd.data_ptr(), out.data_ptr(), n, n_rows, w, 1, 0, vec)
    else:
        acc = torch.zeros((nshadow, n_rows, w), dtype=acc_dtype, device=dev)
        out = torch.empty((n_rows, w), dtype=torch.float32, device=dev)
        _launch("row_scatter_add", out, idx.data_ptr(), upd.data_ptr(), acc.data_ptr(), n, n_rows, w, nshadow, bf16,
                vec)
        _launch("shadow_sum", out, acc.data_ptr(), out.data_ptr(), n_rows * w, nshadow, bf16)
    row_scatter_add.launches += 1
    return out


kernels.counted(row_scatter_add)


def float4_rows(table: torch.Tensor) -> bool:
    """Whether :func:`row_gather`'s kernel may move ``table``'s rows as
    float4s: rows of a multiple of 4 floats that start on a 16-byte boundary
    (a view at another offset takes the kernel's float path)."""
    return table.shape[1] % 4 == 0 and table.data_ptr() % 16 == 0


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, W) rows ``table[idx]`` of a (T, W) f32 table."""
    dev = _table(table, "table")
    kernels.require(idx, "idx", torch.int32, (idx.numel(),), dev)
    if dev.type == "cpu":
        return row_gather_ref(table, idx)
    t, w = table.shape
    out = torch.empty((idx.numel(), w), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    _launch("row_gather", out, table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(), t, w,
            int(float4_rows(table)))
    row_gather.launches += 1
    return out


kernels.counted(row_gather)


def col_gather(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(W, N) columns ``table_t[:, idx]`` of a (W, T) f32 table. On CUDA one
    call is two launches: ``table_t`` transposed into a (T, W rounded up to
    4) scratch, then a gather of its rows."""
    dev = _table(table_t, "table_t")
    kernels.require(idx, "idx", torch.int32, (idx.numel(),), dev)
    if dev.type == "cpu":
        return col_gather_ref(table_t, idx)
    w, t = table_t.shape
    out = torch.empty((w, idx.numel()), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    scratch = torch.empty((t, -(-w // 4) * 4), dtype=torch.float32, device=dev)
    _launch("col_gather", out, table_t.data_ptr(), idx.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            idx.numel(), t, w)
    col_gather.launches += 1
    return out


kernels.counted(col_gather)


def _same_shape_lookup(name: str, ref, tab: torch.Tensor, idx: torch.Tensor, wrapper) -> torch.Tensor:
    dev = _table(tab, "tab")
    kernels.require(idx, "idx", torch.int32, tuple(tab.shape), dev)
    if dev.type == "cpu":
        return ref(tab, idx)
    out = torch.empty_like(tab)
    if out.numel() == 0:
        return out
    _launch(name, out, tab.data_ptr(), idx.data_ptr(), out.data_ptr(), *tab.shape)
    wrapper.launches += 1
    return out


def lane_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = tab[i, idx[i, j]]``; ``tab`` f32 and ``idx`` of one shape."""
    return _same_shape_lookup("lane_gather", lane_gather_ref, tab, idx, lane_gather)


kernels.counted(lane_gather)


def sublane_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = tab[idx[i, j], j]``; ``tab`` f32 and ``idx`` of one shape."""
    return _same_shape_lookup("sublane_gather", sublane_gather_ref, tab, idx, sublane_gather)


kernels.counted(sublane_gather)


def two_stage_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(K, R, C) two-stage lookup of ``tab`` (R, C) by ``idx`` (K, R, C)
    (see :func:`two_stage_gather_ref`), fused into one kernel on CUDA that
    reads each row's distinct values once."""
    dev = _table(tab, "tab")
    if idx.dim() != 3:
        raise ValueError(f"idx: expected (K, R, C), got shape {tuple(idx.shape)}")
    kernels.require(idx, "idx", torch.int32, (idx.shape[0], *tab.shape), dev)
    if dev.type == "cpu":
        return two_stage_gather_ref(tab, idx)
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    _launch("two_stage_gather", out, tab.data_ptr(), idx.data_ptr(), out.data_ptr(), *idx.shape)
    two_stage_gather.launches += 1
    return out


kernels.counted(two_stage_gather)
