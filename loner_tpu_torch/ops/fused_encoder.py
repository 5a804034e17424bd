"""FusedHash: the multi-resolution hash encoding with one row per cell,
kernels B4 (forward) and B5 (point gradient).

The port of ``loner_tpu/ops/fused_encoder.py``. Per level l a table of T
cells holds one row of 8F features per cell, feature-major
``[f0c0..f0c7, f1c0..f1c7, ...]`` (corner order: bit0 = x, bit1 = y,
bit2 = z). A point's cell comes from ``floor(pts * scale_l + 0.5)``, indexed
densely while ``res_l^3 <= T`` and by the spatial hash
``x*1 ^ y*2654435761 ^ z*805459861 mod T`` after that; its F features are the
trilinear blend of the cell's 8 corner values.

Layouts are the JAX package's: points ``(3, N)`` f32 in [0, 1], the f32
master table ``(L, T, 8F)``, gathered corner rows ``v_t (L, 8F, N)`` bf16,
features ``(L*F, N)`` f32.

* :func:`interp_fwd` / :func:`interp_dpts` are the kernel wrappers (CUDA
  source in ``csrc/fused_encoder.cu``, replacing
  ``loner_tpu/ops/fused_encoder.py::_fwd_kernel`` and ``::_dpts_kernel``).
  Each takes its plain version for a CPU tensor and launches its kernel for a
  CUDA tensor; ``launches`` counts the launches.
* :func:`interp_fwd_ref` / :func:`dpts_ref` are the plain versions.
* The exact table gradient :func:`_bwd_dtable_exact` is a kernel wrapper too
  (``fused_dtable_kernel``, one launch for all levels; no TPU kernel: the JAX
  package leaves it to XLA), with :func:`dtable_exact_ref`, the per-level
  plain scatter, as its plain version, :func:`dtable_exact_plan` for its
  limits and :func:`dtable_run_share` for how much of its input the kernel
  sums inside a warp.
* The gather of the corner rows (:func:`_gather_v_t`) and the strided table
  gradient (:func:`_bwd_dtable_strided`) are plain PyTorch ops, as the JAX
  package leaves them to XLA.
* :func:`fused_hash_encode_t` is the differentiable encode
  (``torch.autograd.Function``).
* A table may come as :class:`TableSlabs`, contiguous slabs of its cell
  axis each on its own device (the hash-table tensor parallelism of
  ``parallel/tp.py``): each slab gathers the rows it owns, zeros elsewhere,
  the partial ``v_t`` are summed on the points' device, where B4 and B5
  run, and each slab's gradient scatters only its own rows, on its device.

The strided table gradient: training points arrive as rays x S samples; with
(rot, phase) drawn per step from the encoder's two key words, sample s of a
ray updates level ``(s + rot) % L`` if ``(s // L) % k == phase``, scaled by
``L*k`` so that its mean over the draws is the exact gradient.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.ops import kernels

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


class FusedHashConfig(NamedTuple):
    n_levels: int = 16
    log2_cells: int = 16  # cells per level (one 8F-feature row per cell)
    base_resolution: int = 16
    per_level_scale: float = 2.0
    # table gradient: "exact" (every (point, level) scatters) | "strided"
    bwd: str = "strided"
    bwd_stride: int = 2  # k: keep every k-th slot group per level
    slot_period: int = 512  # S, samples per ray; 0 disables the strided backward
    n_features: int = 2  # features per corner (= per level)
    # keep the gathered corner rows v_t from the forward for the backward;
    # False gathers them again in the backward (less memory held)
    save_residual: bool = True

    @property
    def table_size(self) -> int:
        return 1 << self.log2_cells

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def row_width(self) -> int:
        return 8 * self.n_features

    def level_scales(self) -> np.ndarray:
        ls = np.arange(self.n_levels, dtype=np.float64)
        return (self.base_resolution * self.per_level_scale**ls - 1.0).astype(np.float32)

    def level_resolutions(self) -> np.ndarray:
        return np.ceil(self.level_scales().astype(np.float64)).astype(np.int32) + 1

    def level_is_dense(self) -> np.ndarray:
        res = self.level_resolutions()
        return ((res.astype(object)) ** 3 <= self.table_size).astype(bool)


class TableSlabs(list):
    """The slabs of one table leaf (..., T, W) along its cell axis, in
    order, each on its own device: slab m holds rows [m*T/n, (m+1)*T/n).
    A parameter tree holds it where it held the table; tree maps keep the
    type."""


def init_fused_table(generator: torch.Generator, cfg: FusedHashConfig, device="cuda") -> torch.Tensor:
    """(L, T, 8F) f32 master table, uniform in [-1e-4, 1e-4), feature-major rows."""
    dev = resolve_device(device)
    shape = (cfg.n_levels, cfg.table_size, cfg.row_width)
    return torch.rand(shape, generator=generator, device=dev) * 2e-4 - 1e-4


# ---------------------------------------------------------------------------
# cell index and weights
# ---------------------------------------------------------------------------


def _cell_frac(pts_t: torch.Tensor, scale: float, res: int):
    """pts_t (3, N) -> clipped int64 cells (3, N), frac (3, N). The product
    and the sum round separately, as the kernels compute them."""
    scaled = pts_t * float(scale) + 0.5
    cellf = torch.floor(scaled)
    return torch.clamp(cellf.long(), 0, res - 1), scaled - cellf


def _frac(pts_t: torch.Tensor, scale: float) -> torch.Tensor:
    scaled = pts_t * float(scale) + 0.5
    return scaled - torch.floor(scaled)


def _cell_ids(cells: torch.Tensor, res: int, dense: bool, table_size: int) -> torch.Tensor:
    """Row of each cell (int64). The hash is the JAX package's uint32 hash
    computed in int64: a cell is below 2^31 and a prime below 2^32, so no
    product overflows, and the low 32 bits of products and XORs do not depend
    on the high bits."""
    if dense:
        return cells[0] + cells[1] * res + cells[2] * (res * res)
    h = (cells[0] * _PRIMES[0]) ^ (cells[1] * _PRIMES[1]) ^ (cells[2] * _PRIMES[2])
    return h & (table_size - 1)


def _level_indices(pts_t: torch.Tensor, cfg: FusedHashConfig, lvl: int) -> torch.Tensor:
    res = int(cfg.level_resolutions()[lvl])
    cells, _ = _cell_frac(pts_t, cfg.level_scales()[lvl], res)
    return _cell_ids(cells, res, bool(cfg.level_is_dense()[lvl]), cfg.table_size)


def _axis_weights(frac: torch.Tensor):
    """frac (3, N) -> per-corner axis weights wx, wy, wz, each (8, N)."""
    fx, fy, fz = frac[0], frac[1], frac[2]
    wx = torch.stack([fx if b & 1 else 1.0 - fx for b in range(8)])
    wy = torch.stack([fy if b & 2 else 1.0 - fy for b in range(8)])
    wz = torch.stack([fz if b & 4 else 1.0 - fz for b in range(8)])
    return wx, wy, wz


def _corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """frac (3, N) -> (8, N) trilinear weights."""
    wx, wy, wz = _axis_weights(frac)
    return wx * wy * wz


def _own_rows(idx: torch.Tensor, row0: int, rows: int):
    """(local row, owned?) of table rows ``idx`` in the slab [row0, row0 + rows)."""
    local = idx - row0
    own = (local >= 0) & (local < rows)
    return torch.where(own, local, 0), own


def _gather_v_t(tables_bf16: torch.Tensor, pts_t: torch.Tensor, cfg: FusedHashConfig, row0: int = 0) -> torch.Tensor:
    """The corner rows of every (level, point): v_t (L, 8F, N) bf16, gathered
    along the cell axis of the transposed table (L, 8F, T) so that each
    level's rows land in v_t's layout with no transposing copy of v_t. A
    slab of the table's rows [row0, row0 + its rows) gives zeros for the
    rows it does not own."""
    rows = tables_bf16.shape[1]
    tables_t = tables_bf16.transpose(1, 2).contiguous()
    v_t = torch.empty((cfg.n_levels, cfg.row_width, pts_t.shape[-1]), dtype=tables_bf16.dtype, device=pts_t.device)
    for lvl in range(cfg.n_levels):
        idx = _level_indices(pts_t, cfg, lvl)
        if rows == cfg.table_size:
            torch.index_select(tables_t[lvl], 1, idx, out=v_t[lvl])
        else:
            local, own = _own_rows(idx, row0, rows)
            torch.index_select(tables_t[lvl], 1, local, out=v_t[lvl])
            v_t[lvl].mul_(own)
    return v_t


def _gather_slabs(slabs, pts_t: torch.Tensor, cfg: FusedHashConfig) -> torch.Tensor:
    """v_t on the points' device from the table's slabs: each slab gathers
    on its own device, and the partial v_t (one nonzero per entry) are
    summed in slab order."""
    if len(slabs) == 1:
        return _gather_v_t(slabs[0].to(torch.bfloat16), pts_t, cfg)
    v_t, row0 = None, 0
    for slab in slabs:
        part = _gather_v_t(slab.to(torch.bfloat16), pts_t.to(slab.device), cfg, row0).to(pts_t.device)
        v_t = part if v_t is None else v_t + part
        row0 += slab.shape[1]
    return v_t


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def interp_fwd_ref(pts_t: torch.Tensor, v_t: torch.Tensor, cfg: FusedHashConfig) -> torch.Tensor:
    """(L*F, N) features: per level, the corner rows blended by the 8 weights."""
    outs = []
    for lvl, scale in enumerate(cfg.level_scales()):
        w = _corner_weights(_frac(pts_t, scale))
        v = v_t[lvl].float()
        for f in range(cfg.n_features):
            outs.append(torch.sum(v[8 * f : 8 * f + 8] * w, dim=0))
    return torch.stack(outs)


def dpts_ref(pts_t: torch.Tensor, v_t: torch.Tensor, g: torch.Tensor, cfg: FusedHashConfig) -> torch.Tensor:
    """(3, N) gradient of the forward's features against the points, at fixed
    corner rows, summed over the levels."""
    nf = cfg.n_features
    d = torch.zeros_like(pts_t)
    sign = [torch.tensor([1.0 if b & m else -1.0 for b in range(8)], device=pts_t.device)[:, None] for m in (1, 2, 4)]
    for lvl, scale in enumerate(cfg.level_scales()):
        wx, wy, wz = _axis_weights(_frac(pts_t, scale))
        v = v_t[lvl].float()
        pc = sum(v[8 * f : 8 * f + 8] * g[nf * lvl + f][None, :] for f in range(nf))  # (8, N)
        dx = torch.sum(sign[0] * wy * wz * pc, dim=0)
        dy = torch.sum(sign[1] * wx * wz * pc, dim=0)
        dz = torch.sum(sign[2] * wx * wy * pc, dim=0)
        d = d + torch.stack([dx, dy, dz]) * float(scale)
    return d


# ---------------------------------------------------------------------------
# table gradient
# ---------------------------------------------------------------------------


def _row_updates(pts_t: torch.Tensor, gl: torch.Tensor, scale: float) -> torch.Tensor:
    """(M, 8F) feature-major row updates: weight of corner c times g[f]."""
    w = _corner_weights(_frac(pts_t, scale))  # (8, M)
    return (gl.T[:, :, None] * w.T[:, None, :]).reshape(w.shape[1], -1)


def _scatter_rows(d: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor, row0: int, table_size: int) -> None:
    """d += upd at table rows ``idx``, where ``d`` (rows, 8F) holds the rows
    [row0, row0 + rows) of a table of ``table_size``; the rows it does not
    hold add nothing."""
    rows = d.shape[0]
    if rows != table_size:
        idx, own = _own_rows(idx, row0, rows)
        upd = upd * own[:, None]
    d.index_add_(0, idx, upd)


def dtable_exact_ref(pts_t: torch.Tensor, g: torch.Tensor, cfg: FusedHashConfig, row0: int = 0,
                     rows: Optional[int] = None) -> torch.Tensor:
    """(L, T, 8F) f32: every (point, level) adds its row update, one
    ``index_add_`` a level. With ``rows``, the gradient of the slab [row0,
    row0 + rows) alone."""
    nf = cfg.n_features
    rows = cfg.table_size if rows is None else rows
    d = torch.zeros((cfg.n_levels, rows, cfg.row_width), dtype=torch.float32, device=pts_t.device)
    for lvl, scale in enumerate(cfg.level_scales()):
        upd = _row_updates(pts_t, g[nf * lvl : nf * lvl + nf], scale)
        _scatter_rows(d[lvl], _level_indices(pts_t, cfg, lvl), upd, row0, cfg.table_size)
    return d


_DTABLE_THREADS = 256  # points a block of fused_dtable_kernel takes, per level
_LIMIT32 = 1 << 31


class DtablePlan(NamedTuple):
    blocks: int  # blocks of _DTABLE_THREADS points on the grid's x axis, one row of blocks a level
    vec4_per_run: int  # float4 atomics a run of equal rows adds its 8F sums with


def dtable_exact_plan(n_levels: int, n_features: int, n: int, rows: int, table_size: int) -> DtablePlan:
    """The launch of :func:`_bwd_dtable_exact`'s kernel for ``n`` points into
    a slab of ``rows`` rows of a table of ``table_size``; raises ValueError
    for what its 32-bit offsets cannot index (the C entry refuses the same).
    Rows are 8F floats, whole float4s, so every run adds with 2F vector
    atomics: no F takes a scalar path."""
    if not 1 <= n_levels <= 32 or not 1 <= n_features <= 32:
        raise ValueError(f"n_levels {n_levels} / n_features {n_features} outside [1, 32]")
    if n < 0 or rows < 0:
        raise ValueError(f"negative size: n {n}, rows {rows}")
    if n * n_levels * n_features >= _LIMIT32:
        raise ValueError(f"{n} points x {n_levels} levels x {n_features} features: g has 2^31 elements or more")
    if n_levels * rows * 8 * n_features >= _LIMIT32:
        raise ValueError(f"the gradient of {n_levels} x {rows} rows x {8 * n_features} has 2^31 elements or more")
    if not 1 <= table_size <= _LIMIT32 or table_size & (table_size - 1):
        raise ValueError(f"table size {table_size}: not a power of two up to 2^31")
    return DtablePlan(-(-n // _DTABLE_THREADS), 2 * n_features)


def _bwd_dtable_exact(pts_t: torch.Tensor, g: torch.Tensor, cfg: FusedHashConfig, row0: int = 0,
                      rows: Optional[int] = None) -> torch.Tensor:
    """(L, T, 8F) f32: every (point, level) adds its row update. With
    ``rows``, the gradient of the slab [row0, row0 + rows) alone. One launch
    of ``fused_dtable_kernel`` on CUDA (sums in another order than the plain
    version's), :func:`dtable_exact_ref` on CPU."""
    if pts_t.device.type == "cpu":
        return dtable_exact_ref(pts_t, g, cfg, row0, rows)
    rows = cfg.table_size if rows is None else rows
    n = _check_points(pts_t)
    kernels.require(g, "g", torch.float32, (cfg.output_dim, n), pts_t.device)
    if row0 < 0 or row0 + rows > cfg.table_size:
        raise ValueError(f"slab [{row0}, {row0 + rows}) outside the table's {cfg.table_size} rows")
    dtable_exact_plan(cfg.n_levels, cfg.n_features, n, rows, cfg.table_size)
    d = torch.zeros((cfg.n_levels, rows, cfg.row_width), dtype=torch.float32, device=pts_t.device)
    if n == 0 or rows == 0:
        return d
    levels = cfg.n_levels
    scales = (ctypes.c_float * levels)(*[float(x) for x in cfg.level_scales()])
    res = (ctypes.c_int * levels)(*[int(x) for x in cfg.level_resolutions()])
    dense = (ctypes.c_int * levels)(*[int(x) for x in cfg.level_is_dense()])
    with torch.cuda.device(pts_t.device):
        rc = kernels.load().loner_fused_dtable(
            pts_t.data_ptr(), g.data_ptr(), d.data_ptr(), n, levels, cfg.n_features,
            ctypes.cast(scales, ctypes.c_void_p), ctypes.cast(res, ctypes.c_void_p),
            ctypes.cast(dense, ctypes.c_void_p), cfg.table_size, row0, rows, kernels.stream_ptr(pts_t),
        )
    kernels.check(rc, "dtable_exact")
    _bwd_dtable_exact.launches += 1
    return d


kernels.counted(_bwd_dtable_exact)


def dtable_run_share(pts_t: torch.Tensor, cfg: FusedHashConfig) -> dict:
    """How much of the exact table gradient the kernel sums inside a warp:
    per level and over all levels, the share of (point, level) updates
    folded into a run head. A point folds where its row equals the row of
    the point before it in the same aligned group of 32 (a warp's lanes).
    Counted on the whole table's rows; the train step does not call it."""
    n = pts_t.shape[-1]
    lane = torch.arange(1, n, device=pts_t.device) % 32
    levels = []
    for lvl in range(cfg.n_levels):
        idx = _level_indices(pts_t, cfg, lvl)
        levels.append(int(((idx[1:] == idx[:-1]) & (lane != 0)).sum()) / max(n, 1))
    return {"levels": levels, "overall": sum(levels) / len(levels)}


def _bwd_dtable_strided(pts_t: torch.Tensor, g: torch.Tensor, key_data: torch.Tensor, cfg: FusedHashConfig,
                        row0: int = 0, rows: Optional[int] = None) -> torch.Tensor:
    """(L, T, 8F) f32 slot-strided table gradient. pts_t (3, N) with N =
    n_rays * S and each ray's S samples contiguous. (rot, phase) stay on the
    device: no host sync. With ``rows``, the gradient of the slab [row0,
    row0 + rows) alone."""
    l, k, s_per, nf = cfg.n_levels, cfg.bwd_stride, cfg.slot_period, cfg.n_features
    n_rays = pts_t.shape[-1] // s_per
    group = l * k
    rot = key_data[0] % l
    phase = (key_data[1] % k).reshape(1)
    # (C, n_rays, S/group, k, L): last axis = s % L, k axis = (s // L) % k
    pts_ph = pts_t.reshape(3, n_rays, s_per // group, k, l).index_select(3, phase)
    g_ph = g.reshape(nf * l, n_rays, s_per // group, k, l).index_select(3, phase)
    rows = cfg.table_size if rows is None else rows
    d = torch.zeros((l, rows, cfg.row_width), dtype=torch.float32, device=pts_t.device)
    for lvl, scale in enumerate(cfg.level_scales()):
        cls = ((lvl + rot) % l).reshape(1)  # the slot class feeding this level
        p_l = pts_ph.index_select(4, cls).reshape(3, -1)
        gl = g_ph[nf * lvl : nf * lvl + nf].index_select(4, cls).reshape(nf, -1)
        upd = _row_updates(p_l, gl, scale) * float(l * k)
        _scatter_rows(d[lvl], _level_indices(p_l, cfg, lvl), upd, row0, cfg.table_size)
    return d


def _strided_ok(cfg: FusedHashConfig, n: int) -> bool:
    return (
        cfg.bwd == "strided"
        and cfg.slot_period > 0
        and n % cfg.slot_period == 0
        and cfg.slot_period % (cfg.n_levels * cfg.bwd_stride) == 0
    )


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_points(pts_t: torch.Tensor) -> int:
    """N of a CUDA tensor of points (3, N) f32; raises on anything else."""
    kernels.require(pts_t, "pts_t", torch.float32)
    if pts_t.dim() != 2 or pts_t.shape[0] != 3:
        raise ValueError(f"pts_t: expected (3, N), got {tuple(pts_t.shape)}")
    return pts_t.shape[1]


def _check_args(pts_t: torch.Tensor, v_t: torch.Tensor, cfg: FusedHashConfig):
    n = _check_points(pts_t)
    kernels.require(v_t, "v_t", torch.bfloat16, (cfg.n_levels, cfg.row_width, n))
    if v_t.device != pts_t.device:
        raise ValueError("v_t and pts_t lie on different devices")
    if not 1 <= cfg.n_levels <= 32 or not 1 <= cfg.n_features <= 32:
        raise ValueError(f"n_levels {cfg.n_levels} / n_features {cfg.n_features} outside [1, 32]")
    return n, (ctypes.c_float * cfg.n_levels)(*[float(s) for s in cfg.level_scales()])


def interp_fwd(pts_t: torch.Tensor, v_t: torch.Tensor, cfg: FusedHashConfig) -> torch.Tensor:
    """(L*F, N) features: kernel B4 on CUDA, the plain forward on CPU."""
    if pts_t.device.type == "cpu":
        return interp_fwd_ref(pts_t, v_t, cfg)
    n, scales = _check_args(pts_t, v_t, cfg)
    out = torch.empty((cfg.output_dim, n), dtype=torch.float32, device=pts_t.device)
    if n == 0:
        return out
    with torch.cuda.device(pts_t.device):
        rc = kernels.load().loner_fused_fwd(
            pts_t.data_ptr(), v_t.data_ptr(), out.data_ptr(), n, cfg.n_levels, cfg.n_features,
            ctypes.cast(scales, ctypes.c_void_p), kernels.stream_ptr(pts_t),
        )
    kernels.check(rc, "interp_fwd")
    interp_fwd.launches += 1
    return out


kernels.counted(interp_fwd)


def interp_dpts(pts_t: torch.Tensor, v_t: torch.Tensor, g: torch.Tensor, cfg: FusedHashConfig) -> torch.Tensor:
    """(3, N) point gradient: kernel B5 on CUDA, the plain version on CPU."""
    if pts_t.device.type == "cpu":
        return dpts_ref(pts_t, v_t, g, cfg)
    n, scales = _check_args(pts_t, v_t, cfg)
    kernels.require(g, "g", torch.float32, (cfg.output_dim, n))
    out = torch.empty_like(pts_t)
    if n == 0:
        return out
    with torch.cuda.device(pts_t.device):
        rc = kernels.load().loner_fused_dpts(
            pts_t.data_ptr(), v_t.data_ptr(), g.data_ptr(), out.data_ptr(), n, cfg.n_levels, cfg.n_features,
            ctypes.cast(scales, ctypes.c_void_p), kernels.stream_ptr(pts_t),
        )
    kernels.check(rc, "interp_dpts")
    interp_dpts.launches += 1
    return out


kernels.counted(interp_dpts)


# ---------------------------------------------------------------------------
# differentiable encode
# ---------------------------------------------------------------------------


class _FusedEncode(torch.autograd.Function):
    """Inputs (pts_t, key_data, cfg, *slabs): the table whole, or its
    :class:`TableSlabs`."""

    @staticmethod
    def forward(ctx, pts_t, key_data, cfg, *slabs):
        pts_t = pts_t.contiguous()
        v_t = _gather_slabs(slabs, pts_t, cfg)
        out = interp_fwd(pts_t, v_t, cfg)
        ctx.cfg = cfg
        ctx.slab_rows = [(s.device, s.shape[1]) for s in slabs]
        # without the residual, the slabs are kept to gather v_t again
        ctx.save_for_backward(pts_t, key_data, *((v_t,) if cfg.save_residual else slabs))
        return out

    @staticmethod
    def backward(ctx, g):
        pts_t, key_data, *saved = ctx.saved_tensors
        cfg = ctx.cfg
        g = g.contiguous()
        d_pts = None
        if ctx.needs_input_grad[0]:  # a pose-frozen step needs no point gradient
            v_t = saved[0] if cfg.save_residual else _gather_slabs(saved, pts_t, cfg)
            d_pts = interp_dpts(pts_t, v_t, g, cfg)
        strided = _strided_ok(cfg, pts_t.shape[-1])
        d_slabs, row0 = [], 0
        for m, (dev, rows) in enumerate(ctx.slab_rows):
            d = None
            if ctx.needs_input_grad[3 + m]:  # each slab's rows, on its own device
                p, gd = pts_t.to(dev), g.to(dev)
                d = (_bwd_dtable_strided(p, gd, key_data.to(dev), cfg, row0, rows) if strided
                     else _bwd_dtable_exact(p, gd, cfg, row0, rows))
            d_slabs.append(d)
            row0 += rows
        return (d_pts, None, None, *d_slabs)


def _mul_u32(a: torch.Tensor, p: int) -> torch.Tensor:
    """(a * p) mod 2^32 for int64 a in [0, 2^32), without int64 overflow."""
    lo = a * (p & 0xFFFF)
    hi = ((a * (p >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def key_data_from_points(pts_t: torch.Tensor) -> torch.Tensor:
    """The two key words drawn from the mantissa bits of the first (up to) 8
    points, as the JAX package does when no key is given (int64 in [0, 2^32))."""
    b = pts_t[:, : min(8, pts_t.shape[-1])].detach().contiguous().view(torch.int32).long() & _U32
    h0 = _mul_u32(b[0], 2654435761) ^ _mul_u32(b[1], 805459861)
    h1 = h0 ^ _mul_u32(b[2], 3674653429)
    return torch.stack([h0.sum() & _U32, h1.sum() & _U32])


def fused_hash_encode_t(
    table: torch.Tensor,
    pts_t: torch.Tensor,
    cfg: FusedHashConfig,
    key: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(L*F, N) encoding of pts_t (3, N) in [0, 1], differentiable in the
    table (a tensor or its :class:`TableSlabs`) and the points. ``key``
    holds the two words (int64 in [0, 2^32)) that draw the strided
    backward's rotation and phase; pass fresh words each step. Without it
    they come from the points' mantissa bits."""
    key_data = key_data_from_points(pts_t) if key is None else key.to(device=pts_t.device, dtype=torch.int64)
    slabs = tuple(table) if isinstance(table, TableSlabs) else (table,)
    return _FusedEncode.apply(pts_t, key_data, cfg, *slabs)
