"""CellHash: the multi-resolution hash encoding with one row gather per
(point, level), the "cell" encoder.

The port of ``loner_tpu/ops/cell_hash.py``. Every cell of a level stores
its 8 corners' feature pairs as one 16-wide row (corner-major:
``[c0f0, c0f1, c1f0, ...]``), so trilinear interpolation reads ONE row per
(point, level). Corner features are per cell, not shared between
neighbouring cells: the encoding is discontinuous at cell borders within a
level, and the multi-level sum and the MLP absorb it, as they absorb hash
collisions.

The forward reads the f32 master table ``(L, T, 16)`` rounded to bf16 and
sums in f32. The backward:

  * "exact": one 16-wide row scatter per level;
  * "level1": each point scatters into ONE level, chosen by hashing the
    mantissa bits of its coordinates (fresh each step under the sampler's
    stratified jitter), through one combined (L*T)-row scatter scaled by L;
  * either with optional corner sampling (one corner per row, drawn in
    proportion to its trilinear weight, unbiased);
  * d_pts exact in both, from the bf16 features the forward read.

Corner sampling takes uniforms ``u`` (L, N) (under "level1" only row 0 is
read), or draws them from a ``torch.Generator`` seeded from the two key
words inside each call, so that equal-sized point chunks with one key draw
equal uniforms, as in the JAX package.

A table may come as :class:`TableSlabs`, contiguous slabs of its cell axis
each on its own device (the hash-table tensor parallelism of
``parallel/tp.py``): each slab packs and gathers the rows it owns, zeros
elsewhere, the partial rows are summed on the points' device, where the
features and d_pts are computed, and each slab's gradient scatters only its
own rows, on its device, with the same uniforms on every slab.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.models.hash_encoding import _CORNERS, _PRIMES, _trilinear_w, f32_scale
from loner_tpu_torch.ops.fused_encoder import _U32, TableSlabs, _mul_u32, _own_rows, _scatter_rows
from loner_tpu_torch.ops.hash_encode_fast import _dfrac, uniforms_from_key


class CellHashConfig(NamedTuple):
    n_levels: int = 16
    log2_cells: int = 16  # cells per level; 8 corner pairs per cell
    base_resolution: int = 16
    per_level_scale: float = 2.0
    bwd: str = "exact"  # the table gradient: "exact" (a scatter per level) | "level1" (one level a point)

    @property
    def table_size(self) -> int:
        return 1 << self.log2_cells

    @property
    def output_dim(self) -> int:
        return self.n_levels * 2

    def level_scales(self) -> np.ndarray:
        ls = np.arange(self.n_levels, dtype=np.float64)
        return self.base_resolution * self.per_level_scale**ls - 1.0

    def level_resolutions(self) -> np.ndarray:
        return np.ceil(self.level_scales()).astype(np.int64) + 1

    def level_is_dense(self) -> np.ndarray:
        # dense cell indexing while the cell count fits the table
        res = self.level_resolutions()
        return (res.astype(object) ** 3 <= self.table_size).astype(bool)


def init_cell_table(generator: torch.Generator, cfg: CellHashConfig, device="cuda") -> torch.Tensor:
    """(L, T, 16) f32 master table, uniform in [-1e-4, 1e-4): per cell, 8
    corners x 2 features, corner-major."""
    dev = resolve_device(device)
    return torch.rand((cfg.n_levels, cfg.table_size, 16), generator=generator, device=dev) * 2e-4 - 1e-4


def _cell_and_frac(pts_t: torch.Tensor, scale: float, res: int):
    """(cells clipped to [0, res - 1], int64 (3, N); frac (3, N))."""
    scaled = pts_t * f32_scale(scale) + 0.5
    cellf = torch.floor(scaled)
    return torch.clamp(cellf.long(), 0, res - 1), scaled - cellf


def _cell_ids(cells: torch.Tensor, res: int, dense: bool, table_size: int) -> torch.Tensor:
    """Row of each cell (int64): dense, or the tcnn hash in int64 (a cell is
    below 2^20, a prime below 2^32: no product overflows)."""
    if dense:
        return cells[0] + cells[1] * res + cells[2] * (res * res)
    h = (cells[0] * _PRIMES[0]) ^ (cells[1] * _PRIMES[1]) ^ (cells[2] * _PRIMES[2])
    return h & (table_size - 1)


def _level_rows(pts_t: torch.Tensor, cfg: CellHashConfig):
    """Each level's row indices (L, N)."""
    scales, resolutions, dense = cfg.level_scales(), cfg.level_resolutions(), cfg.level_is_dense()
    return torch.stack([
        _cell_ids(_cell_and_frac(pts_t, scales[lvl], int(resolutions[lvl]))[0], int(resolutions[lvl]),
                  bool(dense[lvl]), cfg.table_size)
        for lvl in range(cfg.n_levels)])


def _corner_sample_w(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Trilinear weights (8, N) replaced by a one-hot corner drawn in
    proportion to them by the uniforms u (N,)."""
    cdf = torch.cumsum(w, dim=0)
    choice = torch.clamp(torch.sum((u[None, :] > cdf).to(torch.int64), dim=0), 0, 7)
    return torch.nn.functional.one_hot(choice, 8).T.to(w.dtype)


def _jitter_level_choice(pts_t: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Each point's level (N,) int64, from a multiplicative hash of its
    coordinates' float32 bits (the JAX package's uint32 hash, in int64)."""
    b = pts_t.contiguous().view(torch.int32).to(torch.int64) & _U32  # (3, N)
    h = _mul_u32(b[0], 2654435761) ^ _mul_u32(b[1], 805459861) ^ _mul_u32(b[2], 3674653429)
    return h % n_levels


def _gather_rows(slabs, idx: torch.Tensor) -> torch.Tensor:
    """The bf16 row of every (level, point), (L, N, 16) on ``idx``'s device,
    from the table whole (one slab) or from its slabs: each slab packs and
    gathers the rows it owns on its own device, zeros elsewhere, and the
    partial rows (one nonzero per point) are summed in slab order."""
    l = idx.shape[0]
    if len(slabs) == 1:
        packed = slabs[0].to(torch.bfloat16)
        return torch.stack([packed[lvl][idx[lvl]] for lvl in range(l)])  # ONE row gather per (point, level)
    v, row0 = None, 0
    for slab in slabs:
        packed = slab.to(torch.bfloat16)
        local, own = _own_rows(idx.to(slab.device), row0, slab.shape[1])
        part = torch.stack([packed[lvl][local[lvl]] for lvl in range(l)]).mul_(own[..., None]).to(idx.device)
        v = part if v is None else v + part
        row0 += slab.shape[1]
    return v


def _cell_fwd(slabs, pts_t: torch.Tensor, cfg: CellHashConfig):
    """(features (L*2, N), rows (L, N), the gathered bf16 rows (L, N, 16))
    from the table's slabs (one for a whole table)."""
    scales, resolutions = cfg.level_scales(), cfg.level_resolutions()
    idx = _level_rows(pts_t, cfg)
    v = _gather_rows(slabs, idx)
    outs = []
    for lvl in range(cfg.n_levels):
        _, frac = _cell_and_frac(pts_t, scales[lvl], int(resolutions[lvl]))
        wt = _trilinear_w(frac).T  # (N, 8)
        outs.append(torch.stack([torch.sum(v[lvl, :, 0::2].float() * wt, dim=1),
                                 torch.sum(v[lvl, :, 1::2].float() * wt, dim=1)]))
    return torch.cat(outs, dim=0), idx, v


def _cell_rows(w: torch.Tensor, g_l: torch.Tensor) -> torch.Tensor:
    """(N, 16) corner-major row updates: upd[n, c*2 + f] = w[c, n] * g[f, n]."""
    n = w.shape[1]
    return (w.T[:, :, None] * g_l.T[:, None, :]).reshape(n, 16)


def _cell_bwd(cfg: CellHashConfig, idx: torch.Tensor, v: torch.Tensor, pts_t: torch.Tensor, g: torch.Tensor,
              u: Optional[torch.Tensor], slab_rows, need_pts: bool):
    """(the slabs' table gradients, d_pts (3, N)) from the cotangent g
    (L*2, N). ``slab_rows`` lists each slab's (device, rows, dtype, needs a
    gradient?); slab m's gradient (L, rows, 16) is built on its own device
    from the rows it owns (None where it needs none), summed in the slab's
    dtype (a float64 slab sums the same f32 terms in float64), with the
    same uniforms ``u`` (L, N) on every slab: one corner sampled per
    scattered row."""
    l, n = idx.shape
    g = g.reshape(l, 2, n)
    scales, resolutions = cfg.level_scales(), cfg.level_resolutions()
    t = cfg.table_size
    level1 = cfg.bwd == "level1"
    d_slabs, slabs, row0 = [], [], 0  # slabs: (device, row0, rows, gradient) of each that needs one
    for dev, rows, dtype, need in slab_rows:
        d_slabs.append(torch.zeros((l, rows, 16), dtype=dtype, device=dev) if need else None)
        if need:
            slabs.append((dev, row0, rows, d_slabs[-1]))
        row0 += rows
    d_pts = None

    if slabs and level1:
        choice = _jitter_level_choice(pts_t, l)  # (N,)
        g_sel = torch.gather(g, 0, choice[None, None, :].expand(1, 2, n))[0]  # (2, N)
        scale_sel = torch.as_tensor(scales.astype(np.float32), device=g.device)[choice]
        scaled = pts_t * scale_sel[None, :] + 0.5
        w_sel = _trilinear_w(scaled - torch.floor(scaled))
        idx_sel = torch.gather(idx, 0, choice[None, :])[0]
        for dev, r0, rows, d in slabs:
            w = w_sel.to(dev)
            if u is not None:
                w = _corner_sample_w(w, u[0].to(dev))
            upd = (_cell_rows(w, g_sel.to(dev)) * float(l)).to(d.dtype)
            local = idx_sel.to(dev)
            if rows != t:  # the combined index counts this slab's rows
                local, own = _own_rows(local, r0, rows)
                upd = upd * own[:, None]
            d.view(l * rows, 16).index_add_(0, choice.to(dev) * rows + local, upd)
    if need_pts:
        d_pts = torch.zeros_like(pts_t)
        corner_f = torch.as_tensor(_CORNERS, dtype=torch.float32, device=g.device)[:, :, None]  # (8, 3, 1)
        sign = 2.0 * corner_f - 1.0
    for lvl in range(l):
        _, frac = _cell_and_frac(pts_t, scales[lvl], int(resolutions[lvl]))
        if not level1:
            for dev, r0, rows, d in slabs:
                w = _trilinear_w(frac.to(dev))
                if u is not None:
                    w = _corner_sample_w(w, u[lvl].to(dev))
                _scatter_rows(d[lvl], idx[lvl].to(dev), _cell_rows(w, g[lvl].to(dev)).to(d.dtype), r0, t)
        if need_pts:
            pc = v[lvl, :, 0::2].float().T * g[lvl, 0][None, :] + v[lvl, :, 1::2].float().T * g[lvl, 1][None, :]
            d_pts = d_pts + _dfrac(pc, frac, corner_f, sign) * f32_scale(scales[lvl])
    return d_slabs, d_pts


class _CellEncode(torch.autograd.Function):
    """Inputs (pts_t, cfg, sample, key, u, *slabs): the table whole, or its
    :class:`TableSlabs`."""

    @staticmethod
    def forward(ctx, pts_t, cfg, sample, key, u, *slabs):
        out, idx, v = _cell_fwd(slabs, pts_t, cfg)
        ctx.cfg, ctx.sample = cfg, sample
        ctx.slab_rows = [(s.device, s.shape[1], s.dtype) for s in slabs]
        ctx.save_for_backward(idx, v, pts_t, key, u)
        return out

    @staticmethod
    def backward(ctx, g):
        idx, v, pts_t, key, u = ctx.saved_tensors
        need = ctx.needs_input_grad[5:]
        if ctx.sample and u is None and any(need):  # drawn once, on the points' device, for every slab
            u = uniforms_from_key(key, tuple(idx.shape), g.device)
        d_slabs, d_pts = _cell_bwd(ctx.cfg, idx, v, pts_t, g.contiguous(), u if ctx.sample else None,
                                   [(*slab, nd) for slab, nd in zip(ctx.slab_rows, need)],
                                   ctx.needs_input_grad[0])
        return (d_pts, None, None, None, None, *d_slabs)


def cell_hash_encode_t(table, pts_t: torch.Tensor, cfg: CellHashConfig,
                       bwd_key: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(L*2, N) encoding of pts_t (3, N) in [0, 1], one row gather per
    (point, level), differentiable in the table (L, T, 16), a tensor or its
    :class:`TableSlabs`, and the points. ``bwd_key`` (two words) or ``u``
    (L, N) turns on corner sampling in the table gradient."""
    sample = bwd_key is not None or u is not None
    key = None if bwd_key is None else torch.as_tensor(bwd_key).to(torch.int64)
    slabs = tuple(table) if isinstance(table, TableSlabs) else (table,)
    return _CellEncode.apply(pts_t.contiguous(), cfg, sample, key, u, *slabs)
