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
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.models.hash_encoding import _CORNERS, _PRIMES, _trilinear_w, f32_scale
from loner_tpu_torch.ops.fused_encoder import _U32, _mul_u32
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


def _cell_fwd(table: torch.Tensor, pts_t: torch.Tensor, cfg: CellHashConfig):
    """(features (L*2, N), rows (L, N), the gathered bf16 rows (L, N, 16))."""
    packed = table.to(torch.bfloat16)
    scales, resolutions = cfg.level_scales(), cfg.level_resolutions()
    idx = _level_rows(pts_t, cfg)
    outs, vs = [], []
    for lvl in range(cfg.n_levels):
        _, frac = _cell_and_frac(pts_t, scales[lvl], int(resolutions[lvl]))
        wt = _trilinear_w(frac).T  # (N, 8)
        v = packed[lvl][idx[lvl]]  # (N, 16): ONE row gather per point
        outs.append(torch.stack([torch.sum(v[:, 0::2].float() * wt, dim=1),
                                 torch.sum(v[:, 1::2].float() * wt, dim=1)]))
        vs.append(v)
    return torch.cat(outs, dim=0), idx, torch.stack(vs)


def _cell_bwd(cfg: CellHashConfig, idx: torch.Tensor, v: torch.Tensor, pts_t: torch.Tensor, g: torch.Tensor,
              u: Optional[torch.Tensor], need_table: bool, need_pts: bool):
    """(d_table (L, T, 16), d_pts (3, N)) from the cotangent g (L*2, N); a
    ``u`` (L, N) samples one corner per scattered row."""
    l, n = idx.shape
    g = g.reshape(l, 2, n)
    scales, resolutions = cfg.level_scales(), cfg.level_resolutions()
    t = cfg.table_size
    level1 = cfg.bwd == "level1"
    d_table = d_pts = None

    def rows(w, g_l):  # upd[n, c*2 + f] = w[c, n] * g[f, n]
        return (w.T[:, :, None] * g_l.T[:, None, :]).reshape(n, 16)

    if need_table:
        d_table = torch.zeros((l * t, 16), dtype=torch.float32, device=g.device)
        if level1:
            choice = _jitter_level_choice(pts_t, l)  # (N,)
            g_sel = torch.gather(g, 0, choice[None, None, :].expand(1, 2, n))[0]  # (2, N)
            scale_sel = torch.as_tensor(scales.astype(np.float32), device=g.device)[choice]
            scaled = pts_t * scale_sel[None, :] + 0.5
            w_sel = _trilinear_w(scaled - torch.floor(scaled))
            if u is not None:
                w_sel = _corner_sample_w(w_sel, u[0])
            combined = choice * t + torch.gather(idx, 0, choice[None, :])[0]
            d_table.index_add_(0, combined, rows(w_sel, g_sel) * float(l))
    if need_pts:
        d_pts = torch.zeros_like(pts_t)
        corner_f = torch.as_tensor(_CORNERS, dtype=torch.float32, device=g.device)[:, :, None]  # (8, 3, 1)
        sign = 2.0 * corner_f - 1.0
    for lvl in range(l):
        _, frac = _cell_and_frac(pts_t, scales[lvl], int(resolutions[lvl]))
        if need_table and not level1:
            w = _trilinear_w(frac)
            if u is not None:
                w = _corner_sample_w(w, u[lvl])
            d_table.index_add_(0, idx[lvl] + lvl * t, rows(w, g[lvl]))
        if need_pts:
            pc = v[lvl, :, 0::2].float().T * g[lvl, 0][None, :] + v[lvl, :, 1::2].float().T * g[lvl, 1][None, :]
            d_pts = d_pts + _dfrac(pc, frac, corner_f, sign) * f32_scale(scales[lvl])
    if d_table is not None:
        d_table = d_table.reshape(l, t, 16)
    return d_table, d_pts


class _CellEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, pts_t, cfg, sample, key, u):
        out, idx, v = _cell_fwd(table, pts_t, cfg)
        ctx.cfg, ctx.sample = cfg, sample
        ctx.save_for_backward(idx, v, pts_t, key, u)
        return out

    @staticmethod
    def backward(ctx, g):
        idx, v, pts_t, key, u = ctx.saved_tensors
        if ctx.sample and u is None and ctx.needs_input_grad[0]:
            u = uniforms_from_key(key, tuple(idx.shape), g.device)
        d_table, d_pts = _cell_bwd(ctx.cfg, idx, v, pts_t, g.contiguous(), u if ctx.sample else None,
                                   ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return d_table, d_pts, None, None, None, None


def cell_hash_encode_t(table: torch.Tensor, pts_t: torch.Tensor, cfg: CellHashConfig,
                       bwd_key: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(L*2, N) encoding of pts_t (3, N) in [0, 1], one row gather per
    (point, level), differentiable in the table (L, T, 16) and the points.
    ``bwd_key`` (two words) or ``u`` (L, N) turns on corner sampling in the
    table gradient."""
    sample = bwd_key is not None or u is not None
    key = None if bwd_key is None else torch.as_tensor(bwd_key).to(torch.int64)
    return _CellEncode.apply(table, pts_t.contiguous(), cfg, sample, key, u)
