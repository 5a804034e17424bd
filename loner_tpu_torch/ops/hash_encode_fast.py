"""The "packed" hash-grid encoding: one level-fused gather of bf16 feature
pairs, with its own backward.

The port of ``loner_tpu/ops/hash_encode_fast.py``. Level scales, the tcnn
spatial hash and dense indexing are those of
:mod:`loner_tpu_torch.models.hash_encoding`. The forward reads the f32
master table ``(L, 2, T)`` rounded to bf16 (the JAX package packs each
pair into one 32-bit word; here the pairs are a ``(L*T, 2)`` bf16 table,
the same numbers) from one flat table with level-offset indices, and sums
in f32. The backward never gathers again:

  * d_table is the straight-through scatter-add, in the table's dtype (f32;
    a float64 table sums the same terms in float64), of (trilinear weight x
    cotangent) over all 8 corners, or, with corner sampling, of the
    cotangent alone into ONE corner per (level, point) drawn in proportion
    to its weight (unbiased, 8x fewer scatter rows);
  * d_pts is exact, from the bf16 features the forward read.

Corner sampling takes uniforms ``u`` (L, N), or draws them from a
``torch.Generator`` seeded from the two key words inside each call (the
JAX package draws ``uniform(key, (L, N))`` inside its backward).
"""
from __future__ import annotations

from typing import Optional

import torch

from loner_tpu_torch.models.hash_encoding import (
    _CORNERS,
    HashEncodingConfig,
    _corner_indices_t,
    _level_cells,
    _trilinear_w,
    f32_scale,
)


def _level_indices_t(pts_t: torch.Tensor, scale: float, res: int, dense: bool, table_size: int):
    """Corner table indices (8, N) and trilinear weights (8, N) of one level."""
    cells, frac = _level_cells(pts_t, scale)
    return _corner_indices_t(cells, res, dense, table_size), _trilinear_w(frac)


def _fused_indices(pts_t: torch.Tensor, cfg: HashEncodingConfig):
    """Level-fused corner indices (L, 8, N) into the flat (L*T,) table, and
    the trilinear weights (L, 8, N)."""
    scales, resolutions, dense = cfg.level_scales(), cfg.level_resolutions(), cfg.level_is_dense()
    idxs, ws = [], []
    for lvl in range(cfg.n_levels):
        idx, w = _level_indices_t(pts_t, scales[lvl], int(resolutions[lvl]), bool(dense[lvl]), cfg.table_size)
        idxs.append(idx + lvl * cfg.table_size)
        ws.append(w)
    return torch.stack(idxs), torch.stack(ws)


def _pack_pairs(table: torch.Tensor) -> torch.Tensor:
    """(L, 2, T) f32 -> (L*T, 2) bf16: each entry's feature pair."""
    l, f, t = table.shape
    if f != 2:
        raise ValueError("the packed encoder needs n_features_per_level == 2")
    return table.to(torch.bfloat16).permute(0, 2, 1).reshape(l * t, 2)


def uniforms_from_key(key: torch.Tensor, shape, device) -> torch.Tensor:
    """Uniforms in [0, 1) of ``shape`` from a ``torch.Generator`` on
    ``device`` seeded from the two key words (int64 in [0, 2^32)): the same
    words give the same draws on each call. Both words reach the seed's low
    32 bits, the only ones the CPU generator reads."""
    k0, k1 = (int(x) for x in key.reshape(-1)[:2].tolist())
    gen = torch.Generator(device=device).manual_seed((k0 << 32) | (((k0 * 2654435761) ^ k1) & 0xFFFFFFFF))
    return torch.rand(tuple(shape), generator=gen, device=device)


def _fwd(table: torch.Tensor, pts_t: torch.Tensor, cfg: HashEncodingConfig):
    """(features (L*2, N), indices (L, 8, N), weights (L, 8, N), the
    gathered bf16 pairs (L, 8, N, 2))."""
    idx, w = _fused_indices(pts_t, cfg)
    v = _pack_pairs(table)[idx]  # ONE fused gather
    f0, f1 = v[..., 0].float(), v[..., 1].float()
    out = torch.stack([torch.sum(w * f0, dim=1), torch.sum(w * f1, dim=1)], dim=1)  # (L, 2, N)
    return out.reshape(cfg.n_levels * 2, -1), idx, w, v


def _bwd(cfg: HashEncodingConfig, idx, w, v, pts_t, g, u: Optional[torch.Tensor], need_table: bool,
         need_pts: bool, dtype: torch.dtype = torch.float32):
    """(d_table (L, 2, T) of ``dtype``, d_pts (3, N)) from the cotangent g
    (L*2, N); a ``u`` (L, N) samples one corner per (level, point)."""
    l, c, n = idx.shape
    g = g.reshape(l, 2, n)
    d_table = d_pts = None
    if need_table:
        if u is not None:
            cdf = torch.cumsum(w, dim=1)  # (L, 8, N)
            choice = torch.clamp(torch.sum((u[:, None, :] > cdf).to(torch.int64), dim=1), 0, c - 1)  # (L, N)
            flat_idx = torch.gather(idx, 1, choice[:, None, :])[:, 0].reshape(-1)
            upd0, upd1 = g[:, 0].reshape(-1), g[:, 1].reshape(-1)
        else:
            flat_idx = idx.reshape(-1)
            upd0 = (w * g[:, 0][:, None, :]).reshape(-1)
            upd1 = (w * g[:, 1][:, None, :]).reshape(-1)
        size = l * cfg.table_size
        d0 = torch.zeros(size, dtype=dtype, device=g.device).index_add_(0, flat_idx, upd0.to(dtype))
        d1 = torch.zeros(size, dtype=dtype, device=g.device).index_add_(0, flat_idx, upd1.to(dtype))
        d_table = torch.stack([d0.reshape(l, cfg.table_size), d1.reshape(l, cfg.table_size)], dim=1)
    if need_pts:
        scales = cfg.level_scales()
        corner_f = torch.as_tensor(_CORNERS, dtype=torch.float32, device=g.device)[:, :, None]  # (8, 3, 1)
        sign = 2.0 * corner_f - 1.0
        per_corner = v[..., 0].float() * g[:, 0][:, None, :] + v[..., 1].float() * g[:, 1][:, None, :]  # (L, 8, N)
        d_pts = torch.zeros_like(pts_t)
        for lvl in range(l):
            scale = f32_scale(scales[lvl])
            scaled = pts_t * scale + 0.5
            frac = scaled - torch.floor(scaled)
            d_pts = d_pts + _dfrac(per_corner[lvl], frac, corner_f, sign) * scale
    return d_table, d_pts


def _dfrac(per_corner: torch.Tensor, frac: torch.Tensor, corner_f: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """d(sum over corners of per_corner * weight)/d frac (3, N): per axis,
    the signed product of the other two axes' weights."""
    w_axis = corner_f * frac[None] + (1 - corner_f) * (1 - frac[None])  # (8, 3, N)
    prod_others = torch.stack([w_axis[:, 1] * w_axis[:, 2], w_axis[:, 0] * w_axis[:, 2],
                               w_axis[:, 0] * w_axis[:, 1]], dim=1)  # (8, 3, N)
    return torch.sum(per_corner[:, None, :] * sign * prod_others, dim=0)


class _PackedEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, pts_t, cfg, sample, key, u):
        out, idx, w, v = _fwd(table, pts_t, cfg)
        ctx.cfg, ctx.sample, ctx.table_dtype = cfg, sample, table.dtype
        ctx.save_for_backward(idx, w, v, pts_t, key, u)
        return out

    @staticmethod
    def backward(ctx, g):
        idx, w, v, pts_t, key, u = ctx.saved_tensors
        if ctx.sample and u is None and ctx.needs_input_grad[0]:
            u = uniforms_from_key(key, (idx.shape[0], idx.shape[2]), g.device)
        d_table, d_pts = _bwd(ctx.cfg, idx, w, v, pts_t, g.contiguous(), u if ctx.sample else None,
                              ctx.needs_input_grad[0], ctx.needs_input_grad[1], ctx.table_dtype)
        return d_table, d_pts, None, None, None, None


def hash_encode_packed_t(table: torch.Tensor, pts_t: torch.Tensor, cfg: HashEncodingConfig,
                         bwd_key: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(L*2, N) encoding of pts_t (3, N) in [0, 1] at bf16 feature
    precision, differentiable in the table (L, 2, T) and the points.
    ``bwd_key`` (two words) or ``u`` (L, N) turns on the corner-sampled
    table gradient; with neither it is exact."""
    sample = bwd_key is not None or u is not None
    key = None if bwd_key is None else torch.as_tensor(bwd_key).to(torch.int64)
    return _PackedEncode.apply(table, pts_t.contiguous(), cfg, sample, key, u)

