"""The multi-resolution hash grid in plain PyTorch, one row a cell.

A level's table holds one row of 8 corners x F features per cell
(``(L, T, 8F)`` f32 master table, gathered as bf16), cells indexed densely
where the level's grid fits the table and hashed otherwise. The table
gradient is exact: every point and level adds its weighted row. ``lower``
rounds the features to bf16.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.precision import bf16_forward
from benchmark.roofline.kernels import hash_dpts, hash_fwd

_PRIMES = (1, 2654435761, 805459861)


def init_fused_table(gen: torch.Generator, n_levels: int, log2_cells: int, n_features: int, device) -> torch.Tensor:
    """(L, T, 8F) uniform in [-1e-4, 1e-4)."""
    return torch.rand((n_levels, 1 << log2_cells, 8 * n_features), generator=gen, device=device) * 2e-4 - 1e-4


def init(gen: torch.Generator, field: dict, device) -> torch.Tensor:
    return init_fused_table(gen, field["hash_levels"], field["hash_log2_cells"], field["hash_features"], device)


def encoding_dim(field: dict) -> int:
    return field["hash_levels"] * field["hash_features"]


def level_scales(field: dict) -> np.ndarray:
    ls = np.arange(field["hash_levels"], dtype=np.float64)
    return (field["hash_base_resolution"] * field["hash_per_level_scale"] ** ls - 1.0).astype(np.float32)


def _level_indices(pts: torch.Tensor, field: dict, lvl: int) -> torch.Tensor:
    scale = float(level_scales(field)[lvl])
    res = int(np.ceil(np.float64(scale))) + 1
    size = 1 << field["hash_log2_cells"]
    scaled = pts * scale + 0.5
    cells = torch.clamp(torch.floor(scaled).long(), 0, res - 1)
    if res ** 3 <= size:
        return cells[0] + cells[1] * res + cells[2] * (res * res)
    h = (cells[0] * _PRIMES[0]) ^ (cells[1] * _PRIMES[1]) ^ (cells[2] * _PRIMES[2])
    return h & (size - 1)


def _axis_weights(pts: torch.Tensor, scale: float):
    scaled = pts * scale + 0.5
    frac = scaled - torch.floor(scaled)
    fx, fy, fz = frac[0], frac[1], frac[2]
    wx = torch.stack([fx if b & 1 else 1.0 - fx for b in range(8)])
    wy = torch.stack([fy if b & 2 else 1.0 - fy for b in range(8)])
    wz = torch.stack([fz if b & 4 else 1.0 - fz for b in range(8)])
    return wx, wy, wz


class _Hash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts, table, field):
        nf = field["hash_features"]
        tab_t = table.to(torch.bfloat16).transpose(1, 2)
        v_t = torch.stack([tab_t[lvl][:, _level_indices(pts, field, lvl)] for lvl in range(table.shape[0])])
        outs = []
        for lvl, scale in enumerate(level_scales(field)):
            wx, wy, wz = _axis_weights(pts, float(scale))
            w = wx * wy * wz
            v = v_t[lvl].float()
            for f in range(nf):
                outs.append(torch.sum(v[8 * f:8 * f + 8] * w, dim=0))
        ctx.save_for_backward(pts, v_t)
        ctx.field = field
        ctx.table_shape = table.shape
        return torch.stack(outs)

    @staticmethod
    def backward(ctx, g):
        pts, v_t = ctx.saved_tensors
        field = ctx.field
        nf = field["hash_features"]
        dpts = torch.zeros_like(pts) if ctx.needs_input_grad[0] else None
        dtable = torch.zeros(ctx.table_shape, dtype=torch.float32, device=pts.device)
        sign = [torch.tensor([1.0 if b & m else -1.0 for b in range(8)], device=pts.device)[:, None] for m in (1, 2, 4)]
        for lvl, scale in enumerate(level_scales(field)):
            wx, wy, wz = _axis_weights(pts, float(scale))
            gl = g[nf * lvl:nf * lvl + nf]
            if dpts is not None:
                v = v_t[lvl].float()
                pc = sum(v[8 * f:8 * f + 8] * gl[f][None, :] for f in range(nf))
                d = torch.stack([torch.sum(sign[0] * wy * wz * pc, dim=0), torch.sum(sign[1] * wx * wz * pc, dim=0),
                                 torch.sum(sign[2] * wx * wy * pc, dim=0)])
                dpts = dpts + d * float(scale)
            w = wx * wy * wz
            upd = (gl.T[:, :, None] * w.T[:, None, :]).reshape(w.shape[1], -1)
            dtable[lvl].index_add_(0, _level_indices(pts, field, lvl), upd)
        return dpts, dtable, None


def encode(table: torch.Tensor, pts: torch.Tensor, field: dict, lower: bool = False) -> torch.Tensor:
    h = _Hash.apply(pts, table, field)
    return bf16_forward(h) if lower else h


def flops(n: int, field: dict, backward: bool) -> float:
    """B4's interpolation, and with ``backward`` B5's and the table gradient's
    8 weights times F features a point and level."""
    lv, f = hash_fwd.shape(field)
    return hash_fwd.counts(n, lv, f)[1] + ((hash_dpts.counts(n, lv, f)[1] + 16.0 * f * lv * n) if backward else 0.0)
