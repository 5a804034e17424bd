"""The sigma field in plain PyTorch: encoders, MLP and their initial weights.

Two encoders, each with its forward and its hand-written backward:

* ``triad``: CP feature lines (per level and axis a line of F features,
  linearly interpolated; the level's features are the product of the three
  axes') and sin/cos Fourier features. Lines are stored ``(3L, F, 128)``,
  rows past the level's resolution zero. The backward's line gradient is a
  dense product with each point's two hat weights, so it sums without
  atomics; the point gradient is zero outside the open interval (0, 1).
* ``fused``: the multi-resolution hash grid with one row of 8 corners x F
  features per cell (``(L, T, 8F)`` f32 master table, gathered as bf16), the
  table gradient exact: every point and level adds its weighted row.

The sigma MLP rounds its operands to bf16 and multiplies in f32 (so the
weight gradient is rounded to bf16 too). ``lower=True`` computes the field
one precision step down, as the control of the benchmark's check: the MLP's
operands rounded on to fp8 (e4m3, scaled per tensor) and the encoder's
features to bf16.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

CP_PAD_R = 128
_PRIMES = (1, 2654435761, 805459861)


# ---------------------------------------------------------------------------
# initial weights, made from a generator in a few large calls
# ---------------------------------------------------------------------------


def init_cp_lines(gen: torch.Generator, resolutions: Sequence[int], n_features: int, device) -> torch.Tensor:
    """(3L, F, 128): active rows 1 + 0.1 N(0, 1), padded rows zero."""
    n = 3 * len(resolutions)
    vals = torch.randn((n, n_features, CP_PAD_R), generator=gen, device=device)
    res = torch.tensor([int(resolutions[i // 3]) for i in range(n)], device=device)
    active = torch.arange(CP_PAD_R, device=device)[None, :] < res[:, None]
    return torch.where(active[:, None, :], 1.0 + 0.1 * vals, torch.zeros_like(vals))


def init_fused_table(gen: torch.Generator, n_levels: int, log2_cells: int, n_features: int, device) -> torch.Tensor:
    """(L, T, 8F) uniform in [-1e-4, 1e-4)."""
    return torch.rand((n_levels, 1 << log2_cells, 8 * n_features), generator=gen, device=device) * 2e-4 - 1e-4


def init_mlp(gen: torch.Generator, in_dim: int, hidden: int, layers: int, out_dim: int, device) -> dict:
    """He-normal weights (in, out), zero biases."""
    dims = [in_dim] + [hidden] * layers + [out_dim]
    ws = [torch.randn((dims[i], dims[i + 1]), generator=gen, device=device) * math.sqrt(2.0 / dims[i])
          for i in range(len(dims) - 1)]
    return {"w": ws, "b": [torch.zeros((d,), device=device) for d in dims[1:]]}


def init_sigma(gen: torch.Generator, field: dict, device) -> dict:
    """The sigma branch's parameters ``{"table": ..., "mlp": ...}`` for the
    configuration's ``field`` block."""
    if field["encoder"] == "triad":
        table = {"cp": init_cp_lines(gen, field["cp_resolutions"], field["cp_features"], device)}
    else:
        table = init_fused_table(gen, field["hash_levels"], field["hash_log2_cells"], field["hash_features"], device)
    mlp = init_mlp(gen, encoding_dim(field), field["sigma_hidden_dim"], field["sigma_hidden_layers"], 1, device)
    return {"table": table, "mlp": mlp}


def encoding_dim(field: dict) -> int:
    if field["encoder"] == "triad":
        return len(field["cp_resolutions"]) * field["cp_features"] + 6 * field["fourier_freqs"]
    return field["hash_levels"] * field["hash_features"]


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _fp8_forward(x: torch.Tensor) -> torch.Tensor:
    """x's values rounded to fp8 (e4m3) under a per-tensor scale that maps
    its largest magnitude to fp8's largest (448), as an fp8 GEMM takes its
    operands; its gradient passed as it is."""
    xd = x.detach()
    scale = 448.0 / torch.clamp(torch.amax(torch.abs(xd)), min=1e-30)
    return x + ((xd * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale - xd)


def _bf16_forward(x: torch.Tensor) -> torch.Tensor:
    return x + (_bf16(x.detach()) - x.detach())


# ---------------------------------------------------------------------------
# CP lines
# ---------------------------------------------------------------------------


def _axis_iwf(x: torch.Tensor, res: int):
    pix = torch.clamp(x, 0.0, 1.0) * (res - 1)
    i0 = torch.clamp(torch.floor(pix), 0, res - 2).long()
    return i0, pix - i0.to(pix.dtype)


_CHUNK = 1 << 18


class _CP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lines, pts, resolutions):
        ctx.save_for_backward(lines, pts)
        ctx.resolutions = resolutions
        outs = []
        for lvl, res in enumerate(resolutions):
            feats = []
            for a in range(3):
                line = lines[3 * lvl + a]
                i0, f = _axis_iwf(pts[a], res)
                feats.append(line[:, i0] * (1.0 - f)[None, :] + line[:, i0 + 1] * f[None, :])
            outs.append(feats[0] * feats[1] * feats[2])
        return torch.cat(outs, dim=0)

    @staticmethod
    def backward(ctx, g):
        lines, pts = ctx.saved_tensors
        nf = lines.shape[1]
        dlines = torch.zeros_like(lines)
        dpts = torch.zeros_like(pts)
        live = (pts > 0.0) & (pts < 1.0)
        for lvl, res in enumerate(ctx.resolutions):
            gl = g[lvl * nf:(lvl + 1) * nf]
            iwf, feats, diffs = [], [], []
            for a in range(3):
                line = lines[3 * lvl + a]
                i0, f = _axis_iwf(pts[a], res)
                v0, v1 = line[:, i0], line[:, i0 + 1]
                iwf.append((i0, f))
                feats.append(v0 * (1.0 - f)[None, :] + v1 * f[None, :])
                diffs.append(v1 - v0)
            for a in range(3):
                gother = gl * feats[(a + 1) % 3] * feats[(a + 2) % 3]
                dxa = torch.sum(gother * diffs[a], dim=0) * float(res - 1)
                dpts[a] += torch.where(live[a], dxa, torch.zeros_like(dxa))
                i0, f = iwf[a]
                for s in range(0, pts.shape[1], _CHUNK):
                    e = min(s + _CHUNK, pts.shape[1])
                    hat = torch.zeros((e - s, CP_PAD_R), device=pts.device)
                    hat.scatter_add_(1, torch.stack([i0[s:e], i0[s:e] + 1], dim=1),
                                     torch.stack([1.0 - f[s:e], f[s:e]], dim=1))
                    dlines[3 * lvl + a] += gother[:, s:e] @ hat
        return dlines, dpts, None


def fourier_t(pts: torch.Tensor, n_freqs: int) -> torch.Tensor:
    p = 2.0 * pts - 1.0
    outs = []
    for j in range(n_freqs):
        arg = p * (math.pi * (2.0**j))
        outs.append(torch.sin(arg))
        outs.append(torch.cos(arg))
    return torch.cat(outs, dim=0)


# ---------------------------------------------------------------------------
# hash grid, one row per cell
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# the sigma query
# ---------------------------------------------------------------------------


def encode(table, pts: torch.Tensor, field: dict, lower: bool = False) -> torch.Tensor:
    """(D, N) features of points (3, N) in [0, 1]."""
    if field["encoder"] == "triad":
        h = torch.cat([_CP.apply(table["cp"], pts, tuple(int(r) for r in field["cp_resolutions"])),
                       fourier_t(pts, field["fourier_freqs"])], dim=0)
    else:
        h = _Hash.apply(pts, table, field)
    return _bf16_forward(h) if lower else h


def mlp_t(params: dict, x: torch.Tensor, lower: bool = False) -> torch.Tensor:
    """(out, N) of x (in, N): bf16 operands, f32 products, relu between."""
    n = len(params["w"])
    h = x
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        wo, ho = _bf16(w.T), _bf16(h)
        if lower:
            wo, ho = _fp8_forward(wo), _fp8_forward(ho)
        h = wo @ ho + b[:, None]
        if i < n - 1:
            h = torch.relu(h)
    return h


def sigma_t(params: dict, pts_cube: torch.Tensor, field: dict, lower: bool = False) -> torch.Tensor:
    """Sigma logits (N,) of cube points (3, N) in [-1, 1]."""
    h = encode(params["table"], (pts_cube + 1.0) / 2.0, field, lower)
    sigma = mlp_t(params["mlp"], h, lower)[0]
    return torch.nan_to_num(sigma, nan=0.0, posinf=3.4e38, neginf=-3.4e38)
