"""TriadField's CP encoder in plain PyTorch, with no hash level.

CP feature lines (per level and axis a line of F features, linearly
interpolated; the level's features are the product of the three axes') and
sin/cos Fourier features. Lines are stored ``(3L, F, 128)``, rows past the
level's resolution zero. The backward's line gradient is a dense product
with each point's two hat weights, so it sums without atomics; the point
gradient is zero outside the open interval (0, 1). ``lower`` rounds the
features to bf16.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from benchmark.reference.precision import bf16_forward
from benchmark.roofline.kernels import cp_bwd, cp_fwd

CP_PAD_R = 128
_CHUNK = 1 << 18


def init_cp_lines(gen: torch.Generator, resolutions: Sequence[int], n_features: int, device) -> torch.Tensor:
    """(3L, F, 128): active rows 1 + 0.1 N(0, 1), padded rows zero."""
    n = 3 * len(resolutions)
    vals = torch.randn((n, n_features, CP_PAD_R), generator=gen, device=device)
    res = torch.tensor([int(resolutions[i // 3]) for i in range(n)], device=device)
    active = torch.arange(CP_PAD_R, device=device)[None, :] < res[:, None]
    return torch.where(active[:, None, :], 1.0 + 0.1 * vals, torch.zeros_like(vals))


def init(gen: torch.Generator, field: dict, device) -> dict:
    return {"cp": init_cp_lines(gen, field["cp_resolutions"], field["cp_features"], device)}


def encoding_dim(field: dict) -> int:
    return len(field["cp_resolutions"]) * field["cp_features"] + 6 * field["fourier_freqs"]


def _axis_iwf(x: torch.Tensor, res: int):
    pix = torch.clamp(x, 0.0, 1.0) * (res - 1)
    i0 = torch.clamp(torch.floor(pix), 0, res - 2).long()
    return i0, pix - i0.to(pix.dtype)


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


def encode(table: dict, pts: torch.Tensor, field: dict, lower: bool = False) -> torch.Tensor:
    h = torch.cat([_CP.apply(table["cp"], pts, tuple(int(r) for r in field["cp_resolutions"])),
                   fourier_t(pts, field["fourier_freqs"])], dim=0)
    return bf16_forward(h) if lower else h


def flops(n: int, field: dict, backward: bool) -> float:
    """B1's interpolation, and with ``backward`` B2's."""
    shape = cp_fwd.shape(field)
    return cp_fwd.counts(n, *shape)[1] + (cp_bwd.counts(n, *shape)[1] if backward else 0.0)
