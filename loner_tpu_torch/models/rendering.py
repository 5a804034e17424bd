"""Volume rendering: alpha compositing of field outputs along rays.

The port of ``loner_tpu/models/rendering.py``: the default compositing
strategy (relu sigma, a 1e10 terminal delta, expected depth with the
unterminated mass at the far plane, opacity, variance, and the colour rows'
weighted sums) and ``render_rays`` over the sigma field alone
(``sigma_only``, the lidar step) or both branches (the camera step). The
"adjusted" strategy is queue A item 1.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from loner_tpu_torch.models.nerf import NeRFConfig, query_nerf_t, query_sigma_t


class RenderResult(NamedTuple):
    rgb: torch.Tensor  # (N, num_colors), or a (N, 1) dummy (-1) when sigma_only
    depth: torch.Tensor  # (N,)
    weights: torch.Tensor  # (N, S)
    opacity: torch.Tensor  # (N,)
    variance: torch.Tensor  # (N,)
    z_vals: torch.Tensor  # (N, S)
    points: torch.Tensor  # (3, N, S) cube coords, transposed
    raw: torch.Tensor  # (C+1, N, S) or (1, N, S), transposed


def composite_t(
    raw_t: torch.Tensor,  # (C+1, N, S), or (1, N, S) when sigma_only: channels leading
    z_vals: torch.Tensor,  # (N, S)
    rays_d: torch.Tensor,  # (N, 3)
    far: Optional[torch.Tensor] = None,  # (N,): depth includes far-plane mass
    sigma_only: bool = True,
    num_colors: int = 3,
):
    """(rgb, depth, weights, opacity, variance). ``rgb`` is (N, num_colors),
    or a (N, 1) dummy of -1 when ``sigma_only``."""
    sigmas = raw_t[0] if sigma_only else raw_t[num_colors]
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], 1e10)], dim=-1)
    # eps-safe norm: padded rays have zero directions; a bare norm gives NaN
    # gradients there that leak past the loss mask into the pose gradients
    d_norm = torch.sqrt(torch.sum(rays_d * rays_d, dim=-1, keepdim=True) + 1e-20)
    deltas = deltas * d_norm

    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10], dim=-1), dim=-1
    )[:, :-1]
    weights = alphas * trans
    opacity = torch.sum(weights, dim=-1)
    depth = torch.sum(weights * z_vals, dim=-1)
    if far is not None:
        depth = depth + (1.0 - opacity) * far
    if sigma_only:
        rgb = torch.full((sigmas.shape[0], 1), -1.0, dtype=sigmas.dtype, device=sigmas.device)
    else:
        rgb = torch.einsum("ns,cns->nc", weights, raw_t[:num_colors])
    variance = torch.sum(weights * (depth[:, None] - z_vals) ** 2, dim=-1)
    return rgb, depth, weights, opacity, variance


def _chunked(fn, x_t: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """``fn`` over the last axis of ``x_t`` in ``n_chunks`` sequential chunks
    when that divides it (else in one), the results concatenated on it."""
    n = x_t.shape[-1]
    if n_chunks <= 1 or n % n_chunks != 0:
        return fn(x_t)
    return torch.cat([fn(c) for c in x_t.chunk(n_chunks, dim=-1)], dim=-1)


def render_rays(params: dict, bundle, z_vals: torch.Tensor, cfg: NeRFConfig,
                key: Optional[torch.Tensor] = None, point_chunks: Optional[int] = None, sigma_only: bool = True,
                detach_sigma: bool = True, key_intensity: Optional[torch.Tensor] = None) -> RenderResult:
    """Evaluate the field at o + d*z and composite. ``sigma_only`` (the
    lidar step's render) queries the sigma branch alone; otherwise both
    branches with the view directions repeated over the samples, the sigma
    branch without gradients when ``detach_sigma``. The points go to the
    field in ``point_chunks`` (``cfg.point_chunks`` when None) sequential
    chunks when that divides them, else in one. ``key`` and
    ``key_intensity`` draw the encoders' strided table gradients."""
    n, s = z_vals.shape
    if point_chunks is None:
        point_chunks = cfg.point_chunks
    pts_t = bundle.origins.T[:, :, None] + bundle.directions.T[:, :, None] * z_vals[None]  # (3, N, S)
    flat = pts_t.reshape(3, n * s)
    if sigma_only:
        raw_t = _chunked(lambda p: query_sigma_t(params, p, cfg, key), flat, point_chunks).reshape(1, n, s)
    else:
        dirs_t = bundle.viewdirs.T[:, :, None].expand(3, n, s).reshape(3, n * s)
        raw_t = _chunked(
            lambda x: query_nerf_t(params, x[:3], x[3:], cfg, False, detach_sigma, key, key_intensity),
            torch.cat([flat, dirs_t]), point_chunks,
        ).reshape(-1, n, s)
    rgb, depth, weights, opacity, variance = composite_t(raw_t, z_vals, bundle.directions, bundle.far, sigma_only,
                                                         cfg.num_colors)
    return RenderResult(rgb, depth, weights, opacity, variance, z_vals, pts_t, raw_t)
