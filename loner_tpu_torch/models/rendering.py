"""Volume rendering: alpha compositing of field outputs along rays.

The port of ``loner_tpu/models/rendering.py`` for the train step: the default
compositing strategy (relu sigma, a 1e10 terminal delta, expected depth with
the unterminated mass at the far plane, opacity, variance) and a sigma-only
``render_rays``. The intensity branch and the "adjusted" strategy come with
later slices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from loner_tpu_torch.models.nerf import NeRFConfig, query_sigma_t


class RenderResult(NamedTuple):
    rgb: torch.Tensor  # (N, 1) dummy (-1) when sigma_only
    depth: torch.Tensor  # (N,)
    weights: torch.Tensor  # (N, S)
    opacity: torch.Tensor  # (N,)
    variance: torch.Tensor  # (N,)
    z_vals: torch.Tensor  # (N, S)
    points: torch.Tensor  # (3, N, S) cube coords, transposed
    raw: torch.Tensor  # (1, N, S), transposed


def composite_t(
    raw_t: torch.Tensor,  # (1, N, S) sigma, channel leading
    z_vals: torch.Tensor,  # (N, S)
    rays_d: torch.Tensor,  # (N, 3)
    far: Optional[torch.Tensor] = None,  # (N,): depth includes far-plane mass
):
    """(rgb, depth, weights, opacity, variance) of a sigma-only field (the
    JAX package's ``composite_t(..., sigma_only=True)``)."""
    sigmas = raw_t[0]
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
    rgb = torch.full((sigmas.shape[0], 1), -1.0, dtype=sigmas.dtype, device=sigmas.device)
    variance = torch.sum(weights * (depth[:, None] - z_vals) ** 2, dim=-1)
    return rgb, depth, weights, opacity, variance


def render_rays(params: dict, bundle, z_vals: torch.Tensor, cfg: NeRFConfig,
                key: Optional[torch.Tensor] = None, point_chunks: Optional[int] = None) -> RenderResult:
    """Evaluate the sigma field at o + d*z and composite (the JAX package's
    ``render_rays(..., sigma_only=True)``). The points go to the field in
    ``point_chunks`` (``cfg.point_chunks`` when None) sequential chunks when
    that divides them, else in one; ``key`` draws the encoder's strided table
    gradient."""
    n, s = z_vals.shape
    if point_chunks is None:
        point_chunks = cfg.point_chunks
    pts_t = bundle.origins.T[:, :, None] + bundle.directions.T[:, :, None] * z_vals[None]  # (3, N, S)
    flat = pts_t.reshape(3, n * s)
    if point_chunks > 1 and (n * s) % point_chunks == 0:
        sigma = torch.cat([query_sigma_t(params, c, cfg, key) for c in flat.chunk(point_chunks, dim=1)])
    else:
        sigma = query_sigma_t(params, flat, cfg, key)
    raw_t = sigma.reshape(1, n, s)
    rgb, depth, weights, opacity, variance = composite_t(raw_t, z_vals, bundle.directions, far=bundle.far)
    return RenderResult(rgb, depth, weights, opacity, variance, z_vals, pts_t, raw_t)
