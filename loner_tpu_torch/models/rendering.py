"""Volume rendering: alpha compositing of field outputs along rays.

The port of ``loner_tpu/models/rendering.py``: the default compositing
strategy (relu sigma, a 1e10 terminal delta, expected depth with the
unterminated mass at the far plane, opacity, variance, and the colour rows'
weighted sums), FDT's "adjusted" strategy (``composite_peak_adjusted``:
the depth where transmittance first drops under 0.5, resampled or dropped
by the rise-delta peak tests), and ``render_rays`` over the sigma field
alone (``sigma_only``, the lidar step) or both branches (the camera step).
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


def _alphas_and_transmittance(sigmas: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor):
    """(alphas, T), each (N, S): each sample's opacity from relu sigma over
    its interval (a 1e10 terminal one), and the transmittance before it."""
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], 1e10)], dim=-1)
    # eps-safe norm: padded rays have zero directions; a bare norm gives NaN
    # gradients there that leak past the loss mask into the pose gradients
    d_norm = torch.sqrt(torch.sum(rays_d * rays_d, dim=-1, keepdim=True) + 1e-20)
    alphas = 1.0 - torch.exp(-(deltas * d_norm) * torch.relu(sigmas))
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10], dim=-1), dim=-1
    )[:, :-1]
    return alphas, trans


def _weights_and_colours(raw_t: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor, sigma_only: bool,
                         num_colors: int):
    """(rgb, weights, opacity, T) of :func:`composite_t`, with T the
    transmittance before each sample. ``rgb`` is (N, num_colors), or a
    (N, 1) dummy of -1 when ``sigma_only``."""
    sigmas = raw_t[0] if sigma_only else raw_t[num_colors]
    alphas, trans = _alphas_and_transmittance(sigmas, z_vals, rays_d)
    weights = alphas * trans
    opacity = torch.sum(weights, dim=-1)
    if sigma_only:
        rgb = torch.full((sigmas.shape[0], 1), -1.0, dtype=sigmas.dtype, device=sigmas.device)
    else:
        rgb = torch.einsum("ns,cns->nc", weights, raw_t[:num_colors])
    return rgb, weights, opacity, trans


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
    rgb, weights, opacity, _ = _weights_and_colours(raw_t, z_vals, rays_d, sigma_only, num_colors)
    depth = torch.sum(weights * z_vals, dim=-1)
    if far is not None:
        depth = depth + (1.0 - opacity) * far
    variance = torch.sum(weights * (depth[:, None] - z_vals) ** 2, dim=-1)
    return rgb, depth, weights, opacity, variance


def composite_peak_adjusted(
    raw_t: torch.Tensor,  # (C+1, N, S), or (1, N, S) when sigma_only
    z_vals: torch.Tensor,  # (N, S)
    rays_d: torch.Tensor,  # (N, 3)
    far: Optional[torch.Tensor] = None,
    sigma_only: bool = True,
    num_colors: int = 3,
    termination_threshold: float = 0.5,
    prominence_threshold_max: float = 0.45,
    prominence_threshold_min: float = 0.35,
):
    """FDT's "adjusted" strategy for foliage-like multi-return rays: rgb,
    weights and opacity as :func:`composite_t`; the depth is z at the first
    sample where the transmittance T falls to 0.5 or under (0, invalid,
    where it never does). T's crossings of 0.9, 0.8, 0.7, 0.6 and 0.501 give
    four rise deltas, normalised by the 0.501 crossing's depth; of the two
    smallest (the steepest segments), adjacent ones (|i2 - i1| == 1) or a
    prominent first (m1 / |m1 + m2| > 0.45) resample the depth at the
    steepest segment's crossing, and maximally separated ones (== 3) or a
    faint first (m1 / mean < 0.35) drop the ray (depth 0; dropping wins).
    T never increases, so each threshold has at most one crossing: an
    argmax per ray. The order of the deltas is a stable sort (ties are
    common: a sharp wall crosses several thresholds at one sample), and
    0/0 stays NaN, whose comparisons are false: a perfectly sharp wall is
    neither resampled nor dropped."""
    rgb, weights, opacity, T = _weights_and_colours(raw_t, z_vals, rays_d, sigma_only, num_colors)
    T_shifted = torch.cat([torch.ones_like(T[:, :1]), T[:, :-1]], dim=-1)
    zero = torch.zeros((), dtype=z_vals.dtype, device=z_vals.device)

    def crossing(th):
        """(depth, sample index, crossed?) of the unique crossing of ``th``."""
        mask = ~(T > th) & (T_shifted > th)
        any_c = torch.any(mask, dim=-1)
        idx = torch.argmax(mask.to(torch.uint8), dim=-1)  # the first crossing
        d = torch.gather(z_vals, 1, idx[:, None])[:, 0]
        return torch.where(any_c, d, zero), idx, any_c

    depth_term, _, valid = crossing(termination_threshold)
    cross = [crossing(th) for th in (0.9, 0.8, 0.7, 0.6, 0.501)]
    d_th = torch.stack([c[0] for c in cross])  # (5, N)
    i_th = torch.stack([c[1] for c in cross])  # (5, N)

    norm_rise = (d_th[1:] - d_th[:-1]) / (d_th[-1] + 1e-10)  # (4, N)
    order = torch.argsort(norm_rise, dim=0, stable=True)  # ascending: the steepest first
    i1, i2 = order[0], order[1]
    m1 = torch.gather(norm_rise, 0, i1[None])[0]
    m2 = torch.gather(norm_rise, 0, i2[None])[0]
    steep_idx = torch.gather(i_th, 0, i1[None])[0]
    steep_depth = torch.gather(z_vals, 1, steep_idx[:, None])[:, 0]

    iso = torch.abs(i2 - i1)
    resample = (iso == 1) | (m1 / torch.abs(m1 + m2) > prominence_threshold_max)
    drop = (iso == 3) | (m1 / torch.mean(norm_rise, dim=0) < prominence_threshold_min)

    depth = torch.where(valid & resample, steep_depth, depth_term)
    depth = torch.where(valid & drop, zero, depth)  # dropping wins
    depth = torch.where(valid, depth, zero)
    variance = torch.sum(weights * (depth[:, None] - z_vals) ** 2, dim=-1)
    return rgb, depth, weights, opacity, variance


_STRATEGIES = {"default": composite_t, "adjusted": composite_peak_adjusted}


def _chunked(fn, x_t: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """``fn`` over the last axis of ``x_t`` in ``n_chunks`` sequential chunks
    when that divides it (else in one), the results concatenated on it."""
    n = x_t.shape[-1]
    if n_chunks <= 1 or n % n_chunks != 0:
        return fn(x_t)
    return torch.cat([fn(c) for c in x_t.chunk(n_chunks, dim=-1)], dim=-1)


def render_rays(params: dict, bundle, z_vals: torch.Tensor, cfg: NeRFConfig,
                key: Optional[torch.Tensor] = None, point_chunks: Optional[int] = None, sigma_only: bool = True,
                detach_sigma: bool = True, key_intensity: Optional[torch.Tensor] = None,
                render_strategy: str = "default") -> RenderResult:
    """Evaluate the field at o + d*z and composite by ``render_strategy``
    ("default": :func:`composite_t`; "adjusted":
    :func:`composite_peak_adjusted`). ``sigma_only`` (the
    lidar step's render) queries the sigma branch alone; otherwise both
    branches with the view directions repeated over the samples, the sigma
    branch without gradients when ``detach_sigma``. The points go to the
    field in ``point_chunks`` (``cfg.point_chunks`` when None) sequential
    chunks when that divides them, else in one. ``key`` and
    ``key_intensity`` draw the encoders' strided table gradients."""
    if render_strategy not in _STRATEGIES:
        raise ValueError(f"Unknown render strategy: {render_strategy}")
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
    rgb, depth, weights, opacity, variance = _STRATEGIES[render_strategy](
        raw_t, z_vals, bundle.directions, bundle.far, sigma_only, cfg.num_colors)
    return RenderResult(rgb, depth, weights, opacity, variance, z_vals, pts_t, raw_t)
