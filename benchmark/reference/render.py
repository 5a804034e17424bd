"""Sampling, compositing, the lidar loss and the occupancy grid's update, in
plain PyTorch.

The sampler is occupancy-guided: half the samples stratified between near
and far, half drawn by inverse CDF from the grid's occupancy along the
stratified ones, merged and sorted, with the exact affine gradient of
(near, far) re-attached. Compositing is alpha compositing of relu sigma
with a 1e10 terminal interval and the unterminated mass at the far plane.
The loss is LONER's L1_JS lidar loss. The grid's gradient is the per-sample
log-odds target pushed back through the trilinear interpolation, one
corner a sample drawn with probability equal to its weight.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.field import sigma_t
from benchmark.reference.geometry import Rays


# ---------------------------------------------------------------------------
# occupancy grid (V, V, V) logits, axes [z, y, x], corners of the zero-padded
# grid packed one row of 8 a cell
# ---------------------------------------------------------------------------


def _packed_cells(grid: torch.Tensor) -> torch.Tensor:
    v = grid.shape[0]
    padded = torch.nn.functional.pad(grid, (1, 1, 1, 1, 1, 1))
    slabs = [padded[dz:dz + v + 1, dy:dy + v + 1, dx:dx + v + 1] for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    return torch.stack(slabs, dim=-1).reshape((v + 1) ** 3, 8)


def _corners(points: torch.Tensor, v: int):
    pix = ((points + 1.0) * v - 1.0) / 2.0
    lo = torch.floor(pix)
    frac = pix - lo
    cell = lo.long() + 1
    inb = torch.all((cell >= 0) & (cell <= v), dim=0)
    cc = torch.clamp(cell, 0, v)
    lin = cc[2] * ((v + 1) * (v + 1)) + cc[1] * (v + 1) + cc[0]
    x1, y1, z1 = frac[0], frac[1], frac[2]
    x0, y0, z0 = 1.0 - x1, 1.0 - y1, 1.0 - z1
    w = torch.stack([z0 * y0 * x0, z0 * y0 * x1, z0 * y1 * x0, z0 * y1 * x1,
                     z1 * y0 * x0, z1 * y0 * x1, z1 * y1 * x0, z1 * y1 * x1], dim=-1)
    return lin, inb, w


def occupancy_probs(grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    lin, inb, w = _corners(points, grid.shape[0])
    logits = torch.where(inb, torch.sum(_packed_cells(grid)[lin] * w, dim=-1), torch.zeros_like(w[..., 0]))
    return 2.0 * (torch.clamp(torch.sigmoid(logits), 0.5, 1.0) - 0.5)


def occupancy_gradient(grid: torch.Tensor, points: torch.Tensor, z_metric: torch.Tensor, depth_metric: torch.Tensor,
                       valid: torch.Tensor, u: torch.Tensor, eps: float = 2.0, l_free: float = 0.25,
                       l_occ: float = 2.5, estimator: str = "stochastic") -> torch.Tensor:
    """The grid's gradient: the exact transpose of the interpolation (all 8
    corners) or its stochastic one-corner estimate."""
    v = grid.shape[0]
    p1 = v + 1
    x = z_metric - depth_metric
    zero = torch.zeros_like(x)
    target = l_free * torch.heaviside(-x - eps, zero) - l_occ * torch.heaviside(x + eps, zero) * torch.heaviside(eps - x, zero)
    target = target * valid[:, None].to(target.dtype)
    lin, inb, w = _corners(points, v)
    g = torch.where(inb, target, torch.zeros_like(target))
    if estimator == "exact":
        packed = torch.zeros((p1 ** 3, 8), dtype=grid.dtype, device=grid.device)
        packed.index_add_(0, lin.reshape(-1), (g[..., None] * w).reshape(-1, 8))
    else:
        corner = torch.clamp(torch.sum((u[..., None] > torch.cumsum(w, dim=-1)).long(), dim=-1), 0, 7)
        packed = torch.zeros((p1 ** 3 * 8,), dtype=grid.dtype, device=grid.device)
        packed.index_add_(0, (lin * 8 + corner).reshape(-1), g.reshape(-1))
    packed = packed.reshape(p1, p1, p1, 8)
    padded = torch.zeros((v + 2,) * 3, dtype=grid.dtype, device=grid.device)
    k = 0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                padded[dz:dz + p1, dy:dy + p1, dx:dx + p1] += packed[..., k]
                k += 1
    return padded[1:-1, 1:-1, 1:-1]


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


def stratified(near, far, n: int, perturb: float, u=None) -> torch.Tensor:
    steps = torch.linspace(0.0, 1.0, n, dtype=near.dtype, device=near.device)
    z = near[:, None] * (1.0 - steps) + far[:, None] * steps
    if perturb > 0:
        mids = 0.5 * (z[:, :-1] + z[:, 1:])
        upper = torch.cat([mids, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mids], dim=-1)
        z = lower + (upper - lower) * (perturb * u)
    return z


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF samples of the piecewise-constant pdf over ``bins``."""
    w = weights + eps
    cdf = torch.cumsum(w / torch.sum(w, dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    m = cdf.shape[-1] - 1
    step = max(1, (1 << 27) // max(1, (m + 1) * u.shape[1]))
    inds = torch.cat([torch.sum(cdf[s:s + step, :, None] <= u[s:s + step, None, :], dim=1)
                      for s in range(0, max(u.shape[0], 1), step)])
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=m)
    cdf_lo, cdf_hi = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    bins_lo, bins_hi = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_lo + (u - cdf_lo) / denom * (bins_hi - bins_lo)


def ogm_z_vals(rays: Rays, grid: torch.Tensor, n: int, perturb: float, u_strat, u_pdf) -> torch.Tensor:
    half = n // 2
    with torch.no_grad():
        near, far = rays.near.detach(), rays.far.detach()
        z = stratified(near, far, half, perturb, u_strat)
        pts = rays.origins.detach().T[:, :, None] + rays.directions.detach().T[:, :, None] * z[None]
        probs = occupancy_probs(grid, pts)
        z_imp = sample_pdf(0.5 * (z[:, :-1] + z[:, 1:]), probs[:, 1:-1], u_pdf)
        z_sorted = torch.sort(torch.cat([z, z_imp], dim=-1), dim=-1).values
    span = rays.far - rays.near
    t = (z_sorted - rays.near[:, None]).detach() / torch.where(
        torch.abs(span) < 1e-12, torch.ones_like(span), span).detach()[:, None]
    return rays.near[:, None] + t * span[:, None]


# ---------------------------------------------------------------------------
# compositing
# ---------------------------------------------------------------------------


class Render(NamedTuple):
    depth: torch.Tensor  # (N,)
    weights: torch.Tensor  # (N, S)
    opacity: torch.Tensor  # (N,)
    variance: torch.Tensor  # (N,)
    z_vals: torch.Tensor  # (N, S)
    points: torch.Tensor  # (3, N, S)


def render(params: dict, rays: Rays, z_vals: torch.Tensor, field: dict, lower: bool = False) -> Render:
    n, s = z_vals.shape
    pts = rays.origins.T[:, :, None] + rays.directions.T[:, :, None] * z_vals[None]
    sigmas = sigma_t(params, pts.reshape(3, n * s), field, lower).reshape(n, s)
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], 1e10)], dim=-1)
    d_norm = torch.sqrt(torch.sum(rays.directions * rays.directions, dim=-1, keepdim=True) + 1e-20)
    alphas = 1.0 - torch.exp(-(deltas * d_norm) * torch.relu(sigmas))
    trans = torch.cumprod(torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10], dim=-1), dim=-1)[:, :-1]
    weights = alphas * trans
    opacity = torch.sum(weights, dim=-1)
    depth = torch.sum(weights * z_vals, dim=-1) + (1.0 - opacity) * rays.far
    variance = torch.sum(weights * (depth[:, None] - z_vals) ** 2, dim=-1)
    return Render(depth, weights, opacity, variance, z_vals, pts)


# ---------------------------------------------------------------------------
# L1_JS lidar loss
# ---------------------------------------------------------------------------


def _abs(x):
    return torch.where(x >= 0, x, -x)


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def _kl(m1, s1, m2, s2):
    return torch.log(s2 / s1) + (s1 * s1 + (m1 - m2) ** 2) / (2.0 * s2 * s2) - 0.5


def lidar_loss(r: Render, rays: Rays, scale: float, loss: dict) -> torch.Tensor:
    valid = rays.valid
    opaque = (rays.depth > 0) & ~(rays.depth > rays.far) & valid
    z_metric = r.z_vals * scale
    gt = (rays.depth * scale)[:, None]
    w_sum = torch.sum(r.weights, dim=1) + 1e-10
    mean = torch.sum(z_metric * r.weights, dim=1) / w_sum
    std = torch.sqrt(torch.sum((z_metric - mean[:, None]) ** 2 * r.weights, dim=1) / w_sum + 1e-10)
    eps_min = loss["min_depth_eps"]
    s_gt = eps_min / 3.0
    m_mix = 0.5 * (gt[:, 0] + mean)
    s_mix = 0.5 * torch.sqrt(s_gt**2 + std**2)
    js = 0.5 * _kl(gt[:, 0], s_gt, m_mix, s_mix) + 0.5 * _kl(mean, std, m_mix, s_mix)
    depth_mse = _masked_mean((r.depth * scale - gt[:, 0]) ** 2, opaque)
    js_c = torch.where(js < loss["min_js_score"], torch.zeros_like(js), js)
    js_c = torch.where(js_c > loss["max_js_score"], torch.full_like(js_c, loss["max_js_score"]), js_c)
    eps = (eps_min * (1.0 + loss["js_alpha"] * js_c)).detach()[:, None]
    sigma = eps / 9.0
    x = (z_metric - gt) / sigma
    pdf = (1.0 / math.sqrt(2.0 * math.pi)) * torch.exp(-0.5 * x * x) / sigma
    denom = 0.5 * (1 + math.erf(9.0 / math.sqrt(2.0))) - 0.5 * (1 + math.erf(-9.0 / math.sqrt(2.0)))
    zero = torch.zeros_like(z_metric)
    inside = (torch.heaviside((z_metric - (gt - eps)).detach(), zero)
              * torch.heaviside(((gt + eps) - z_metric).detach(), zero))
    w_gt = pdf / denom * inside
    w_gt = w_gt / (torch.sum(w_gt, dim=1, keepdim=True) + 1e-6)
    w_gt = torch.where(opaque[:, None], w_gt, torch.zeros_like(w_gt))
    los = _masked_mean(torch.mean(_abs(r.weights - w_gt), dim=1), valid)
    opacity_loss = _masked_mean(_abs(r.opacity - 1.0), opaque)
    return loss["depthloss_lambda"] * depth_mse + loss["los_lambda"] * los + opacity_loss
