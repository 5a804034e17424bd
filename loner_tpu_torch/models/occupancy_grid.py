"""Occupancy grid: a V^3 log-odds grid that guides importance sampling.

The port of ``loner_tpu/models/occupancy_grid.py``: trilinear interpolation
with ``grid_sample``'s ``align_corners=False`` and zero padding, grid axes
ordered [z, y, x] (a point's x indexes the last axis), and the hand-written
log-odds gradient pushed back through the interpolation by the exact
8-corner transpose or by the stochastic one-corner estimator.

Both directions go through the packed cell table of the JAX package: row
c of ``((V+1)^3, 8)`` holds the 8 corners of padded cell c, so a point reads
one row, and the transpose is a scatter-add into the packed table
(``index_add_``) folded back by :func:`_unpack_transpose`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from loner_tpu_torch.device import resolve_device


class OccGridConfig(NamedTuple):
    voxel_size: int = 100  # V, grid is V^3
    lr: float = 1e-4
    n_iters_acc: int = 10  # the online mapper's update cadence, in steps
    estimator: str = "stochastic"  # "stochastic" (one corner) | "exact" (8 corners)


def init_occ_grid(cfg: OccGridConfig, device="cuda") -> torch.Tensor:
    v = cfg.voxel_size
    return torch.zeros((v, v, v), dtype=torch.float32, device=resolve_device(device))


def _pack_occ_cells(grid: torch.Tensor) -> torch.Tensor:
    """(V, V, V) logits -> ((V+1)^3, 8) corner rows of the zero-padded grid,
    corners in (dz, dy, dx) binary order."""
    v = grid.shape[0]
    padded = torch.nn.functional.pad(grid, (1, 1, 1, 1, 1, 1))
    slabs = [
        padded[dz : dz + v + 1, dy : dy + v + 1, dx : dx + v + 1]
        for dz in (0, 1)
        for dy in (0, 1)
        for dx in (0, 1)
    ]
    return torch.stack(slabs, dim=-1).reshape((v + 1) ** 3, 8)


def _corner_geometry(points_t: torch.Tensor, v: int):
    """Packed-cell row index (...), in-bounds mask (...) and the 8 trilinear
    corner weights (..., 8) in (dz, dy, dx) order, for points (3, ...) in
    [-1, 1]."""
    pix = ((points_t + 1.0) * v - 1.0) / 2.0
    lo = torch.floor(pix)
    frac = pix - lo
    cell = lo.long() + 1  # [-1, V-1] -> [0, V] within range
    inb = torch.all((cell >= 0) & (cell <= v), dim=0)
    cc = torch.clamp(cell, 0, v)
    lin = cc[2] * ((v + 1) * (v + 1)) + cc[1] * (v + 1) + cc[0]
    wx1, wy1, wz1 = frac[0], frac[1], frac[2]
    wx0, wy0, wz0 = 1.0 - wx1, 1.0 - wy1, 1.0 - wz1
    w = torch.stack(
        [
            wz0 * wy0 * wx0,
            wz0 * wy0 * wx1,
            wz0 * wy1 * wx0,
            wz0 * wy1 * wx1,
            wz1 * wy0 * wx0,
            wz1 * wy0 * wx1,
            wz1 * wy1 * wx0,
            wz1 * wy1 * wx1,
        ],
        dim=-1,
    )
    return lin, inb, w


def occ_grid_interpolate_t(grid: torch.Tensor, pts_t: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of ``grid`` (V, V, V) [z, y, x] at ``pts_t``
    (3, ...) in [-1, 1]; out-of-range corners contribute zero."""
    v = grid.shape[0]
    packed = _pack_occ_cells(grid)
    lin, inb, w = _corner_geometry(pts_t, v)
    rows = packed[lin]  # (..., 8)
    return torch.where(inb, torch.sum(rows * w, dim=-1), torch.zeros_like(w[..., 0]))


def occupancy_probs_t(grid: torch.Tensor, pts_t: torch.Tensor) -> torch.Tensor:
    """Sampling probabilities: sigmoid of the logits, clamped to [0.5, 1]
    and rescaled to [0, 1]."""
    probs = torch.sigmoid(occ_grid_interpolate_t(grid, pts_t))
    return 2.0 * (torch.clamp(probs, 0.5, 1.0) - 0.5)


def occ_logits_grad(
    z_vals_metric: torch.Tensor,  # (N, S) sample depths in meters
    depth_gt_metric: torch.Tensor,  # (N, 1) measured depth in meters
    eps: float = 2.0,
    l_free: float = 0.25,
    l_occ: float = 2.5,
) -> torch.Tensor:
    """+l_free more than eps in front of the return, -l_occ within +-eps of
    it, 0 behind (``torch.heaviside`` gives 0 at 0, as ``jnp.heaviside``
    does with a zero second argument)."""
    x = z_vals_metric - depth_gt_metric
    zero = torch.zeros_like(x)
    before = torch.heaviside(-x - eps, zero)
    near = torch.heaviside(x + eps, zero) * torch.heaviside(eps - x, zero)
    return l_free * before - l_occ * near


def _unpack_transpose(packed_ct: torch.Tensor, v: int) -> torch.Tensor:
    """Transpose of :func:`_pack_occ_cells`: (V+1, V+1, V+1, 8) -> (V, V, V)."""
    p1 = v + 1
    padded_ct = torch.zeros((v + 2, v + 2, v + 2), dtype=packed_ct.dtype, device=packed_ct.device)
    k = 0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                padded_ct[dz : dz + p1, dy : dy + p1, dx : dx + p1] += packed_ct[..., k]
                k += 1
    return padded_ct[1:-1, 1:-1, 1:-1]


def occ_grid_cotangent(
    grid: torch.Tensor,
    points_cube_t: torch.Tensor,  # (3, N, S) sample points in [-1, 1]
    z_vals_metric: torch.Tensor,  # (N, S)
    depth_gt_metric: torch.Tensor,  # (N, 1)
    valid: torch.Tensor,  # (N,) ray validity mask
    eps: float = 2.0,
    l_free: float = 0.25,
    l_occ: float = 2.5,
    u: torch.Tensor = None,  # (N, S) uniforms for the stochastic estimator
    estimator: str = "exact",
) -> torch.Tensor:
    """Gradient with respect to the grid: the per-sample log-odds gradient
    scattered back through the trilinear interpolation. ``"exact"`` scatters
    all 8 corners; ``"stochastic"`` scatters one corner per point, drawn with
    probability equal to its weight from the caller's ``u`` (an unbiased
    estimate of the exact transpose)."""
    v = grid.shape[0]
    p1 = v + 1
    g_logits = occ_logits_grad(z_vals_metric, depth_gt_metric, eps, l_free, l_occ)
    g_logits = g_logits * valid[:, None].to(g_logits.dtype)
    lin, inb, w = _corner_geometry(points_cube_t, v)
    g_eff = torch.where(inb, g_logits, torch.zeros_like(g_logits))

    if estimator == "stochastic":
        if u is None:
            raise ValueError("the stochastic occupancy estimator needs u")
        cum = torch.cumsum(w, dim=-1)  # (..., 8), last = 1
        corner = torch.clamp(torch.sum((u[..., None] > cum).long(), dim=-1), 0, 7)
        flat = (lin * 8 + corner).reshape(-1)
        packed_ct = torch.zeros((p1 * p1 * p1 * 8,), dtype=grid.dtype, device=grid.device)
        packed_ct.index_add_(0, flat, g_eff.reshape(-1))
        return _unpack_transpose(packed_ct.reshape(p1, p1, p1, 8), v)
    if estimator != "exact":
        raise ValueError(f"unknown occupancy estimator {estimator!r}")
    rows_ct = g_eff[..., None] * w  # (N, S, 8)
    packed_ct = torch.zeros((p1 * p1 * p1, 8), dtype=grid.dtype, device=grid.device)
    packed_ct.index_add_(0, lin.reshape(-1), rows_ct.reshape(-1, 8))
    return _unpack_transpose(packed_ct.reshape(p1, p1, p1, 8), v)
