"""Poses and lidar rays, in plain PyTorch.

Poses are 6-vectors ``[tx, ty, tz, rx, ry, rz]`` (translation and
axis-angle) or 4x4 matrices. A ray bundle holds world-cube origins, unit
world directions, near and far, the validity mask and the measured depth in
cube units. Padded points (zero directions) and rays with under 1 m inside
the cube are invalid; shapes stay fixed.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ], dim=-2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues, with the series branch near the identity."""
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta_sq + _EPS**2)
    small = theta_sq < 1e-8
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / (theta_sq + _EPS**2))
    k = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def log_so3(r: torch.Tensor) -> torch.Tensor:
    """Axis-angle of a rotation matrix, safe at the identity and near pi."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    vee = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0], r[..., 1, 0] - r[..., 0, 1]], dim=-1)
    sin_theta = torch.sin(theta)
    scale = torch.where(torch.abs(sin_theta) < 1e-6, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * sin_theta + _EPS * torch.sign(sin_theta + _EPS)))
    w_generic = scale[..., None] * vee
    diag = torch.stack([r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp((diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + _EPS), min=0.0))
    sxy, sxz, syz = r[..., 0, 1] + r[..., 1, 0], r[..., 0, 2] + r[..., 2, 0], r[..., 1, 2] + r[..., 2, 1]
    k = torch.argmax(axis_abs, dim=-1)

    def sgn(v):
        return torch.where(v >= 0, 1.0, -1.0).to(r.dtype)

    one = torch.ones_like(sxy)
    s0 = torch.stack([one, sgn(sxy), sgn(sxz)], dim=-1)
    s1 = torch.stack([sgn(sxy), one, sgn(syz)], dim=-1)
    s2 = torch.stack([sgn(sxz), sgn(syz), one], dim=-1)
    signs = torch.where((k == 0)[..., None], s0, torch.where((k == 1)[..., None], s1, s2))
    axis = axis_abs * signs
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + _EPS)
    axis = axis * torch.where(torch.sum(axis * vee, dim=-1) < 0, -1.0, 1.0).to(r.dtype)[..., None]
    near_pi = (math.pi - theta) < 1e-2
    return torch.where(near_pi[..., None], theta[..., None] * axis, w_generic)


def pose_to_matrix(p: torch.Tensor) -> torch.Tensor:
    rot = exp_so3(p[..., 3:6])
    top = torch.cat([rot, p[..., 0:3, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def matrix_to_pose(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t[..., :3, 3], log_so3(t[..., :3, :3])], dim=-1)


class Rays(NamedTuple):
    origins: torch.Tensor  # (N, 3) cube coordinates
    directions: torch.Tensor  # (N, 3) unit, world frame
    near: torch.Tensor  # (N,)
    far: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool
    depth: torch.Tensor  # (N,) measured range, cube units


def _safe_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-20)


def far_cube_exit(origins: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    d = directions + 1e-15
    t_lo = torch.clamp((-1.0 - origins) / d, min=0.0)
    t_hi = torch.clamp((1.0 - origins) / d, min=0.0)
    return torch.amin(torch.maximum(t_lo, t_hi), dim=-1)


def lidar_rays(dirs_sensor: torch.Tensor, distances: torch.Tensor, pose: torch.Tensor, scale: float,
               shift: torch.Tensor, ray_range: Tuple[float, float], point_valid=None) -> Rays:
    """Rays of sensor directions (..., N, 3) with ranges (..., N) from poses
    (..., 4, 4) world_T_lidar, differentiable through the pose."""
    n = dirs_sensor.shape[-2]
    origin = (pose[..., :3, 3] + shift.to(pose)) / scale
    origins = origin[..., None, :].expand(*origin.shape[:-1], n, 3)
    dirs = dirs_sensor @ pose[..., :3, :3].transpose(-1, -2)
    dirs = dirs / _safe_norm(dirs)
    near = torch.full(distances.shape, ray_range[0] / scale, dtype=origins.dtype, device=origins.device)
    far = torch.minimum(torch.full_like(near, ray_range[1] / scale), far_cube_exit(origins, dirs))
    valid = far > (near + 1.0 / scale)
    if point_valid is not None:
        valid = valid & point_valid
    return Rays(origins, dirs, near, far, valid, distances / scale)


def window_rays(poses6: torch.Tensor, window: dict, ray_idx: torch.Tensor, sky_idx: torch.Tensor, scale: float,
                shift: torch.Tensor, ray_range: Tuple[float, float], band_fraction=None) -> Rays:
    """Each window row's drawn lidar rays then its sky rays, flattened
    keyframe-major. Lidar rays carry the pose gradient; sky rays use the
    detached pose and the range's far end plus 1 m. With ``band_fraction``
    (MASK rays) the first ``int(R * band_fraction)`` draws of each row index
    its trunk band ``window["band"]``, the rest its scan."""
    if band_fraction is not None:
        n_band = int(ray_idx.shape[1] * band_fraction)
        ray_idx = torch.cat([torch.gather(window["band"], 1, ray_idx[:, :n_band]), ray_idx[:, n_band:]], dim=1)
    mats = pose_to_matrix(poses6[window["pose_idx"]])

    def take(a, idx):
        if a.dim() == 3:
            return torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))
        return torch.gather(a, 1, idx)

    lidar = lidar_rays(take(window["dirs"], ray_idx), take(window["dists"], ray_idx), mats, scale, shift, ray_range,
                       take(window["valid"], ray_idx))
    sky_dirs = take(window["sky_dirs"], sky_idx)
    sky = lidar_rays(sky_dirs, torch.full(sky_dirs.shape[:-1], ray_range[1] + 1.0, dtype=sky_dirs.dtype,
                                          device=sky_dirs.device),
                     mats.detach(), scale, shift, ray_range, take(window["sky_valid"], sky_idx))
    return Rays(*(torch.cat([a, b], dim=1).reshape((-1,) + tuple(a.shape[2:])) for a, b in zip(lidar, sky)))
