"""Lidar and camera ray construction in world-cube coordinates.

The port of ``loner_tpu/geometry/rays.py`` (``RayBundle``, ``far_cube_exit``,
``build_lidar_rays``, ``build_camera_rays``, ``camera_ray_directions``).
Rays that exit the cube too early are masked invalid
rather than dropped, so batches keep static shapes. ``build_lidar_rays`` is
differentiable through the pose and takes leading batch dimensions (one pose
per scan of a window).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


def _safe_norm(v: torch.Tensor) -> torch.Tensor:
    """Norm along the last axis, keepdim, with a zero-safe gradient."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-20)


class RayBundle(NamedTuple):
    origins: torch.Tensor  # (N, 3) in cube coords
    directions: torch.Tensor  # (N, 3) unit, world frame
    viewdirs: torch.Tensor  # (N, 3) = -directions for lidar
    near: torch.Tensor  # (N,)
    far: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool: the ray has >= 1 m inside the cube
    depth: torch.Tensor  # (N,) measured range in cube units


def far_cube_exit(origins: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Distance along each ray to the exit of the [-1, 1]^3 cube (origins
    inside it): per axis the larger of the two clamped plane distances, then
    the least over the axes. The 1e-15 on the directions is the reference's
    no-NaN guard."""
    d = directions + 1e-15
    t_lo = (-1.0 - origins) / d
    t_hi = (1.0 - origins) / d
    t_max_per_axis = torch.maximum(torch.clamp(t_lo, min=0.0), torch.clamp(t_hi, min=0.0))
    return torch.amin(t_max_per_axis, dim=-1)


def build_lidar_rays(
    directions_sensor: torch.Tensor,  # (..., N, 3) unit directions, sensor frame
    distances: torch.Tensor,  # (..., N) measured ranges, meters
    lidar_pose: torch.Tensor,  # (..., 4, 4) world_T_lidar, metric
    world_cube,
    ray_range: Tuple[float, float],
    point_valid: torch.Tensor = None,  # (..., N) bool mask of padded points
) -> RayBundle:
    """World-cube rays for one scan per pose; gradients flow to
    ``lidar_pose`` through the origins and the rotated, re-normalised
    directions (and through them to ``far``)."""
    n = directions_sensor.shape[-2]
    scale = world_cube.scale_factor
    depths = distances / scale

    shift = world_cube.shift.to(device=lidar_pose.device, dtype=lidar_pose.dtype)
    origin = (lidar_pose[..., :3, 3] + shift) / scale  # (..., 3)
    origins = origin[..., None, :].expand(*origin.shape[:-1], n, 3)

    rot = lidar_pose[..., :3, :3]
    dirs_world = directions_sensor @ rot.transpose(-1, -2)
    # eps-safe norm: padded points carry zero directions; a bare norm would
    # give NaN gradients there that poison the batch through the finite guard
    dirs_world = dirs_world / _safe_norm(dirs_world)
    viewdirs = -dirs_world

    near = torch.full(distances.shape, ray_range[0] / scale, dtype=origins.dtype, device=origins.device)
    far_range = torch.full(distances.shape, ray_range[1] / scale, dtype=origins.dtype, device=origins.device)
    far = torch.minimum(far_range, far_cube_exit(origins, dirs_world))

    valid = far > (near + 1.0 / scale)
    if point_valid is not None:
        valid = valid & point_valid
    return RayBundle(origins, dirs_world, viewdirs, near, far, valid, depths)


def build_camera_rays(
    directions_cam: torch.Tensor,  # (N, 3) pixel ray directions, camera frame
    camera_pose: torch.Tensor,  # (4, 4) world_T_camera, metric
    world_cube,
    ray_range: Tuple[float, float],
) -> RayBundle:
    """Camera rays: view directions are the normalized directions
    themselves (not their negation, as for lidar), depth 0."""
    n = directions_cam.shape[0]
    scale = world_cube.scale_factor
    shift = world_cube.shift.to(device=camera_pose.device, dtype=camera_pose.dtype)
    origins = ((camera_pose[:3, 3] + shift) / scale).expand(n, 3)
    dirs_world = directions_cam @ camera_pose[:3, :3].T
    dirs_world = dirs_world / _safe_norm(dirs_world)
    near = torch.full((n,), ray_range[0] / scale, dtype=origins.dtype, device=origins.device)
    far_range = torch.full((n,), ray_range[1] / scale, dtype=origins.dtype, device=origins.device)
    far = torch.minimum(far_range, far_cube_exit(origins, dirs_world))
    valid = far > (near + 1.0 / scale)
    return RayBundle(origins, dirs_world, dirs_world, near, far, valid, torch.zeros_like(near))


def camera_ray_directions(h: int, w: int, K: torch.Tensor) -> torch.Tensor:
    """Pinhole pixel ray directions (H*W, 3), row-major over (y, x), at the
    integer pixel coordinates (the camera step samples at index + 0.5);
    distortion is undone on the host before this."""
    ys = torch.arange(h, dtype=torch.float32, device=K.device)
    xs = torch.arange(w, dtype=torch.float32, device=K.device)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([(grid_x.reshape(-1) - K[0, 2]) / K[0, 0], (grid_y.reshape(-1) - K[1, 2]) / K[1, 1],
                        torch.ones(h * w, dtype=torch.float32, device=K.device)], dim=-1)
