"""Per-point motion compensation of spinning-lidar scans.

The port of ``loner_tpu/geometry/motion.py``: each point's capture-time pose
is interpolated between a start and an end pose (lerp of the translation,
slerp of the relative rotation), the point is lifted into the world at that
pose and re-projected into one target frame; ranges and directions are
recomputed. Tensors stay on their device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from loner_tpu_torch.geometry import se3


def interpolate_poses(T0: torch.Tensor, T1: torch.Tensor, t0, t1, timestamps: torch.Tensor) -> torch.Tensor:
    """(N, 4, 4) pose at each of the (N,) timestamps between (T0, t0) and
    (T1, t1)."""
    alpha = (timestamps - t0) / (t1 - t0)
    R0, R1 = T0[:3, :3], T1[:3, :3]
    rel_w = se3.log_so3(R0.T @ R1)
    R = R0 @ se3.exp_so3(rel_w[None, :] * alpha[:, None])
    trans = T0[:3, 3] + (T1[:3, 3] - T0[:3, 3]) * alpha[:, None]
    return se3._homogeneous(R, trans)


def motion_compensate(
    ray_directions: torch.Tensor,  # (N, 3) unit directions, sensor frame
    distances: torch.Tensor,  # (N,)
    timestamps: torch.Tensor,  # (N,)
    start_pose: torch.Tensor,  # (4, 4) world_T_lidar at the scan's start
    end_pose: torch.Tensor,  # (4, 4) world_T_lidar at its end
    start_time,
    end_time,
    target_pose: torch.Tensor,  # (4, 4) frame to compensate into
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new ray directions (N, 3), new distances (N,))."""
    T = se3.inverse(target_pose) @ interpolate_poses(start_pose, end_pose, start_time, end_time, timestamps)
    pts = ray_directions * distances[:, None]
    pts_comp = (T[:, :3, :3] @ pts[:, :, None])[:, :, 0] + T[:, :3, 3]
    new_dist = torch.linalg.norm(pts_comp, dim=-1)
    return pts_comp / (new_dist[:, None] + 1e-12), new_dist
