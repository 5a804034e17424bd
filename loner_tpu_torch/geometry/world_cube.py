"""World-cube normalization.

The port of ``loner_tpu/geometry/world_cube.py``. The implicit field lives in
the unit cube [-1, 1]^3; a ``WorldCube`` carries the isotropic scale and shift
that map metric world coordinates into it:
``p_cube = (p_world + shift) / scale_factor``. The cube is computed on the
host in float64 and kept as a Python float (float32-rounded, as the JAX
package keeps it) and a float32 (3,) tensor; :meth:`WorldCube.to` moves the
shift to a device once, so that building rays copies nothing from the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from loner_tpu_torch.device import resolve_device


class WorldCube(NamedTuple):
    scale_factor: float
    shift: torch.Tensor  # (3,) float32

    def to(self, device) -> "WorldCube":
        return self._replace(shift=self.shift.to(device))

    def as_dict(self) -> dict:
        """Python floats only, so that ``yaml.safe_dump`` takes it (the
        run directory's ``world_cube.yaml``)."""
        return {"scale_factor": float(self.scale_factor), "shift": self.shift.cpu().tolist()}

    @staticmethod
    def from_dict(d: dict, device="cuda") -> "WorldCube":
        """The cube of :meth:`as_dict`, rounded to float32 as the JAX
        package's ``from_dict`` rounds it, its shift on ``device``."""
        shift = torch.as_tensor(np.asarray(d["shift"], np.float32)).to(resolve_device(device))
        return WorldCube(float(np.float32(d["scale_factor"])), shift)


def _lidar_view_corners(max_depth: float) -> np.ndarray:
    m = float(max_depth)
    return np.array([[x, y, z] for x in (-m, m) for y in (-m, m) for z in (-m, m)], dtype=np.float64)


def _camera_frustum_corners(K: np.ndarray, h: float, w: float, min_depth: float, max_depth: float) -> np.ndarray:
    """Corners (8, 3) of the camera's view frustum in camera coordinates."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    pix = np.array([[0.0, 0.0], [w, 0.0], [0.0, h], [w, h]])
    dirs = np.stack([(pix[:, 0] - cx) / fx, (pix[:, 1] - cy) / fy, np.ones(4)], axis=-1)
    return np.concatenate([dirs * min_depth, dirs * max_depth], axis=0)


def compute_world_cube(
    lidar_poses: Optional[np.ndarray],
    ray_range: Tuple[float, float],
    padding: float = 0.1,
    traj_bounding_box: Optional[dict] = None,
    camera_to_lidar: Optional[np.ndarray] = None,
    intrinsic: Optional[np.ndarray] = None,
    image_size: Optional[Tuple[float, float]] = None,
    rebase_to_first_pose: bool = True,
) -> WorldCube:
    """World cube from lidar poses (N, 4, 4) or a trajectory bounding box
    {"x": [lo, hi], "y": ..., "z": ...}: the sensor positions and, per pose,
    the lidar's +-max_range view volume, or with ``camera_to_lidar``,
    ``intrinsic`` and ``image_size`` (h, w) the camera positions and their
    view frustums from min to max range."""
    if not 0 <= padding < 1:
        raise ValueError(f"padding {padding} outside [0, 1)")
    if lidar_poses is None and traj_bounding_box is None:
        raise ValueError("need lidar_poses or traj_bounding_box")

    if lidar_poses is None:
        combos = np.array(
            [[x, y, z] for x in traj_bounding_box["x"] for y in traj_bounding_box["y"] for z in traj_bounding_box["z"]],
            dtype=np.float64,
        )
        lidar_poses = np.tile(np.eye(4), (8, 1, 1))
        lidar_poses[:, :3, 3] = combos
    else:
        lidar_poses = np.asarray(lidar_poses, dtype=np.float64)
        if rebase_to_first_pose:
            lidar_poses = lidar_poses @ np.linalg.inv(lidar_poses[0])

    positions = [lidar_poses[:, :3, 3]]
    if camera_to_lidar is not None and intrinsic is not None and image_size is not None:
        camera_poses = lidar_poses @ np.linalg.inv(np.asarray(camera_to_lidar, dtype=np.float64))
        corners = _camera_frustum_corners(np.asarray(intrinsic, dtype=np.float64), image_size[0], image_size[1],
                                          ray_range[0], ray_range[1])
        view_poses = camera_poses
        positions.append(camera_poses[:, :3, 3])
    else:
        corners = _lidar_view_corners(ray_range[1])
        view_poses = lidar_poses
    corners_h = np.concatenate([corners, np.ones((8, 1))], axis=-1)
    all_corners = [(p[:3, :] @ corners_h.T).T for p in view_poses]
    all_points = np.concatenate(all_corners + positions, axis=0)
    min_coord = all_points.min(axis=0)
    max_coord = all_points.max(axis=0)
    origin = min_coord + (max_coord - min_coord) / 2
    scale_factor = np.linalg.norm(max_coord - min_coord) / (2 * np.sqrt(3.0)) * (1 + padding)
    return WorldCube(float(np.float32(scale_factor)), torch.as_tensor((-origin).astype(np.float32)))
