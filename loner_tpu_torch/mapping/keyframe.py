"""Keyframes: host-side records and the stacked window the train step reads.

The port of ``loner_tpu/mapping/keyframe.py`` (``KeyFrame``,
``KeyFrameWindow``, ``stack_window``). The optimizable poses live in one
(K, 6) tensor of the mapper state; a keyframe refers to its row by index, and
a window stacks W keyframes' point arrays so that one train step reads them
all.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from loner_tpu_torch.data.scan import LidarScan
from loner_tpu_torch.device import resolve_device


@dataclass
class KeyFrame:
    """Host-side keyframe record."""

    scan: LidarScan
    timestamp: float
    pose_index: int  # row in the mapper's (K, 6) pose tensor
    tracked_pose: np.ndarray  # (4, 4) tracker output at creation
    gt_pose: Optional[np.ndarray] = None  # (4, 4) ground truth, if known
    sky: Optional[LidarScan] = None
    is_anchored: bool = False  # the first keyframe anchors the world frame
    # the camera image matched to this keyframe's scan, attached (possibly
    # late: the match resolves when the image arrives) by
    # OnlineMapper.attach_image
    image: Optional[np.ndarray] = None  # (H, W, C) float32 in [0, 1]
    image_timestamp: Optional[float] = None
    image_mask: Optional[np.ndarray] = None  # (H, W) bool: True = trainable (static) pixel
    # MASK ray selection: scan indices in the trunk band, cyclically padded
    # to the scan budget (None -> uniform)
    band_indices: Optional[np.ndarray] = None

    def compute_band_indices(self, z_range=(0.5, 8.0)):
        """Fill ``band_indices`` from the best-known pose (ground truth, else
        tracked): valid points whose world z lies in ``z_range``."""
        pose = np.asarray(self.gt_pose if self.gt_pose is not None else self.tracked_pose)
        dirs, dist = np.asarray(self.scan.ray_directions), np.asarray(self.scan.distances)
        valid = np.asarray(self.scan.valid)
        z = ((dirs * dist[:, None]) @ pose[:3, :3].T + pose[:3, 3])[:, 2]
        idx = np.flatnonzero(valid & (z > z_range[0]) & (z < z_range[1]))
        if len(idx) == 0:
            idx = np.flatnonzero(valid)
        if len(idx) == 0:
            idx = np.zeros(1, np.int64)
        p = len(valid)
        self.band_indices = np.tile(idx, int(np.ceil(p / len(idx))))[:p].astype(np.int32)
        return self


class KeyFrameWindow(NamedTuple):
    """A stacked window of W keyframes on one device."""

    dirs: torch.Tensor  # (W, P, 3) sensor-frame ray directions
    dists: torch.Tensor  # (W, P) ranges (meters)
    point_valid: torch.Tensor  # (W, P) bool
    sky_dirs: torch.Tensor  # (W, S, 3)
    sky_valid: torch.Tensor  # (W, S) bool
    pose_idx: torch.Tensor  # (W,) int64 rows into the pose tensor
    band_idx: torch.Tensor  # (W, P) int64 trunk-band sampling indices

    @property
    def window_size(self) -> int:
        return self.dirs.shape[0]


def stack_window(keyframes: List[KeyFrame], n_sky_pad: int = 64, device="cuda") -> KeyFrameWindow:
    """Stack keyframes into a fixed-shape window on ``device``. All scans
    share one padded point budget; stacking is on the host, then one copy per
    field."""
    device = resolve_device(device)
    dirs = np.stack([np.asarray(kf.scan.ray_directions) for kf in keyframes])
    dists = np.stack([np.asarray(kf.scan.distances) for kf in keyframes])
    valid = np.stack([np.asarray(kf.scan.valid) for kf in keyframes])

    skys_d, skys_v = [], []
    for kf in keyframes:
        if kf.sky is not None:
            skys_d.append(np.asarray(kf.sky.ray_directions))
            skys_v.append(np.asarray(kf.sky.valid))
        else:
            skys_d.append(np.zeros((n_sky_pad, 3), dtype=np.float32))
            skys_v.append(np.zeros((n_sky_pad,), dtype=bool))

    pose_idx = np.asarray([kf.pose_index for kf in keyframes], dtype=np.int64)
    p = dirs.shape[1]
    bands = [
        np.asarray(kf.band_indices, np.int64)[:p] if kf.band_indices is not None else np.arange(p, dtype=np.int64)
        for kf in keyframes
    ]

    def put(a):
        return torch.as_tensor(a).to(device)

    return KeyFrameWindow(
        put(dirs), put(dists), put(valid), put(np.stack(skys_d)), put(np.stack(skys_v)),
        put(pose_idx), put(np.stack(bands)),
    )
