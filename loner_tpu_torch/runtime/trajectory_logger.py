"""Trajectory bookkeeping and TUM-format files.

The port of ``loner_tpu/runtime/trajectory_logger.py``: keep the ICP-only
trajectory, the ground truth and the online estimate (the latest keyframe
correction composed with the tracked motion since); at the end re-anchor
every tracked pose onto its preceding keyframe's optimized pose and write
tracking_only / online_estimates / keyframe_trajectory /
estimated_trajectory (and groundtruth) as TUM files.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from loner_tpu_torch.geometry import se3


def dump_tum(poses: np.ndarray, timestamps: np.ndarray, path: str):
    """(N, 4, 4) poses as TUM lines: t x y z qx qy qz qw."""
    poses = np.asarray(poses, np.float64)
    q = se3.matrix_to_quat(torch.as_tensor(poses[:, :3, :3], dtype=torch.float32)).numpy()
    data = np.concatenate([np.asarray(timestamps).reshape(-1, 1), poses[:, :3, 3], q], axis=-1)
    np.savetxt(path, data, delimiter=" ", fmt="%.10f")


def load_tum(path: str):
    """(poses (N, 4, 4), timestamps (N,))."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    ts = data[:, 0]
    R = se3.quat_to_matrix(torch.as_tensor(data[:, 4:8], dtype=torch.float32)).numpy()
    poses = np.tile(np.eye(4), (len(ts), 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = data[:, 1:4]
    return poses, ts


@dataclass
class _TrackedFrame:
    timestamp: float
    tracked_pose: np.ndarray  # (4, 4)
    gt_pose: Optional[np.ndarray] = None
    # the estimate when the frame arrived (only the corrections known then)
    online_pose: Optional[np.ndarray] = None


@dataclass
class _KeyFrameRecord:
    timestamp: float
    tracked_pose: np.ndarray
    optimized_pose: np.ndarray


class TrajectoryLogger:
    """Tracked frames and keyframe pose updates; the final estimate re-anchors
    each tracked pose on the optimized pose of the keyframe before it."""

    def __init__(self):
        self.frames: List[_TrackedFrame] = []
        self.keyframes: Dict[float, _KeyFrameRecord] = {}

    def log_frame(self, timestamp: float, tracked_pose: np.ndarray, gt_pose=None):
        tracked_pose = np.asarray(tracked_pose)
        self.frames.append(_TrackedFrame(timestamp, tracked_pose, gt_pose,
                                         online_pose=self.online_estimate(timestamp, tracked_pose)))

    def update_keyframe(self, timestamp: float, tracked_pose: np.ndarray, optimized_pose: np.ndarray):
        """Record or refresh a keyframe's optimized pose (the mapper calls this
        whenever it publishes poses)."""
        self.keyframes[timestamp] = _KeyFrameRecord(timestamp, np.asarray(tracked_pose), np.asarray(optimized_pose))

    def online_estimate(self, timestamp: float, tracked_pose: np.ndarray) -> np.ndarray:
        """optimized_kf @ inv(tracked_kf) @ tracked for the latest keyframe at
        or before ``timestamp``."""
        past = [k for k in self.keyframes.values() if k.timestamp <= timestamp]
        if not past:
            return np.asarray(tracked_pose)
        kf = max(past, key=lambda k: k.timestamp)
        return kf.optimized_pose @ np.linalg.inv(kf.tracked_pose) @ np.asarray(tracked_pose)

    def reconstruct_trajectory(self) -> np.ndarray:
        """The re-anchored estimate of every tracked frame."""
        out = [self.online_estimate(f.timestamp, f.tracked_pose) for f in self.frames]
        return np.stack(out) if out else np.zeros((0, 4, 4))

    def finish(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        ts = np.array([f.timestamp for f in self.frames])
        if len(ts):
            dump_tum(np.stack([f.tracked_pose for f in self.frames]), ts, os.path.join(out_dir, "tracking_only.txt"))
            dump_tum(self.reconstruct_trajectory(), ts, os.path.join(out_dir, "estimated_trajectory.txt"))
            online = [f.online_pose if f.online_pose is not None else f.tracked_pose for f in self.frames]
            dump_tum(np.stack(online), ts, os.path.join(out_dir, "online_estimates.txt"))
        if self.keyframes:
            kts = np.array(sorted(self.keyframes))
            kposes = np.stack([self.keyframes[t].optimized_pose for t in kts])
            dump_tum(kposes, kts, os.path.join(out_dir, "keyframe_trajectory.txt"))
        gt = [f for f in self.frames if f.gt_pose is not None]
        if gt:
            dump_tum(np.stack([f.gt_pose for f in gt]), np.array([f.timestamp for f in gt]),
                     os.path.join(out_dir, "groundtruth.txt"))
