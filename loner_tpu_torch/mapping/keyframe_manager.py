"""Keyframe selection and active-window management (host-side policy).

The port of ``loner_tpu/mapping/keyframe_manager.py``: selection strategies
TEMPORAL / MOTION / HYBRID / HYBRID_LAZY with the motion gate on translation
and rotation, the re-basing of a new keyframe's pose onto the last optimized
one, and window selection MOST_RECENT / RANDOM / HYBRID. The window's random
draws come from ``random.Random(seed)`` in the same sequence of calls as the
JAX package, so both pick the same windows.
"""
from __future__ import annotations

import random as pyrandom
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from loner_tpu_torch.geometry import se3
from loner_tpu_torch.mapping.keyframe import KeyFrame


@dataclass
class KeyFrameManagerConfig:
    selection_strategy: str = "TEMPORAL"  # TEMPORAL | MOTION | HYBRID | HYBRID_LAZY
    time_diff_seconds: float = 3.0
    translation_threshold_m: float = 0.5
    rotation_threshold_deg: float = 22.5
    window_selection: str = "HYBRID"  # MOST_RECENT | RANDOM | HYBRID
    window_size: int = 8
    num_recent_frames: int = 1


def pose6_to_matrix(pose6) -> np.ndarray:
    """A (6,) pose row -> (4, 4) float32 matrix on the host."""
    return se3.pose_to_matrix(torch.as_tensor(np.asarray(pose6), dtype=torch.float32)).numpy()


class KeyFrameManager:
    def __init__(self, cfg: KeyFrameManagerConfig, seed: int = 0):
        self.cfg = cfg
        self.keyframes: List[KeyFrame] = []
        self._rng = pyrandom.Random(seed)
        self._last_accepted_time: Optional[float] = None

    def __len__(self) -> int:
        return len(self.keyframes)

    # -- selection ----------------------------------------------------------
    def _temporal_gate(self, timestamp: float) -> bool:
        if self._last_accepted_time is None:
            return True
        return (timestamp - self._last_accepted_time) >= self.cfg.time_diff_seconds

    def _motion_gate(self, tracked_pose: np.ndarray) -> bool:
        if not self.keyframes:
            return True
        delta = np.linalg.inv(self.keyframes[-1].tracked_pose) @ tracked_pose
        dt = float(np.linalg.norm(delta[:3, 3]))
        ang = float(torch.linalg.norm(se3.log_so3(torch.as_tensor(delta[:3, :3], dtype=torch.float32))))
        return dt >= self.cfg.translation_threshold_m or np.degrees(ang) >= self.cfg.rotation_threshold_deg

    def decide(self, timestamp: float, tracked_pose: np.ndarray) -> str:
        """``"NEW"`` (create a keyframe and optimize), ``"REOPT"`` (HYBRID
        when stationary: optimize the window again and reset the temporal
        clock) or ``"SKIP"``."""
        s = self.cfg.selection_strategy
        if s == "TEMPORAL":
            return "NEW" if self._temporal_gate(timestamp) else "SKIP"
        if s in ("MOTION", "HYBRID", "HYBRID_LAZY"):
            motion = self._motion_gate(tracked_pose)
            temporal = self._temporal_gate(timestamp)
            if s == "MOTION":
                return "NEW" if motion else "SKIP"
            if motion and temporal:
                return "NEW"
            if s == "HYBRID" and temporal and self.keyframes:
                self._last_accepted_time = timestamp
                return "REOPT"
            return "SKIP"
        raise ValueError(f"Unknown keyframe selection strategy {s}")

    # -- pose re-basing -----------------------------------------------------
    def rebase_pose(self, tracked_pose: np.ndarray, optimized_poses: np.ndarray) -> np.ndarray:
        """A new keyframe's initial pose: the last optimized keyframe pose
        composed with the tracked motion since that keyframe.
        ``optimized_poses`` is the mapper's (K, 6) array."""
        if not self.keyframes:
            return tracked_pose
        last_kf = self.keyframes[-1]
        last_opt = pose6_to_matrix(optimized_poses[last_kf.pose_index])
        return last_opt @ (np.linalg.inv(last_kf.tracked_pose) @ tracked_pose)

    def accept(self, kf: KeyFrame):
        self._last_accepted_time = kf.timestamp
        if not self.keyframes:
            kf.is_anchored = True
        self.keyframes.append(kf)

    # -- window selection ---------------------------------------------------
    def get_active_window(self) -> List[KeyFrame]:
        """Up to window_size keyframes, repeated to the fixed window size.
        HYBRID: the num_recent_frames most recent plus a random sample of the
        others."""
        cfg = self.cfg
        n = len(self.keyframes)
        assert n > 0
        if cfg.window_selection == "MOST_RECENT":
            chosen = self.keyframes[-cfg.window_size :]
        elif cfg.window_selection == "RANDOM":
            chosen = [self.keyframes[self._rng.randrange(n)] for _ in range(cfg.window_size)]
        elif cfg.window_selection == "HYBRID":
            recent = self.keyframes[-cfg.num_recent_frames :]
            past = self.keyframes[: -cfg.num_recent_frames] or self.keyframes
            n_past = cfg.window_size - len(recent)
            sampled = self._rng.sample(past, n_past) if len(past) >= n_past else list(past)
            chosen = sampled + recent
        else:
            raise ValueError(f"Unknown window selection {cfg.window_selection}")
        while len(chosen) < cfg.window_size:
            chosen = chosen + chosen[: cfg.window_size - len(chosen)]
        return chosen[: cfg.window_size]
