"""Submap segmentation and per-submap optimization.

The port of ``loner_tpu/mapping/submaps.py``, the reference's FDT submap
pipeline (``examples/fdt_segment_and_optimize_submaps.py``): split a groundtruth
trajectory into <= ``segment_length_m`` arc-length segments with
``overlap_poses`` of padding on both sides, optimize an independent implicit
map per segment (global frame — no per-submap origin re-basing), and keep a
middle-point index for nearest-submap lookup at query time.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from loner_tpu_torch.geometry.world_cube import WorldCube, compute_world_cube
from loner_tpu_torch.mapping.keyframe import KeyFrame
from loner_tpu_torch.mapping.offline import OfflineConfig, OfflineResult, optimize_implicit_map
from loner_tpu_torch.mapping.optimizer import MapperConfig


@dataclass
class SubmapSegment:
    indices: List[int]  # keyframe/pose indices in this segment (with overlap)
    core_indices: List[int]  # without overlap padding
    middle_point: np.ndarray  # (3,) segment centroid, the lookup key


def segment_trajectory(
    positions: np.ndarray,  # (N, 3) trajectory positions (time-ordered)
    segment_length_m: float = 50.0,
    overlap_poses: int = 30,
) -> List[SubmapSegment]:
    """Arc-length segmentation with pose-count overlap padding
    (``fdt_segment_and_optimize_submaps.py:24-25,77-147``)."""
    n = len(positions)
    step = np.linalg.norm(np.diff(positions, axis=0), axis=1)
    segments = []
    start = 0
    while start < n:
        acc = 0.0
        end = start + 1
        while end < n and acc + step[end - 1] <= segment_length_m:
            acc += step[end - 1]
            end += 1
        core = list(range(start, end))
        lo = max(0, start - overlap_poses)
        hi = min(n, end + overlap_poses)
        idx = list(range(lo, hi))
        segments.append(
            SubmapSegment(
                indices=idx,
                core_indices=core,
                middle_point=positions[core].mean(axis=0),
            )
        )
        start = end
    return segments


@dataclass
class SubmapCollection:
    """Index over optimized submaps: nearest-middle-point lookup
    (the ``submaps_middlepoints.npy`` index role)."""

    middle_points: np.ndarray  # (S, 3)
    names: List[str]

    def query(self, position: np.ndarray) -> int:
        d = np.linalg.norm(self.middle_points - np.asarray(position)[None], axis=1)
        return int(np.argmin(d))

    def save(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        np.save(os.path.join(directory, "submaps_middlepoints.npy"), self.middle_points)
        with open(os.path.join(directory, "submaps_index.json"), "w") as f:
            json.dump(self.names, f)

    @staticmethod
    def load(directory: str) -> "SubmapCollection":
        mp = np.load(os.path.join(directory, "submaps_middlepoints.npy"))
        with open(os.path.join(directory, "submaps_index.json")) as f:
            names = json.load(f)
        return SubmapCollection(mp, names)


def segment_and_optimize_submaps(
    cfg: MapperConfig,
    keyframes: Sequence[KeyFrame],
    segment_length_m: float = 50.0,
    overlap_poses: int = 30,
    offline: OfflineConfig = OfflineConfig(),
    out_dir: Optional[str] = None,
    cube: Optional[WorldCube] = None,
    log_fn: Callable[[str], None] = print,
    device="cuda",
) -> Tuple[SubmapCollection, List[OfflineResult]]:
    """Optimize one independent implicit map per trajectory segment in a
    shared global frame, on ``device``. Returns the middle-point index +
    per-submap results.

    A shared world cube (from the full trajectory) keeps submaps in one
    coordinate system, mirroring the reference's no-re-basing submap mode
    (``fdt_optimize_implicit_map.py:211-214,385-388``).
    """
    positions = np.stack(
        [
            (kf.gt_pose if kf.gt_pose is not None else kf.tracked_pose)[:3, 3]
            for kf in keyframes
        ]
    )
    if cube is None:
        poses = np.stack(
            [kf.gt_pose if kf.gt_pose is not None else kf.tracked_pose for kf in keyframes]
        )
        cube = compute_world_cube(
            poses, cfg.ray_range, rebase_to_first_pose=False
        )
        cfg = cfg._replace(world_scale=cube.scale_factor)

    segments = segment_trajectory(positions, segment_length_m, overlap_poses)
    log_fn(f"[submaps] {len(segments)} segments over {len(keyframes)} keyframes")

    results = []
    names = []
    for si, seg in enumerate(segments):
        seg_kfs = [keyframes[i] for i in seg.indices]
        # pose_index must be local to this submap's pose array. As in the
        # JAX package, the copies carry no band_indices: under MASK a
        # submap's band draws fall back to the whole scan.
        local = [
            KeyFrame(
                scan=kf.scan,
                timestamp=kf.timestamp,
                pose_index=j,
                tracked_pose=kf.tracked_pose,
                gt_pose=kf.gt_pose,
                sky=kf.sky,
            )
            for j, kf in enumerate(seg_kfs)
        ]
        seg_dir = os.path.join(out_dir, f"submap_{si:03d}") if out_dir else None
        res = optimize_implicit_map(
            cfg,
            cube,
            local,
            offline=offline if seg_dir is None else OfflineConfig(
                **{**offline.__dict__, "log_dir": seg_dir}
            ),
            log_fn=lambda m, si=si: log_fn(f"[submap {si}] {m}"),
            device=device,
        )
        results.append(res)
        names.append(f"submap_{si:03d}")

    collection = SubmapCollection(
        np.stack([s.middle_point for s in segments]), names
    )
    if out_dir:
        collection.save(out_dir)
    return collection, results
