"""Rosbag -> on-disk sequence conversion (offline data preparation).

The port of ``loner_tpu/data/rosbag_convert.py``: the reference's bag
ingestion (``examples/run_loner.py:59-157``, build_scan_from_msg and its
timestamp heuristics; the ``rosbag_utils/`` extraction tools). The numeric
heuristics are pure functions that run without ROS:

  * nanosecond and microsecond stamps -> seconds
  * negative Velodyne per-point times -> offset fix
  * per-point times relative to the scan start or absolute
  * Fusion Portable 2048-column per-point time recomputation
  * dynamic-object removal with an axis-aligned box (the harvester filter)

The bag readers (:func:`convert_bag`, :func:`extract_trajectory_from_bag`,
:func:`extract_images_from_bag`) need ``rosbag`` and raise a
``RuntimeError`` without it; where it is installed they write the npz
sequence of ``data/dataset.py`` and TUM trajectory files.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import yaml

from loner_tpu_torch.runtime import native

try:  # pragma: no cover - only where ROS is installed
    import rosbag  # type: ignore

    HAS_ROS = True
except Exception:
    HAS_ROS = False


@dataclass
class BagConversionConfig:
    lidar_topic: str = "/os_cloud_node/points"
    min_range: float = 0.3
    timestamps_relative_to_start: bool = True
    fusion_portable_columns: Optional[int] = None  # 2048 -> recompute times
    # dynamic-object box filter in the sensor frame (harvester removal,
    # rosbag_utils/README_data_preparation.md:36-44)
    remove_box_center: Optional[Tuple[float, float, float]] = None
    remove_box_size: Optional[Tuple[float, float, float]] = None


def normalize_point_times(times: np.ndarray, scan_stamp: float, relative_to_start: bool = True) -> np.ndarray:
    """The reference's per-lidar timestamp heuristics (``run_loner.py:119-145``):
    ns or µs -> s, negative offsets shifted to start at 0, and absolute
    seconds."""
    t = times.astype(np.float64)
    if len(t) == 0:
        return t
    span = t.max() - t.min()
    if span > 1e6:  # nanoseconds
        t = t * 1e-9
    elif span > 1e3:  # microseconds
        t = t * 1e-6
    if t.min() < 0:  # some Velodynes emit negative offsets
        t = t - t.min()
    if relative_to_start or t.max() < 1e6:  # relative to the scan start
        t = scan_stamp + t
    return t


def fusion_portable_times(n_points: int, columns: int, scan_stamp: float, period: float = 0.1) -> np.ndarray:
    """Per-point times for sensors that report none (Fusion Portable: 2048
    azimuth columns per sweep)."""
    col = np.arange(n_points) % columns
    return scan_stamp + col / columns * period


def scan_from_arrays(points: np.ndarray, times: np.ndarray, cfg: BagConversionConfig):
    """Raw sensor-frame points (N, 3) and absolute times (N,) -> time-sorted
    (directions f32, distances f32, times) after the range and box filters."""
    dist = np.linalg.norm(points, axis=1)
    valid = dist >= cfg.min_range
    valid = native.range_filter(dist.astype(np.float32), valid, cfg.min_range, np.inf)
    if cfg.remove_box_center is not None and cfg.remove_box_size is not None:
        valid = native.box_filter(points.astype(np.float32), valid, cfg.remove_box_center, cfg.remove_box_size)
    points, times, dist = points[valid], times[valid], dist[valid]
    dirs = points / dist[:, None]
    order = np.argsort(times)
    return dirs[order].astype(np.float32), dist[order].astype(np.float32), times[order]


def _require_ros(what: str) -> None:
    if not HAS_ROS:
        raise RuntimeError(f"rosbag is not available in this environment; run {what} where ROS is installed "
                           "(the on-disk npz format is documented in loner_tpu_torch/data/dataset.py)")


def convert_bag(bag_path: str, out_dir: str, cfg: BagConversionConfig = BagConversionConfig()) -> int:
    """Stream a bag's lidar topic into the npz sequence format; the scan count."""
    _require_ros("the conversion")
    import sensor_msgs.point_cloud2 as pc2  # type: ignore

    os.makedirs(os.path.join(out_dir, "scans"), exist_ok=True)
    bag = rosbag.Bag(bag_path)
    i = 0
    for _, msg, _ in bag.read_messages(topics=[cfg.lidar_topic]):
        fields = [f.name for f in msg.fields]
        tname = next((n for n in ("t", "time", "timestamp") if n in fields), None)
        arr = np.array(list(pc2.read_points(msg, field_names=("x", "y", "z") + ((tname,) if tname else ()))))
        pts = arr[:, :3]
        stamp = msg.header.stamp.to_sec()
        if tname:
            times = normalize_point_times(arr[:, 3], stamp, cfg.timestamps_relative_to_start)
        elif cfg.fusion_portable_columns:
            times = fusion_portable_times(len(pts), cfg.fusion_portable_columns, stamp)
        else:
            times = np.full(len(pts), stamp)
        dirs, dist, t = scan_from_arrays(pts, times, cfg)
        np.savez_compressed(os.path.join(out_dir, "scans", f"{i:06d}.npz"), ray_directions=dirs, distances=dist,
                            timestamps=t)
        i += 1
    bag.close()
    with open(os.path.join(out_dir, "meta.yaml"), "w") as f:
        yaml.safe_dump({"name": os.path.basename(bag_path)}, f)
    return i


# ---------------------------------------------------------------------------
# trajectory extraction (the reference's rosbag_utils/extract_trajectories.py)
# ---------------------------------------------------------------------------


def poses_from_stamped_quats(stamps: np.ndarray, positions: np.ndarray,
                             quats_xyzw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A stamped position + quaternion stream -> ((N, 4, 4) poses, sorted
    stamps): the core of the odometry and tf extraction."""
    from loner_tpu_torch.geometry import se3

    stamps = np.asarray(stamps, float)
    order = np.argsort(stamps)
    positions = np.asarray(positions, float)[order]
    quats = np.asarray(quats_xyzw, float)[order]
    R = se3.quat_to_matrix(torch.as_tensor(quats, dtype=torch.float32)).numpy()
    poses = np.tile(np.eye(4), (len(stamps), 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = positions
    return poses, stamps[order]


def select_tf_pair(parents: list, children: list, stamps: np.ndarray, positions: np.ndarray,
                   quats_xyzw: np.ndarray, parent_frame: str, child_frame: str):
    """A flattened tf stream filtered to one (parent, child) pair."""
    keep = [i for i, (p, c) in enumerate(zip(parents, children))
            if p.lstrip("/") == parent_frame.lstrip("/") and c.lstrip("/") == child_frame.lstrip("/")]
    idx = np.asarray(keep, int)
    return np.asarray(stamps, float)[idx], np.asarray(positions, float)[idx], np.asarray(quats_xyzw, float)[idx]


def extract_trajectory_from_bag(bag_path: str, out_tum: str, topic: str = "/mapping_node/scan2map_odometry",
                                kind: str = "odometry", parent_frame: str = "map",
                                child_frame: str = "base_link") -> int:
    """An odometry (``kind="odometry"``) or tf (``kind="tf"``) topic -> a TUM
    trajectory file; the pose count."""
    _require_ros("the trajectory extraction")
    from loner_tpu_torch.runtime.trajectory_logger import dump_tum

    stamps, positions, quats, parents, children = [], [], [], [], []
    bag = rosbag.Bag(bag_path)
    for _, msg, _ in bag.read_messages(topics=[topic]):
        if kind == "odometry":
            p, q = msg.pose.pose.position, msg.pose.pose.orientation
            stamps.append(msg.header.stamp.to_sec())
            positions.append([p.x, p.y, p.z])
            quats.append([q.x, q.y, q.z, q.w])
        else:  # tf2_msgs/TFMessage
            for t in msg.transforms:
                tr, q = t.transform.translation, t.transform.rotation
                stamps.append(t.header.stamp.to_sec())
                positions.append([tr.x, tr.y, tr.z])
                quats.append([q.x, q.y, q.z, q.w])
                parents.append(t.header.frame_id)
                children.append(t.child_frame_id)
    bag.close()
    stamps, positions, quats = np.asarray(stamps), np.asarray(positions), np.asarray(quats)
    if kind == "tf":
        stamps, positions, quats = select_tf_pair(parents, children, stamps, positions, quats, parent_frame,
                                                  child_frame)
    poses, times = poses_from_stamped_quats(stamps, positions, quats)
    dump_tum(poses, times, out_tum)
    return len(times)


def extract_images_from_bag(bag_path: str, out_dir: str, topic: str = "/stereo/frame_left/image_raw/compressed",
                            compressed: bool = True, image_scale: float = 1.0) -> int:
    """An image topic -> ``images/*.npz`` (the reference's
    ``extract_images.py``; compressed images decoded with cv2); the count."""
    _require_ros("the image extraction")
    import cv2

    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    bag = rosbag.Bag(bag_path)
    i = 0
    for _, msg, _ in bag.read_messages(topics=[topic]):
        if compressed:
            img = cv2.imdecode(np.frombuffer(msg.data, np.uint8), cv2.IMREAD_COLOR)
        else:
            img = np.frombuffer(msg.data, np.uint8).reshape(msg.height, msg.width, -1)
        if image_scale != 1.0:
            img = cv2.resize(img, None, fx=image_scale, fy=image_scale)
        np.savez_compressed(os.path.join(out_dir, "images", f"{i:06d}.npz"),
                            image=(img[..., ::-1] if img.ndim == 3 else img),  # BGR -> RGB
                            timestamp=np.float64(msg.header.stamp.to_sec()))
        i += 1
    bag.close()
    return i
