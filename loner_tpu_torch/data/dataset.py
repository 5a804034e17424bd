"""Sequence datasets: the on-disk format, its loader, and ground-truth
interpolation.

The port of ``loner_tpu/data/dataset.py`` (``SequenceMeta``,
``SequenceDataset``, ``interpolate_gt_poses``, ``write_synthetic_dataset``).
The format is the JAX package's, byte for byte, so that a sequence written by
either package reads in the other:

    dataset/
      scans/000000.npz   # ray_directions (N,3), distances (N,), timestamps (N,),
                         # sky_directions (M,3)
      poses_gt.tum       # optional ground truth, TUM format
      meta.yaml          # ray_range, scan_period, name

A camera track (``ImageSequence``, ``write_synthetic_images``) sits beside
the scans in the same root:

    dataset/
      images/000000.npz   # image (H,W,C) float32 [0,1], timestamp, optional mask
      calibration.yaml    # CameraCalibration.as_dict()
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import yaml

from loner_tpu_torch.data import synthetic
from loner_tpu_torch.data.calibration import CameraCalibration, _distort_normalized, load_calibration_yaml
from loner_tpu_torch.data.scan import LidarScan, make_lidar_scan
from loner_tpu_torch.geometry import se3
from loner_tpu_torch.runtime.trajectory_logger import dump_tum, load_tum


@dataclass
class SequenceMeta:
    ray_range: Tuple[float, float] = (1.0, 50.0)
    scan_period: float = 0.1
    name: str = "sequence"


class SequenceDataset:
    """Iterates (scan, timestamp) over an on-disk sequence."""

    def __init__(self, root: str, pad_to: Optional[int] = None):
        self.root = root
        self.scan_dir = os.path.join(root, "scans")
        self.files = sorted(f for f in os.listdir(self.scan_dir) if f.endswith(".npz"))
        self.pad_to = pad_to
        meta_path = os.path.join(root, "meta.yaml")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                m = yaml.safe_load(f) or {}
            self.meta = SequenceMeta(
                ray_range=tuple(m.get("ray_range", (1.0, 50.0))),
                scan_period=m.get("scan_period", 0.1),
                name=m.get("name", os.path.basename(root)),
            )
        else:
            self.meta = SequenceMeta(name=os.path.basename(root))
        gt_path = os.path.join(root, "poses_gt.tum")
        if os.path.exists(gt_path):
            self.gt_poses, self.gt_times = load_tum(gt_path)
        else:
            self.gt_poses, self.gt_times = None, None

    def __len__(self) -> int:
        return len(self.files)

    def load_scan(self, i: int) -> Tuple[LidarScan, float]:
        with np.load(os.path.join(self.scan_dir, self.files[i])) as z:
            scan = make_lidar_scan(z["ray_directions"], z["distances"], z["timestamps"], pad_to=self.pad_to)
            ts = float(z["timestamps"].min())
        return scan, ts

    def sky_directions(self, i: int) -> Optional[np.ndarray]:
        """The scan's sky directions (the rays that hit nothing), if it has
        any."""
        with np.load(os.path.join(self.scan_dir, self.files[i])) as z:
            if "sky_directions" in z and len(z["sky_directions"]):
                return z["sky_directions"]
        return None

    def __iter__(self) -> Iterator[Tuple[LidarScan, float]]:
        for i in range(len(self)):
            yield self.load_scan(i)

    def gt_pose_at(self, t: float) -> Optional[np.ndarray]:
        if self.gt_poses is None:
            return None
        return interpolate_gt_poses(self.gt_poses, self.gt_times, np.asarray([t]))[0]


def interpolate_gt_poses(gt_poses: np.ndarray, gt_times: np.ndarray, query_times: np.ndarray) -> np.ndarray:
    """(N, 4, 4): slerp of the rotation and lerp of the translation of a
    ground-truth trajectory (M, 4, 4) at ``gt_times`` onto ``query_times``,
    in float32 as the JAX package computes it; clamped outside the covered
    interval."""
    order = np.argsort(gt_times)
    gt_times = gt_times[order]
    gt_poses = gt_poses[order]
    out = np.zeros((len(query_times), 4, 4))
    for i, t in enumerate(query_times):
        j = np.searchsorted(gt_times, t)
        if j == 0:
            out[i] = gt_poses[0]
        elif j >= len(gt_times):
            out[i] = gt_poses[-1]
        else:
            t0, t1 = gt_times[j - 1], gt_times[j]
            alpha = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
            out[i] = se3.interpolate_transform(
                torch.as_tensor(gt_poses[j - 1], dtype=torch.float32),
                torch.as_tensor(gt_poses[j], dtype=torch.float32),
                torch.as_tensor(alpha, dtype=torch.float32),
            ).numpy()
    return out


def write_synthetic_dataset(
    root: str,
    scene: Optional[synthetic.Scene] = None,
    n_poses: int = 48,
    radius: float = 5.0,
    period: float = 9.6,
    n_channels: int = 16,
    n_azimuth: int = 256,
    max_range: float = 40.0,
    noise_std: float = 0.0,
    seed: int = 0,
) -> str:
    """Write the synthetic loop as an on-disk sequence under ``root``."""
    scene = scene or synthetic.Scene.default()
    poses, ts = synthetic.circular_trajectory(n_poses, radius, period=period)
    os.makedirs(os.path.join(root, "scans"), exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (T, t0) in enumerate(zip(poses, ts)):
        dirs, dists, stamps, hit = synthetic.simulate_scan(
            scene, T, t0, n_channels=n_channels, n_azimuth=n_azimuth, max_range=max_range, rng=rng,
            noise_std=noise_std,
        )
        np.savez_compressed(
            os.path.join(root, "scans", f"{i:06d}.npz"),
            ray_directions=dirs[hit],
            distances=dists[hit],
            timestamps=stamps[hit],
            sky_directions=dirs[~hit],
        )
    dump_tum(poses, ts, os.path.join(root, "poses_gt.tum"))
    with open(os.path.join(root, "meta.yaml"), "w") as f:
        yaml.safe_dump(
            {"ray_range": [1.0, float(max_range)], "scan_period": period / n_poses, "name": "synthetic"}, f
        )
    return root


class ImageSequence:
    """Iterates (image, mask, timestamp) over on-disk images:

        dataset/
          images/000000.npz   # image (H,W,C) float32 [0,1], timestamp,
                              # optional mask (H,W) bool (True = trainable)
          calibration.yaml    # CameraCalibration.as_dict()

    The format is the JAX package's, so that either package reads what the
    other wrote. Images are undistorted on load, by nearest-neighbour
    remapping, when the calibration carries distortion.
    """

    def __init__(self, root: str, undistort: bool = True):
        self.root = root
        self.image_dir = os.path.join(root, "images")
        self.files = sorted(
            f for f in os.listdir(self.image_dir) if f.endswith(".npz")
        )
        self.calibration = load_calibration_yaml(os.path.join(root, "calibration.yaml"))
        self._undistort = undistort and np.any(self.calibration.distortion)
        self._remap = None

    def __len__(self) -> int:
        return len(self.files)

    def _undistort_image(self, img: np.ndarray) -> np.ndarray:
        """Nearest-neighbor rectification via the inverse distortion map."""
        c = self.calibration
        if self._remap is None:
            h, w = c.height, c.width
            ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            nK = c.new_K
            x = (xs.ravel() + 0.5 - nK[0, 2]) / nK[0, 0]
            y = (ys.ravel() + 0.5 - nK[1, 2]) / nK[1, 1]
            d = _distort_normalized(np.stack([x, y], -1), c.distortion)
            sx = np.clip(d[:, 0] * c.K[0, 0] + c.K[0, 2], 0, w - 1).astype(np.int64)
            sy = np.clip(d[:, 1] * c.K[1, 1] + c.K[1, 2], 0, h - 1).astype(np.int64)
            self._remap = (sy.reshape(h, w), sx.reshape(h, w))
        sy, sx = self._remap
        return img[sy, sx]

    def load(self, i: int):
        with np.load(os.path.join(self.image_dir, self.files[i])) as z:
            img = np.asarray(z["image"], np.float32)
            if img.ndim == 2:
                img = img[..., None]
            if img.max() > 1.5:  # uint8-scaled input
                img = img / 255.0
            ts = float(z["timestamp"])
            mask = (
                np.asarray(z["mask"], bool)
                if "mask" in z
                else np.ones(img.shape[:2], bool)
            )
        if self._undistort:
            img = self._undistort_image(img)
            mask = self._undistort_image(mask)
        return img, mask, ts

    def __iter__(self):
        for i in range(len(self)):
            yield self.load(i)

    @property
    def K(self) -> np.ndarray:
        """Intrinsics valid for the (possibly rectified) returned images."""
        return self.calibration.new_K if self._undistort else self.calibration.K


def write_synthetic_images(
    root: str,
    scene: Optional[synthetic.Scene] = None,
    n_poses: int = 48,
    radius: float = 5.0,
    period: float = 9.6,
    height: int = 48,
    width: int = 64,
    max_range: float = 40.0,
) -> str:
    """Add a camera track (images + calibration.yaml) to a dataset root,
    rendered from the synthetic scene's intensity texture. The camera rides
    the lidar poses (identity extrinsics)."""
    scene = scene or synthetic.Scene.default()
    poses, ts = synthetic.circular_trajectory(n_poses, radius, period=period)
    K = np.array(
        [[width / 2, 0, width / 2], [0, width / 2, height / 2], [0, 0, 1.0]]
    )
    # camera looks forward: z_cam = +x_lidar, x_cam = -y_lidar, y_cam = -z_lidar
    T_lc = np.eye(4)
    T_lc[:3, :3] = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i, (T, t0) in enumerate(zip(poses, ts)):
        img, hit = synthetic.render_intensity_image(
            scene, T @ T_lc, K, height, width, max_range
        )
        np.savez_compressed(
            os.path.join(root, "images", f"{i:06d}.npz"),
            image=img,
            timestamp=np.float64(t0),
            mask=hit,
        )
    calib = CameraCalibration(
        K=K, distortion=np.zeros(5), width=width, height=height, lidar_to_camera=T_lc
    )
    with open(os.path.join(root, "calibration.yaml"), "w") as f:
        yaml.safe_dump(calib.as_dict(), f)
    return root
