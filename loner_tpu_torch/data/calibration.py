"""Camera calibration: loaders and undistortion (host-side data prep).

The port of ``loner_tpu/data/calibration.py``: the Fusion Portable
calibration loader (OpenCV FileStorage yaml with ``!!opencv-matrix`` tags;
lidar -> camera extrinsics from ``ouster00.yaml``, left-camera intrinsics
and distortion from ``frame_cam00.yaml``, ``image_scale_factor`` applied to
K), :class:`CameraCalibration` and its yaml form, and undistortion: the
plumb-bob (radtan) model inverted by fixed-point iteration in numpy (no
OpenCV), and the undistorted ray direction of every pixel.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import yaml

from loner_tpu_torch.geometry import se3


# ---------------------------------------------------------------------------
# opencv-matrix yaml
# ---------------------------------------------------------------------------


class _CvMatLoader(yaml.SafeLoader):
    """SafeLoader that understands the ``!!opencv-matrix`` tag the Fusion
    Portable calibration files use."""


def _cv_matrix(loader, node):
    m = loader.construct_mapping(node, deep=True)
    mat = np.asarray(m["data"], dtype=float)
    if m["rows"] > 1:
        mat = mat.reshape(m["rows"], m["cols"])
    return mat


_CvMatLoader.add_constructor("tag:yaml.org,2002:opencv-matrix", _cv_matrix)


def load_opencv_yaml(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    # opencv FileStorage writes a "%YAML:1.0" directive pyyaml rejects
    lines = [l for l in text.splitlines() if not l.startswith("%YAML")]
    return yaml.load("\n".join(lines), Loader=_CvMatLoader)


# ---------------------------------------------------------------------------
# calibration container
# ---------------------------------------------------------------------------


def _quat_trans_to_matrix(quat_xyzw, trans) -> np.ndarray:
    """(4, 4) float64 transform of an [x, y, z, w] quaternion (its rotation
    formed in float32, as the JAX package forms it) and a translation."""
    T = np.eye(4)
    q = np.asarray(quat_xyzw, np.float32).reshape(1, 4)
    T[:3, :3] = se3.quat_to_matrix(torch.as_tensor(q))[0].numpy()
    T[:3, 3] = np.asarray(trans, float).reshape(-1)
    return T


@dataclass
class CameraCalibration:
    K: np.ndarray  # (3,3) raw intrinsics
    distortion: np.ndarray  # (N,) plumb-bob [k1 k2 p1 p2 (k3)]
    width: int
    height: int
    new_K: Optional[np.ndarray] = None  # rectified intrinsics (defaults to K)
    distortion_model: str = "radtan"
    lidar_to_camera: np.ndarray = field(default_factory=lambda: np.eye(4))

    def __post_init__(self):
        if self.new_K is None:
            self.new_K = np.array(self.K)

    def scaled(self, image_scale_factor: float) -> "CameraCalibration":
        """Rescale intrinsics for downsampled images (the reference's
        ``to_dict(im_scale_factor)``)."""
        s = image_scale_factor
        K = np.array(self.K)
        K[:2, :] *= s
        new_K = np.array(self.new_K)
        new_K[:2, :] *= s
        return CameraCalibration(
            K=K,
            distortion=np.array(self.distortion),
            width=int(self.width * s),
            height=int(self.height * s),
            new_K=new_K,
            distortion_model=self.distortion_model,
            lidar_to_camera=np.array(self.lidar_to_camera),
        )

    def as_dict(self) -> dict:
        return {
            "K": self.K.tolist(),
            "new_K": self.new_K.tolist(),
            "distortion": np.asarray(self.distortion).tolist(),
            "distortion_model": self.distortion_model,
            "width": int(self.width),
            "height": int(self.height),
            "lidar_to_camera": self.lidar_to_camera.tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CameraCalibration":
        return cls(
            K=np.asarray(d["K"], float),
            distortion=np.asarray(d.get("distortion", []), float),
            width=int(d["width"]),
            height=int(d["height"]),
            new_K=np.asarray(d["new_K"], float) if "new_K" in d else None,
            distortion_model=d.get("distortion_model", "radtan"),
            lidar_to_camera=np.asarray(d.get("lidar_to_camera", np.eye(4)), float),
        )


def load_fusion_portable_calibration(
    calib_dir: str, image_scale_factor: float = 1.0
) -> CameraCalibration:
    """Parse a Fusion Portable calibration directory (e.g. 20220209_calib):
    ``calib/ouster00.yaml`` for lidar->left-cam extrinsics and
    ``calib/frame_cam00.yaml`` for left-cam intrinsics/distortion."""
    calib_dir = os.path.expanduser(calib_dir)
    lidar_cal = load_opencv_yaml(os.path.join(calib_dir, "calib", "ouster00.yaml"))
    cam_cal = load_opencv_yaml(os.path.join(calib_dir, "calib", "frame_cam00.yaml"))

    lidar_to_cam = _quat_trans_to_matrix(
        lidar_cal["quaternion_sensor_frame_cam00"],
        lidar_cal["translation_sensor_frame_cam00"],
    )
    proj = np.asarray(cam_cal["projection_matrix"], float)
    calib = CameraCalibration(
        K=np.asarray(cam_cal["camera_matrix"], float),
        distortion=np.asarray(cam_cal["distortion_coefficients"], float).reshape(-1),
        width=int(cam_cal["image_width"]),
        height=int(cam_cal["image_height"]),
        new_K=proj[:3, :3],
        distortion_model=str(cam_cal.get("distortion_model", "radtan")),
        lidar_to_camera=lidar_to_cam,
    )
    if image_scale_factor != 1.0:
        calib = calib.scaled(image_scale_factor)
    return calib


def load_calibration_yaml(path: str) -> CameraCalibration:
    """Our run/dataset-local calibration.yaml (CameraCalibration.as_dict)."""
    with open(path) as f:
        return CameraCalibration.from_dict(yaml.safe_load(f))


# ---------------------------------------------------------------------------
# undistortion
# ---------------------------------------------------------------------------


def _distort_normalized(xy: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Apply plumb-bob distortion to normalized coords (N, 2)."""
    d = np.zeros(8)
    d[: len(dist)] = dist
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    x, y = xy[:, 0], xy[:, 1]
    r2 = x * x + y * y
    radial = (1 + k1 * r2 + k2 * r2**2 + k3 * r2**3) / (
        1 + k4 * r2 + k5 * r2**2 + k6 * r2**3
    )
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def undistort_points(
    pixels: np.ndarray,  # (N, 2) distorted pixel coords
    K: np.ndarray,
    dist: np.ndarray,
    new_K: Optional[np.ndarray] = None,
    iters: int = 8,
) -> np.ndarray:
    """Undistorted pixel coords (N, 2) under ``new_K`` (defaults to K):
    the cv2.undistortPoints fixed-point iteration."""
    if dist is None or len(dist) == 0 or not np.any(dist):
        return np.asarray(pixels, float)
    K = np.asarray(K, float)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xd = (pixels[:, 0] - cx) / fx
    yd = (pixels[:, 1] - cy) / fy
    target = np.stack([xd, yd], axis=-1)
    xy = target.copy()
    for _ in range(iters):
        distorted = _distort_normalized(xy, dist)
        xy = xy + (target - distorted)
    nK = K if new_K is None else np.asarray(new_K, float)
    return np.stack(
        [xy[:, 0] * nK[0, 0] + nK[0, 2], xy[:, 1] * nK[1, 1] + nK[1, 2]], axis=-1
    )


def undistorted_pixel_rays(calib: CameraCalibration) -> np.ndarray:
    """(H*W, 3) unit camera-frame ray directions for every pixel of the
    DISTORTED image — the precomputed ray table of the reference's
    ``CameraRayDirections`` (``src/common/ray_utils.py:128-225``). Row-major
    (y, x) pixel order."""
    h, w = calib.height, calib.width
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([xs.ravel() + 0.5, ys.ravel() + 0.5], axis=-1).astype(float)
    und = undistort_points(pix, calib.K, calib.distortion, new_K=None)
    dirs = np.concatenate([und, np.ones((len(und), 1))], axis=-1)
    # normalized-plane coords back out of K (new_K=None keeps K)
    fx, fy, cx, cy = calib.K[0, 0], calib.K[1, 1], calib.K[0, 2], calib.K[1, 2]
    dirs[:, 0] = (und[:, 0] - cx) / fx
    dirs[:, 1] = (und[:, 1] - cy) / fy
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs.astype(np.float32)
