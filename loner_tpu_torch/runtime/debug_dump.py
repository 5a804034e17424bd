"""The debug block's visual dumps: point clouds and loss distributions.

The port of ``loner_tpu/runtime/debug_dump.py``. With ``debug.global_enabled``
and a flag on, the tracker writes each registration's ICP clouds (input,
aligned, target) and the mapper runs one probe pass a window
(``mapping/optimizer.py::make_debug_probe``: the train step's rays, samples
and render, without gradients) whose rays, sample points and per-ray loss
terms land under ``<dump_dir>/keyframe_<k>/``. The train step itself is
untouched.

PCD files are ASCII PCD v0.7 (Open3D, CloudCompare and pcl read them); the
loss histograms are a PNG when matplotlib is there, and an npz of the
per-ray vectors always.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class DebugFlags:
    """The cfg ``debug:`` block's dump flags: ``global_enabled`` gates them
    all, each flag opts into one family of dumps."""

    global_enabled: bool = False
    draw_icp_clouds: bool = False  # tracker: pre-align, aligned and target clouds
    draw_rays: bool = False  # mapper probe: ray origins and endpoints
    draw_samples: bool = False  # mapper probe: sampled field points and weights
    draw_loss_distribution: bool = False  # mapper probe: per-ray loss histograms
    dump_dir: Optional[str] = None  # LonerSLAM sets <out_dir>/debug

    def on(self, name: str) -> bool:
        return bool(self.global_enabled and getattr(self, name) and self.dump_dir)

    @property
    def mapper_any(self) -> bool:
        return any(self.on(n) for n in ("draw_rays", "draw_samples", "draw_loss_distribution"))


def write_pcd(path: str, points: np.ndarray, intensity: Optional[np.ndarray] = None):
    """An ASCII PCD v0.7 file of (x y z [intensity]) rows."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    cols = ["x", "y", "z"]
    data = pts
    if intensity is not None:
        data = np.concatenate([pts, np.asarray(intensity, np.float32).reshape(-1, 1)], axis=1)
        cols.append("intensity")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(data)
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n")
        f.write(f"FIELDS {' '.join(cols)}\n")
        f.write(f"SIZE {' '.join(['4'] * len(cols))}\n")
        f.write(f"TYPE {' '.join(['F'] * len(cols))}\n")
        f.write(f"COUNT {' '.join(['1'] * len(cols))}\n")
        f.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n")
        f.write("DATA ascii\n")
        np.savetxt(f, data, fmt="%.6f")


def read_pcd(path: str) -> np.ndarray:
    """The (N, C) rows of an ASCII PCD file that :func:`write_pcd` wrote."""
    with open(path) as f:
        lines = f.readlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("DATA")) + 1
    return np.loadtxt(lines[start:], dtype=np.float32).reshape(len(lines) - start, -1)


def write_loss_distribution(directory: str, per_ray: Dict[str, np.ndarray]):
    """``loss_distribution.npz`` of the per-ray vectors and, with
    matplotlib, ``loss_distribution.png``: a histogram of each (but the
    masks) over the valid rays' finite values."""
    os.makedirs(directory, exist_ok=True)
    arrays = {k: np.asarray(v).ravel() for k, v in per_ray.items()}
    np.savez(os.path.join(directory, "loss_distribution.npz"), **arrays)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    keys = [k for k in arrays if arrays[k].size and k not in ("valid", "opaque")]
    if not keys:
        return
    fig, axes = plt.subplots(1, len(keys), figsize=(4 * len(keys), 3))
    if len(keys) == 1:
        axes = [axes]
    mask = arrays.get("valid")
    for ax, k in zip(axes, keys):
        v = arrays[k]
        if mask is not None and mask.shape == v.shape:
            v = v[mask > 0]
        v = v[np.isfinite(v)]
        if v.size:
            ax.hist(v, bins=50)
        ax.set_title(k)
    fig.tight_layout()
    fig.savefig(os.path.join(directory, "loss_distribution.png"), dpi=100)
    plt.close(fig)


def dump_window_probe(flags: DebugFlags, tag: str, probe_out: Dict[str, np.ndarray], scale: float,
                      shift: np.ndarray):
    """Write one window's probe diagnostics under ``<dump_dir>/<tag>/``.
    ``probe_out`` holds the probe's cube-frame arrays (numpy); points are
    mapped to the metric world (x * scale - shift) before they are written,
    and only the valid rays' are."""
    d = os.path.join(flags.dump_dir, tag)
    shift = np.asarray(shift, np.float32).reshape(1, 3)

    def to_world(p):
        return np.asarray(p, np.float32).reshape(-1, 3) * scale - shift

    valid = np.asarray(probe_out["valid"]).astype(bool).ravel()
    if flags.on("draw_rays"):
        write_pcd(os.path.join(d, "ray_origins.pcd"), to_world(probe_out["origins"])[valid])
        write_pcd(os.path.join(d, "ray_endpoints.pcd"), to_world(probe_out["endpoints"])[valid],
                  intensity=np.asarray(probe_out["depth_err"]).ravel()[valid])
    if flags.on("draw_samples"):
        pts = np.asarray(probe_out["points"], np.float32)[valid].reshape(-1, 3)  # (N, S, 3) -> valid rays'
        w = np.asarray(probe_out["weights"], np.float32)[valid].ravel()
        write_pcd(os.path.join(d, "sample_points.pcd"), pts * scale - shift, intensity=w)
    if flags.on("draw_loss_distribution"):
        write_loss_distribution(d, {
            "depth_err_m": np.asarray(probe_out["depth_err"]),
            "js": np.asarray(probe_out["js"]),
            "los": np.asarray(probe_out["los"]),
            "valid": valid.astype(np.float32),
        })
