"""Render output utilities: depth colormaps, image and video writers, and
smooth camera paths for fly-through videos.

The port of ``loner_tpu/analysis/render_utils.py``; host numpy only. The
colormap needs matplotlib, the writers imageio and the camera path scipy,
each imported by the function that uses it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def depth_colormap(depth_m: np.ndarray, min_depth: float = 1.0, max_depth: float = 50.0,
                   cmap: str = "turbo") -> np.ndarray:
    """(H, W, 4) uint8 colormapped metric depth; pixels at or beyond
    ``max_depth`` are black."""
    import matplotlib

    img = np.asarray(depth_m, np.float64)
    far = img >= max_depth
    x = (np.clip(img, min_depth, max_depth) - min_depth) / (max_depth - min_depth)
    colored = matplotlib.colormaps[cmap](np.clip(x, 0.0, 1.0))
    colored[far] = np.array([0.0, 0.0, 0.0, 1.0])
    return (colored * 255).astype(np.uint8)


def save_depth_png(depth_m: np.ndarray, path: str, min_depth: float = 1.0, max_depth: float = 50.0) -> None:
    import imageio.v2 as imageio

    imageio.imwrite(path, depth_colormap(depth_m, min_depth, max_depth))


def save_rgb_png(img: np.ndarray, path: str) -> None:
    """``img`` (H, W, C), float in [0, 1] or uint8, C 1 or 3."""
    import imageio.v2 as imageio

    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    imageio.imwrite(path, a)


def write_video(frames: Sequence[np.ndarray], path: str, fps: float = 5.0) -> None:
    """(H, W, 3 or 4) uint8 frames as a video, mp4 or gif by the extension."""
    import imageio.v2 as imageio

    frames = [np.asarray(f)[..., :3] for f in frames]
    if path.endswith(".gif"):  # the pillow writer takes a duration a frame, in ms
        imageio.mimwrite(path, frames, duration=1000.0 / fps)
    else:
        imageio.mimwrite(path, frames, fps=fps)


def interpolate_camera_path(poses: np.ndarray, velocity: float = 1.0, fps: float = 5.0,
                            spin_spacing_m: Optional[float] = 10.0, spin_duration_s: float = 15.0,
                            no_interp: bool = False) -> Tuple[np.ndarray, List[int]]:
    """A smooth camera path through the key ``poses`` (N, 4, 4) at a
    constant ``velocity`` (m/s), ``fps`` frames a second (slerp of the
    rotations, linear positions, by arc length), with an in-place 360-degree
    spin about z every ``spin_spacing_m`` metres. Returns ((M, 4, 4) poses,
    the indices where spins start); ``no_interp`` returns the key poses."""
    from scipy.interpolate import interp1d
    from scipy.spatial.transform import Rotation, Slerp

    T = np.asarray(poses, np.float64)
    if no_interp:
        return T.copy(), []

    xyz = T[:, :3, 3]
    dists = np.linalg.norm(np.diff(xyz, axis=0), axis=1)
    t = np.concatenate([[0.0], np.cumsum(dists / max(velocity, 1e-9))])
    # slerp needs strictly increasing times: merge stationary key poses
    keep = np.concatenate([[True], np.diff(t) > 1e-9])
    t, xyz, rots = t[keep], xyz[keep], Rotation.from_matrix(T[keep, :3, :3])
    if len(t) < 2:
        return T.copy(), []

    slerp = Slerp(t, rots)
    lerp = interp1d(t, xyz, axis=0)
    n_frames = max(int(t[-1] * fps), 2)
    out: List[np.ndarray] = []
    spin_idxs: List[int] = []
    dist_since_spin = 0.0
    prev_xyz = xyz[0]
    for s in np.linspace(0.0, t[-1], n_frames):
        p = lerp(s)
        P = np.eye(4)
        P[:3, :3] = slerp(s).as_matrix()
        P[:3, 3] = p
        out.append(P)
        dist_since_spin += float(np.linalg.norm(p - prev_xyz))
        prev_xyz = p
        if spin_spacing_m and dist_since_spin > spin_spacing_m:
            spin_idxs.append(len(out))
            for a in np.linspace(0.0, 2 * np.pi, int(spin_duration_s * fps)):
                c, si = np.cos(a), np.sin(a)
                S = P.copy()
                S[:3, :3] = P[:3, :3] @ np.array([[c, -si, 0], [si, c, 0], [0, 0, 1.0]])
                out.append(S)
            dist_since_spin = 0.0
    return np.stack(out), spin_idxs
