"""Sky-ray extraction from lidar scans by spherical-projection morphology.

The port of ``loner_tpu/tracking/sky.py`` (host numpy): project the sweep
into an azimuth x elevation occupancy image, close it morphologically, and
emit directions of the empty cells above a minimum elevation. The closing is
written in numpy with OpenCV's border rule (the dilation pads with empty
cells, the erosion with occupied ones), so no OpenCV is needed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def spherical_projection(
    directions: np.ndarray,  # (N, 3) unit directions, sensor frame
    valid: np.ndarray,  # (N,)
    n_azimuth: int = 256,
    n_elevation: int = 64,
    elevation_range: Tuple[float, float] = (-np.pi / 6, np.pi / 2),
) -> np.ndarray:
    """(n_elevation, n_azimuth) bool image, True where a return landed; row 0
    is the highest elevation."""
    d = directions[valid]
    az = np.arctan2(d[:, 1], d[:, 0])
    el = np.arcsin(np.clip(d[:, 2], -1, 1))
    lo, hi = elevation_range
    col = ((az + np.pi) / (2 * np.pi) * n_azimuth).astype(np.int64) % n_azimuth
    row = np.clip(((hi - el) / (hi - lo) * n_elevation).astype(np.int64), 0, n_elevation - 1)
    inside = (el >= lo) & (el <= hi)
    img = np.zeros((n_elevation, n_azimuth), bool)
    img[row[inside], col[inside]] = True
    return img


def _window_reduce(img: np.ndarray, k: int, pad_value: bool, reduce) -> np.ndarray:
    """``reduce`` (np.logical_or / np.logical_and) over each k x k window
    centred on a cell, the border padded with ``pad_value``."""
    a = k // 2
    padded = np.pad(img, ((a, k - 1 - a), (a, k - 1 - a)), constant_values=pad_value)
    h, w = img.shape
    out = padded[:h, :w].copy()
    for dy in range(k):
        for dx in range(k):
            out = reduce(out, padded[dy : dy + h, dx : dx + w])
    return out


def morphological_close(img: np.ndarray, k: int) -> np.ndarray:
    """Closing by a k x k square: a dilation then an erosion."""
    dilated = _window_reduce(img, k, False, np.logical_or)
    return _window_reduce(dilated, k, True, np.logical_and)


def extract_sky_directions(
    directions: np.ndarray,
    valid: np.ndarray,
    n_azimuth: int = 256,
    n_elevation: int = 64,
    elevation_range: Tuple[float, float] = (-np.pi / 6, np.pi / 2),
    min_elevation_deg: float = 5.0,
    closing_kernel: int = 3,
    max_rays: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """(M, 3) directions of the cells above ``min_elevation_deg`` that stay
    empty after the closing fills small no-return speckles."""
    occ = spherical_projection(directions, valid, n_azimuth, n_elevation, elevation_range)
    if closing_kernel > 1:
        occ = morphological_close(occ, closing_kernel)

    lo, hi = elevation_range
    cell_el = hi - (np.arange(n_elevation) + 0.5) / n_elevation * (hi - lo)
    rr, cc = np.nonzero(~occ & (cell_el > np.deg2rad(min_elevation_deg))[:, None])
    if len(rr) == 0:
        return np.zeros((0, 3), np.float32)
    el = hi - (rr + 0.5) / n_elevation * (hi - lo)
    az = (cc + 0.5) / n_azimuth * 2 * np.pi - np.pi
    dirs = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1).astype(np.float32)
    if max_rays is not None and len(dirs) > max_rays:
        rng = rng or np.random.default_rng(0)
        dirs = dirs[rng.choice(len(dirs), max_rays, replace=False)]
    return dirs
