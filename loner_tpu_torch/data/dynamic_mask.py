"""Dynamic-object masks for the camera path (host-side data prep).

The port of ``loner_tpu/data/dynamic_mask.py``. The reference masks the
harvester vehicle with Segment-Anything seeded by Lucas-Kanade keypoint
tracks and writes the masks into the bag; here three composable sources
give the same capability:

  1. ``geometric_box_mask``: a known vehicle-frame 3D box projected into
     the image;
  2. ``motion_residual_masks``: the residual against a temporal median of
     neighbouring frames;
  3. ``lk_region_masks``: Lucas-Kanade keypoint tracks seeding flood-filled
     regions (needs OpenCV; without it, it raises, as in the JAX package).

OpenCV is optional: without it the box mask is not closed and dilated and
the residual masks keep their speckles, as in the JAX package. Masks are
True where a pixel trains (static) and False where it is masked out.
``write_masks_into_sequence`` writes them into a sequence's image files.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def geometric_box_mask(
    K: np.ndarray,  # (3,3)
    T_cam_from_box: np.ndarray,  # (4,4): box frame -> camera frame
    box_center: Tuple[float, float, float],
    box_size: Tuple[float, float, float],
    height: int,
    width: int,
    samples_per_axis: int = 12,
) -> np.ndarray:
    """True = keep. Projects a dense sampling of the box volume and marks
    covered pixels False (the harvester box: 4.5 x 7 x 60 m at (0, 0.5, 2.5)
    in the reference's data prep, README_data_preparation.md:36-44)."""
    c = np.asarray(box_center, float)
    s = np.asarray(box_size, float) / 2.0
    lin = np.linspace(-1.0, 1.0, samples_per_axis)
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    pts_box = c + np.stack([gx, gy, gz], axis=-1).reshape(-1, 3) * s
    pts_cam = pts_box @ T_cam_from_box[:3, :3].T + T_cam_from_box[:3, 3]
    keep = np.ones((height, width), bool)
    front = pts_cam[:, 2] > 1e-3
    if not front.any():
        return keep
    p = pts_cam[front] @ K.T
    u = (p[:, 0] / p[:, 2]).astype(np.int64)
    v = (p[:, 1] / p[:, 2]).astype(np.int64)
    ok = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    keep[v[ok], u[ok]] = False
    if _HAS_CV2 and ok.any():
        # close + dilate so the sparse projected samples become a region
        m = (~keep).astype(np.uint8)
        kern = np.ones((7, 7), np.uint8)
        m = cv2.morphologyEx(m, cv2.MORPH_CLOSE, kern)
        m = cv2.dilate(m, kern)
        keep = m == 0
    return keep


def _to_gray(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    return img


def motion_residual_masks(
    images: Sequence[np.ndarray],
    threshold: float = 0.08,
    window: int = 5,
    dilate: int = 5,
    min_region: int = 8,
) -> List[np.ndarray]:
    """Per-image True=keep masks from the residual against a temporal median
    of neighboring frames: an object articulating against the background
    (the harvester arm) leaves a high residual; the (slow) ego-motion
    background mostly cancels in the median."""
    grays = [_to_gray(im) for im in images]
    n = len(grays)
    masks = []
    for i in range(n):
        lo, hi = max(0, i - window // 2), min(n, i + window // 2 + 1)
        med = np.median(np.stack(grays[lo:hi]), axis=0)
        resid = np.abs(grays[i] - med)
        dyn = resid > threshold
        if _HAS_CV2:
            m = dyn.astype(np.uint8)
            # drop speckles below min_region, then grow the survivors
            n_lab, lab, stats, _ = cv2.connectedComponentsWithStats(m, 8)
            for l in range(1, n_lab):
                if stats[l, cv2.CC_STAT_AREA] < min_region:
                    m[lab == l] = 0
            if dilate > 1:
                m = cv2.dilate(m, np.ones((dilate, dilate), np.uint8))
            dyn = m > 0
        masks.append(~dyn)
    return masks


def lk_region_masks(
    images: Sequence[np.ndarray],
    seed_points: np.ndarray,  # (P, 2) pixel coords in frame 0
    flood_tolerance: float = 0.06,
    patch: int = 9,
) -> List[np.ndarray]:
    """Track seed keypoints with pyramidal Lucas-Kanade and mask a
    flood-filled intensity region around each track — LK + region growing
    as the SAM stand-in (``image_detect_keypoints.py`` +
    ``image_segmentation.py`` roles)."""
    if not _HAS_CV2:
        raise RuntimeError("lk_region_masks requires cv2")
    grays8 = [np.clip(_to_gray(im) * 255, 0, 255).astype(np.uint8) for im in images]
    h, w = grays8[0].shape
    pts = np.asarray(seed_points, np.float32).reshape(-1, 1, 2)
    masks = []
    prev = grays8[0]
    for i, g in enumerate(grays8):
        if i > 0:
            pts_new, st, _ = cv2.calcOpticalFlowPyrLK(prev, g, pts, None)
            ok = st.reshape(-1) == 1
            pts = np.where(ok[:, None, None], pts_new, pts)
            prev = g
        dyn = np.zeros((h, w), np.uint8)
        ff_mask = np.zeros((h + 2, w + 2), np.uint8)
        tol = int(flood_tolerance * 255)
        for p in pts.reshape(-1, 2):
            x, y = int(round(p[0])), int(round(p[1]))
            if 0 <= x < w and 0 <= y < h:
                ff_mask[:] = 0
                cv2.floodFill(
                    g.copy(), ff_mask, (x, y), 255, tol, tol,
                    flags=cv2.FLOODFILL_MASK_ONLY | 8,
                )
                dyn |= ff_mask[1:-1, 1:-1]
                r = patch // 2
                dyn[max(0, y - r) : y + r + 1, max(0, x - r) : x + r + 1] = 1
        masks.append(dyn == 0)
    return masks


def combine_masks(*mask_lists: Sequence[np.ndarray]) -> List[np.ndarray]:
    """AND per-frame keep-masks from several sources."""
    out = []
    for frames in zip(*mask_lists):
        m = frames[0]
        for f in frames[1:]:
            m = np.logical_and(m, f)
        out.append(m)
    return out


def write_masks_into_sequence(root: str, masks: Sequence[np.ndarray]):
    """Write per-image masks back into the dataset's npz files — the
    mask-topic write-back of ``adjust_bags.py:16-60`` for our on-disk
    format."""
    image_dir = os.path.join(root, "images")
    files = sorted(f for f in os.listdir(image_dir) if f.endswith(".npz"))
    assert len(files) == len(masks), (len(files), len(masks))
    for f, m in zip(files, masks):
        path = os.path.join(image_dir, f)
        with np.load(path) as z:
            payload = {k: z[k] for k in z.files}
        payload["mask"] = np.asarray(m, bool)
        np.savez_compressed(path, **payload)
