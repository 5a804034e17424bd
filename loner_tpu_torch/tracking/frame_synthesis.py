"""Frame synthesis: scan decimation and image <-> scan matching.

The port of ``loner_tpu/tracking/frame_synthesis.py`` (host Python): scans
are decimated to ``frame_decimation_rate_hz``; in camera mode each image is
matched to the first scan whose [start, end] timestamp interval, padded by
``frame_match_tolerance``, contains it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

from loner_tpu_torch.data.scan import LidarScan


@dataclass
class FrameSynthesisConfig:
    frame_decimation_rate_hz: float = 5.0
    decimate_on_load: bool = True
    frame_match_tolerance: float = 0.01
    frame_delta_t_sec_tolerance: float = 0.02


@dataclass
class MatchedFrame:
    """An image matched to its overlapping lidar scan."""

    image: Any  # (H, W, C) array
    image_timestamp: float
    scan: LidarScan
    scan_timestamp: float  # the frame timestamp the scan was processed under


class FrameSynthesis:
    def __init__(self, cfg: FrameSynthesisConfig):
        self.cfg = cfg
        self._last_kept_time: Optional[float] = None
        self._pending_images: List[Tuple[Any, float]] = []
        # (scan, frame timestamp, interval start, interval end)
        self._pending_scans: List[Tuple[LidarScan, float, float, float]] = []
        self._completed: List[MatchedFrame] = []

    def accepts(self, timestamp: float) -> bool:
        """True if a scan at this timestamp survives decimation."""
        if self.cfg.frame_decimation_rate_hz <= 0:
            return True
        period = 1.0 / self.cfg.frame_decimation_rate_hz - self.cfg.frame_delta_t_sec_tolerance
        if self._last_kept_time is None or (timestamp - self._last_kept_time) >= period - 1e-6:
            self._last_kept_time = timestamp
            return True
        return False

    def process_image(self, image, timestamp: float):
        """Enqueue an image (timestamps increase)."""
        self._pending_images.append((image, timestamp))
        self._match()

    def process_scan_for_matching(self, scan: LidarScan, timestamp: float):
        """Enqueue a scan for image matching."""
        ts, valid = np.asarray(scan.timestamps), np.asarray(scan.valid)
        t0 = float(ts[valid].min()) if valid.any() else timestamp
        t1 = float(ts[valid].max()) if valid.any() else timestamp
        self._pending_scans.append((scan, timestamp, t0, t1))
        self._match()

    def _match(self):
        """Pair each image with the first scan whose padded interval holds its
        timestamp; the matched scan and those before it are dropped. An image
        older than every pending interval can never match and is skipped."""
        tol = self.cfg.frame_match_tolerance
        while self._pending_images and self._pending_scans:
            img, t_img = self._pending_images[0]
            matched = next((i for i, (_, _, t0, t1) in enumerate(self._pending_scans)
                            if t0 - tol <= t_img <= t1 + tol), None)
            if matched is None:
                if t_img < self._pending_scans[-1][-1] - tol:
                    self._pending_images.pop(0)
                    continue
                break  # waiting on a later scan
            scan, t_frame, _, _ = self._pending_scans[matched]
            self._completed.append(MatchedFrame(img, t_img, scan, t_frame))
            self._pending_images.pop(0)
            del self._pending_scans[: matched + 1]

    def has_frame(self) -> bool:
        return bool(self._completed)

    def pop_frame(self) -> Optional[MatchedFrame]:
        return self._completed.pop(0) if self._completed else None
