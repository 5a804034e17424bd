"""The odometry tracker: frame-to-frame ICP with motion compensation.

The port of ``loner_tpu/tracking/tracker.py``: a downsampled cloud from the
first ``scan_duration`` fraction of each sweep (host numpy, as in the JAX
package), registered against the previous frame's cloud by the coarse-to-fine
point-to-plane ICP from the identity; the first frame anchors the origin;
the scan is motion-compensated with the interpolated pose. ICP and motion
compensation run on the tracker's device. With the debug block's
``draw_icp_clouds`` on, each registration writes its clouds (input,
aligned, target) under ``<dump_dir>/frame_<n>/``.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from loner_tpu_torch.data.scan import LidarScan
from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.geometry.motion import motion_compensate
from loner_tpu_torch.tracking.icp import IcpConfig, make_icp
from loner_tpu_torch.tracking.sky import extract_sky_directions


@dataclass
class TrackerConfig:
    icp: IcpConfig = field(default_factory=IcpConfig)
    scan_duration: float = 0.9  # ICP uses the first fraction of the sweep
    target_points: int = 4096  # uniform downsample budget (static shape)
    motion_compensation: bool = True
    # sky segmentation: directions of empty upper-hemisphere cells, which the
    # SLAM loop turns into transparent supervision rays
    sky_segmentation: bool = False
    sky_max_rays: int = 1024
    sky_min_elevation_deg: float = 5.0
    # pins the tracker to one device of several (ROADMAP queue A item 3)
    device_index: Optional[int] = None
    # the debug block's flags (runtime/debug_dump.DebugFlags): draw_icp_clouds
    # dumps each registration's clouds
    debug: Optional[object] = None


@dataclass
class TrackResult:
    pose: np.ndarray  # (4, 4) world_T_lidar of this frame
    scan: LidarScan  # motion-compensated scan (numpy)
    rmse: float
    fitness: float
    wall_time_s: float
    sky_dirs: Optional[np.ndarray] = None  # (M, 3) sensor-frame sky directions


class Tracker:
    def __init__(self, cfg: TrackerConfig = TrackerConfig(), device="cuda"):
        if cfg.device_index is not None:
            raise NotImplementedError(
                "TrackerConfig.device_index: pinning the tracker to one of several cards is not ported "
                "(ROADMAP.md, queue A item 3)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._icp = make_icp(cfg.icp, self.device)
        self._prev_cloud: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._prev_pose: Optional[np.ndarray] = None
        self._prev_time: Optional[float] = None
        self.track_times: List[float] = []
        self._frame_count = 0  # frames tracked: names the ICP cloud dumps

    def _extract_cloud(self, scan: LidarScan) -> Tuple[torch.Tensor, torch.Tensor]:
        """The sweep's first ``scan_duration`` fraction, downsampled by a
        uniform stride to the fixed budget, in the sensor frame (host prep),
        then moved to the tracker's device."""
        dirs, dist = np.asarray(scan.ray_directions), np.asarray(scan.distances)
        ts, valid = np.asarray(scan.timestamps), np.asarray(scan.valid)
        tmin = ts[valid].min() if valid.any() else 0.0
        tmax = ts[valid].max() if valid.any() else 1.0
        idx = np.flatnonzero(valid & (ts <= tmin + self.cfg.scan_duration * (tmax - tmin)))
        n = self.cfg.target_points
        if len(idx) > n:
            idx = idx[np.linspace(0, len(idx) - 1, n).astype(np.int64)]
        pts = np.zeros((n, 3), np.float32)
        pts[: len(idx)] = dirs[idx] * dist[idx, None]
        v = np.arange(n) < len(idx)
        return torch.from_numpy(pts).to(self.device), torch.from_numpy(v).to(self.device)

    def _dump_icp_clouds(self, cloud, cloud_valid, prev_pts, prev_valid, T_rel):
        """This registration's clouds as PCD files under
        ``frame_<n>/``: the input, the input moved by ``T_rel`` (the
        aligned cloud) and the target, valid points only."""
        from loner_tpu_torch.runtime.debug_dump import write_pcd

        d = os.path.join(self.cfg.debug.dump_dir, f"frame_{self._frame_count}")
        src = cloud.cpu().numpy()[cloud_valid.cpu().numpy()]
        tgt = prev_pts.cpu().numpy()[prev_valid.cpu().numpy()]
        T = T_rel.cpu().numpy()
        write_pcd(os.path.join(d, "icp_input.pcd"), src)
        write_pcd(os.path.join(d, "icp_aligned.pcd"), src @ T[:3, :3].T + T[:3, 3])
        write_pcd(os.path.join(d, "icp_target.pcd"), tgt)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def track(self, frame_scan: LidarScan, timestamp: float) -> TrackResult:
        t0 = time.time()
        cloud, cloud_valid = self._extract_cloud(frame_scan)

        if self._prev_cloud is None:
            pose = np.eye(4)  # the first frame anchors the origin
            rmse, fitness = 0.0, 1.0
        else:
            prev_pts, prev_valid = self._prev_cloud
            T_rel, rmse_t, fit_t = self._icp(cloud, cloud_valid, prev_pts, prev_valid,
                                             torch.eye(4, dtype=torch.float32, device=self.device))
            # T_rel maps the current sensor frame into the previous one
            pose = self._prev_pose @ T_rel.cpu().numpy().astype(np.float64)
            rmse, fitness = float(rmse_t), float(fit_t)
            if self.cfg.debug is not None and self.cfg.debug.on("draw_icp_clouds"):
                self._dump_icp_clouds(cloud, cloud_valid, prev_pts, prev_valid, T_rel)

        scan = frame_scan
        if self.cfg.motion_compensation and self._prev_pose is not None:
            pose_t = self._tensor(pose)
            new_dirs, new_dists = motion_compensate(
                self._tensor(frame_scan.ray_directions), self._tensor(frame_scan.distances),
                self._tensor(frame_scan.timestamps), self._tensor(self._prev_pose), pose_t,
                self._tensor(self._prev_time), self._tensor(timestamp), pose_t,
            )
            scan = frame_scan._replace(ray_directions=new_dirs.cpu().numpy(), distances=new_dists.cpu().numpy())
            cloud, cloud_valid = self._extract_cloud(scan)

        self._prev_cloud = (cloud, cloud_valid)
        self._prev_pose = pose
        self._prev_time = timestamp

        sky_dirs = None
        if self.cfg.sky_segmentation:
            sky_dirs = extract_sky_directions(
                np.asarray(scan.ray_directions), np.asarray(scan.valid),
                min_elevation_deg=self.cfg.sky_min_elevation_deg, max_rays=self.cfg.sky_max_rays,
            )

        dt = time.time() - t0
        self.track_times.append(dt)
        self._frame_count += 1
        return TrackResult(pose=pose, scan=scan, rmse=rmse, fitness=fitness, wall_time_s=dt, sky_dirs=sky_dirs)
