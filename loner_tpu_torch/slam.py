"""The SLAM orchestrator: tracker, mapper and trajectory logger.

The port of ``loner_tpu/slam.py``: wires tracking and mapping together and
writes the output directory's contract, either inline (``single_threaded``,
the deterministic mode) or with the mapper on a worker thread fed through a
queue, the tracker held back when it runs more than ``max_time_delta``
seconds ahead of the last mapped frame. The tracker and the mapper run on
one device; the worker thread enters that device, since torch's current
device is per thread.

Not ported, and raising ``NotImplementedError``: loop closure (queue A item
1), camera images (item 2), and the tracker and mapper on disjoint cards
(item 7).
"""
from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from loner_tpu_torch.data.scan import LidarScan, sky_scan
from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.geometry.world_cube import WorldCube
from loner_tpu_torch.mapping.mapper import OnlineMapper, OnlineMapperConfig
from loner_tpu_torch.runtime.trajectory_logger import TrajectoryLogger
from loner_tpu_torch.tracking.frame_synthesis import FrameSynthesis, FrameSynthesisConfig
from loner_tpu_torch.tracking.icp import IcpConfig, IcpStage
from loner_tpu_torch.tracking.tracker import Tracker, TrackerConfig


@dataclass
class LoopClosureConfig:
    """The pose-graph loop closure's configuration (the closure itself is
    queue A item 1; ``enabled`` raises)."""

    enabled: bool = False
    min_index_gap: int = 8
    max_candidate_distance_m: float = 4.0
    max_candidates: int = 16
    suppression_radius: int = 1
    min_fitness: float = 0.35
    max_rmse: float = 0.3
    icp: IcpConfig = field(default_factory=lambda: IcpConfig(stages=(IcpStage(1.5, 10), IcpStage(0.25, 10)),
                                                             n_buckets=1 << 13))
    target_points: int = 2048
    odometry_weight: float = 1.0
    loop_weight: float = 2.0
    prior_weight: float = 0.01
    gn_iterations: int = 10


@dataclass
class SlamConfig:
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    frame_synthesis: FrameSynthesisConfig = field(default_factory=FrameSynthesisConfig)
    mapper: OnlineMapperConfig = field(default_factory=OnlineMapperConfig)
    single_threaded: bool = True
    # the tracker may run at most this far ahead of the last mapped frame
    max_time_delta: float = 3.0
    use_groundtruth_poses: bool = False
    loop_closure: LoopClosureConfig = field(default_factory=LoopClosureConfig)
    concurrent_device_split: bool = False  # queue A item 7


class LonerSLAM:
    def __init__(self, cfg: SlamConfig, cube: WorldCube, out_dir: Optional[str] = None, device="cuda"):
        if cfg.loop_closure.enabled:
            raise NotImplementedError("loop_closure.enabled: the pose-graph loop closure is not ported "
                                      "(ROADMAP.md, queue A item 1)")
        if cfg.concurrent_device_split:
            raise NotImplementedError("concurrent_device_split: tracker and mapper on disjoint cards is not "
                                      "ported (ROADMAP.md, queue A item 7)")
        self.cfg = cfg
        self.cube = cube
        self.out_dir = out_dir
        self.device = resolve_device(device)
        if out_dir and cfg.mapper.checkpoint_dir is None:
            cfg.mapper.checkpoint_dir = os.path.join(out_dir, "checkpoints")
        if out_dir and cfg.mapper.loss_log_dir is None:
            cfg.mapper.loss_log_dir = os.path.join(out_dir, "losses")
        if out_dir and cfg.mapper.debug.dump_dir is None:
            cfg.mapper.debug.dump_dir = os.path.join(out_dir, "debug")
        # one debug block for tracker and mapper
        if cfg.tracker.debug is None:
            cfg.tracker.debug = cfg.mapper.debug
        self.tracker = Tracker(cfg.tracker, self.device)
        self.frame_synthesis = FrameSynthesis(cfg.frame_synthesis)
        self.mapper = OnlineMapper(cfg.mapper, cube, self.device)
        self.logger = TrajectoryLogger()
        self.mapper.keyframe_update_callbacks.append(self.logger.update_keyframe)

        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_mapped_time = 0.0
        self._worker_error: Optional[BaseException] = None
        if not cfg.single_threaded:
            self._worker = threading.Thread(target=self._mapper_loop, daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------
    def _mapper_loop(self):
        on_card = torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext()
        with on_card:
            while not self._stop.is_set() or not self._queue.empty():
                try:
                    item = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                try:
                    self._map_frame(*item)
                except Exception as e:  # raised again by stop()
                    self._worker_error = e
                    break

    def _map_frame(self, scan, timestamp, pose, gt_pose, sky):
        self.mapper.process_frame(scan, timestamp, pose, gt_pose=gt_pose, sky=sky,
                                  use_gt_pose=self.cfg.use_groundtruth_poses)
        self._last_mapped_time = timestamp

    # ------------------------------------------------------------------
    def process_scan(self, scan: LidarScan, timestamp: float, gt_pose: Optional[np.ndarray] = None,
                     sky: Optional[LidarScan] = None) -> Optional[np.ndarray]:
        """Feed one lidar sweep. The tracked pose if the scan survived
        decimation, else None."""
        if not self.frame_synthesis.accepts(timestamp):
            return None

        result = self.tracker.track(scan, timestamp)
        self.logger.log_frame(timestamp, result.pose, gt_pose)

        # the tracker's sky directions become transparent supervision rays
        # unless the caller gave its own
        if sky is None and result.sky_dirs is not None and len(result.sky_dirs):
            sky = sky_scan(result.sky_dirs, self.cfg.mapper.mapper.ray_range[1] + 1.0, timestamp,
                           pad_to=self.cfg.mapper.n_sky_pad)

        item = (result.scan, timestamp, result.pose, gt_pose, sky)
        if self.cfg.single_threaded:
            self._map_frame(*item)
        else:
            # backpressure: stay within max_time_delta of the mapper
            while (timestamp - self._last_mapped_time > self.cfg.max_time_delta and not self._queue.empty()
                   and self._worker_error is None):
                time.sleep(0.005)
            self._queue.put(item)
        return result.pose

    def process_image(self, image: np.ndarray, timestamp: float) -> None:
        raise NotImplementedError("process_image: camera images are not ported (ROADMAP.md, queue A item 2)")

    def stop(self, out_dir: Optional[str] = None):
        """Drain the mapper's queue, stop the worker, and write the output
        directory: checkpoints, trajectory/*.txt, track_times.csv,
        map_times.csv and timing.csv."""
        if self._worker is not None:
            self._stop.set()
            self._worker.join(timeout=600)
            if self._worker.is_alive():
                raise RuntimeError("the mapper thread did not finish its queue within 600 s")
        if self._worker_error is not None:
            raise self._worker_error

        out_dir = out_dir or self.out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            if len(self.mapper.kf_manager):
                self.mapper.save_final(os.path.join(out_dir, "checkpoints"))
            self.logger.finish(os.path.join(out_dir, "trajectory"))
            np.savetxt(os.path.join(out_dir, "track_times.csv"), np.asarray(self.tracker.track_times), delimiter=",")
            np.savetxt(os.path.join(out_dir, "map_times.csv"), np.asarray(self.mapper.map_times), delimiter=",")
            self.mapper.window_timer.write_csv(os.path.join(out_dir, "timing.csv"))
