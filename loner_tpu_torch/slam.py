"""The SLAM orchestrator: tracker, mapper and trajectory logger.

The port of ``loner_tpu/slam.py``: wires tracking and mapping together and
writes the output directory's contract, either inline (``single_threaded``,
the deterministic mode) or with the mapper on a worker thread fed through a
queue, the tracker held back when it runs more than ``max_time_delta``
seconds ahead of the last mapped frame. The tracker and the mapper run on
one device; the worker thread enters that device, since torch's current
device is per thread.

In camera mode (``mapper.camera.enabled``) ``process_image`` takes camera
images: each is matched to the scan whose padded time interval holds it
(``tracking/frame_synthesis.py``) and attached to that scan's keyframe
through the same queue as the scans, so a match reaches the mapper after
its scan. With ``loop_closure.enabled``, ``stop`` refines the keyframe
poses by a pose graph with ICP loop closures (``mapping/loop_closure.py``)
before it writes the outputs, and writes ``ba_info.json``.

Not ported, and raising ``NotImplementedError``: the tracker and mapper on
disjoint cards (queue A item 3).
"""
from __future__ import annotations

import contextlib
import json
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
from loner_tpu_torch.mapping.keyframe_manager import pose6_to_matrix
from loner_tpu_torch.mapping.loop_closure import LoopClosureConfig, refine_keyframe_poses
from loner_tpu_torch.mapping.mapper import OnlineMapper, OnlineMapperConfig
from loner_tpu_torch.runtime.trajectory_logger import TrajectoryLogger
from loner_tpu_torch.tracking.frame_synthesis import FrameSynthesis, FrameSynthesisConfig
from loner_tpu_torch.tracking.tracker import Tracker, TrackerConfig


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
    concurrent_device_split: bool = False  # queue A item 3


class LonerSLAM:
    def __init__(self, cfg: SlamConfig, cube: WorldCube, out_dir: Optional[str] = None, device="cuda"):
        if cfg.concurrent_device_split:
            raise NotImplementedError("concurrent_device_split: tracker and mapper on disjoint cards is not "
                                      "ported (ROADMAP.md, queue A item 3)")
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
        self.ba_info: Optional[dict] = None
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
                    self._dispatch(item)
                except Exception as e:  # raised again by stop()
                    self._worker_error = e
                    break

    def _map_frame(self, scan, timestamp, pose, gt_pose, sky):
        self.mapper.process_frame(scan, timestamp, pose, gt_pose=gt_pose, sky=sky,
                                  use_gt_pose=self.cfg.use_groundtruth_poses)
        self._last_mapped_time = timestamp

    def _dispatch(self, item):
        kind, payload = item
        if kind == "scan":
            self._map_frame(*payload)
        else:  # "image": attach a matched image to its scan's keyframe
            scan, image, t_img, t_scan = payload
            self.mapper.attach_image(scan, image, t_img, scan_timestamp=t_scan)

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

        item = ("scan", (result.scan, timestamp, result.pose, gt_pose, sky))
        if self.cfg.single_threaded:
            self._dispatch(item)
        else:
            # backpressure: stay within max_time_delta of the mapper
            while (timestamp - self._last_mapped_time > self.cfg.max_time_delta and not self._queue.empty()
                   and self._worker_error is None):
                time.sleep(0.005)
            self._queue.put(item)
        if self.cfg.mapper.camera.enabled:
            # the mapped scan waits for its image; the queue's order lets a
            # match reach the mapper only after its scan
            self.frame_synthesis.process_scan_for_matching(result.scan, timestamp)
            self._drain_image_matches()
        return result.pose

    def process_image(self, image: np.ndarray, timestamp: float) -> None:
        """Feed one camera image (H, W, C) in [0, 1]. It is matched to the
        first scan whose padded time interval holds ``timestamp`` and
        attached to that scan's keyframe; the mapper trains the intensity
        branch on the window's images after each lidar pass."""
        if not self.cfg.mapper.camera.enabled:
            raise RuntimeError("process_image requires SlamConfig.mapper.camera.enabled")
        self.frame_synthesis.process_image(np.asarray(image, np.float32), timestamp)
        self._drain_image_matches()

    def _drain_image_matches(self):
        while self.frame_synthesis.has_frame():
            mf = self.frame_synthesis.pop_frame()
            item = ("image", (mf.scan, mf.image, mf.image_timestamp, mf.scan_timestamp))
            if self.cfg.single_threaded:
                self._dispatch(item)
            else:
                self._queue.put(item)

    def _refine_keyframes(self) -> None:
        """Pose-graph refinement of the keyframe poses: the refined poses go
        into the mapper's state and the trajectory logger."""
        kfs = self.mapper.kf_manager.keyframes
        poses_np = self.mapper.state.poses.cpu().numpy()
        opt = np.stack([pose6_to_matrix(poses_np[k.pose_index]) for k in kfs])
        refined, self.ba_info = refine_keyframe_poses(kfs, opt, self.cfg.loop_closure, device=self.device)
        for k, T in zip(kfs, refined):
            self.mapper._set_pose(k.pose_index, T)
            self.logger.update_keyframe(k.timestamp, k.tracked_pose, T)

    def stop(self, out_dir: Optional[str] = None):
        """Drain the mapper's queue, stop the worker, refine the keyframe
        poses when loop closure is on (three keyframes or more), and write
        the output directory: checkpoints, trajectory/*.txt,
        track_times.csv, map_times.csv, timing.csv, and camera_attach.json
        and ba_info.json in their modes."""
        if self._worker is not None:
            self._stop.set()
            self._worker.join(timeout=600)
            if self._worker.is_alive():
                raise RuntimeError("the mapper thread did not finish its queue within 600 s")
        if self._worker_error is not None:
            raise self._worker_error

        self.ba_info = None
        if self.cfg.loop_closure.enabled and len(self.mapper.kf_manager) >= 3:
            self._refine_keyframes()

        out_dir = out_dir or self.out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            if len(self.mapper.kf_manager):
                self.mapper.save_final(os.path.join(out_dir, "checkpoints"))
            self.logger.finish(os.path.join(out_dir, "trajectory"))
            np.savetxt(os.path.join(out_dir, "track_times.csv"), np.asarray(self.tracker.track_times), delimiter=",")
            np.savetxt(os.path.join(out_dir, "map_times.csv"), np.asarray(self.mapper.map_times), delimiter=",")
            self.mapper.window_timer.write_csv(os.path.join(out_dir, "timing.csv"))
            if self.cfg.mapper.camera.enabled:
                with open(os.path.join(out_dir, "camera_attach.json"), "w") as f:
                    json.dump({"attached": self.mapper.image_attaches, "dropped": self.mapper.image_attach_drops}, f)
                if self.mapper.image_attach_drops:
                    print(f"[slam] WARNING: {self.mapper.image_attach_drops} matched images hit scans that never "
                          f"became keyframes ({self.mapper.image_attaches} attached)")
            if self.ba_info is not None:
                with open(os.path.join(out_dir, "ba_info.json"), "w") as f:
                    json.dump(self.ba_info, f, indent=1)
