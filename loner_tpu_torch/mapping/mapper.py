"""Online mapper: the keyframe gate and the schedule of train steps.

The port of ``loner_tpu/mapping/mapper.py``: per accepted keyframe, run the
keyframe schedule's phases (1000 steps on the first keyframe, then 50 joint
steps per keyframe by default), each with its freeze flags and pose mask,
over the window the KeyFrameManager picks; publish the optimized keyframe
poses, keep the window timing, write loss CSVs and checkpoints on their
cadence. Each iteration is one call of the port's train step on the
mapper's device; the host loop reads nothing back from the device until the
window ends.

Random draws come from the mapper's ``torch.Generator`` (seeded with
``seed + 1``, as the JAX mapper's key), or from ``step_draws`` when given:
a callable of the window returning each step's :class:`StepDraws`, so that a
caller can replay another source's draws. Under the FIXED ray strategy a
phase runs one epoch over the padded scan, ``max(1, P // rays_per_kf)``
steps, all slicing one permutation drawn at the phase's start; as the JAX
mapper holds its step key through the phase, the occupancy-corner
uniforms are drawn there once too, and the other draws afresh each step.

With ``camera.enabled``, images matched to keyframes (``attach_image``)
train the intensity branch after each lidar pass: ``iterations_per_window``
camera steps (``camera_optimizer.py``) over the window's keyframes that
carry an image, at their current optimized poses. Each camera step counts
in the state's ``global_step``, so ``_host_step`` (the lidar steps) falls
behind it from the first camera step on.

With the debug block's ray, sample or loss-distribution flag on, each
window ends with one probe pass (``make_debug_probe``: the train step's
rays, samples and render from fresh draws, without gradients) whose
diagnostics ``runtime/debug_dump.py`` writes under
``<dump_dir>/keyframe_<k>/``.

Not ported, and raising ``NotImplementedError``: a mapper mesh (queue A
item 3).
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from loner_tpu_torch.data.scan import LidarScan
from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.geometry import se3
from loner_tpu_torch.mapping.keyframe import KeyFrame, KeyFrameWindow, stack_window
from loner_tpu_torch.mapping.keyframe_manager import KeyFrameManager, KeyFrameManagerConfig, pose6_to_matrix
from loner_tpu_torch.mapping.optimizer import (
    MapperConfig,
    MapperState,
    StepDraws,
    TrainStepFlags,
    draw_occ_uniforms,
    draw_permutation,
    draw_step,
    init_mapper_state,
    make_train_step,
)
from loner_tpu_torch.runtime.checkpoints import save_checkpoint
from loner_tpu_torch.runtime.debug_dump import DebugFlags
from loner_tpu_torch.runtime.profiling import WindowTimer


@dataclass
class IterationPhase:
    """One entry of an iteration schedule (``keyframe_schedule`` in the cfg)."""

    num_iterations: int
    freeze_poses: bool = False
    freeze_sigma_mlp: bool = False
    freeze_rgb_mlp: bool = True
    latest_kf_only: bool = False


@dataclass
class SchedulePhase:
    num_keyframes: int  # -1 = all remaining
    iteration_schedule: List[IterationPhase]


def default_keyframe_schedule(skip_pose_refinement: bool = True) -> List[SchedulePhase]:
    """1000 pose-frozen steps on the first keyframe, then per keyframe an
    optional refinement of the latest pose (skipped by default) and 50 joint
    steps."""
    later = []
    if not skip_pose_refinement:
        later.append(IterationPhase(50, freeze_poses=False, freeze_sigma_mlp=True, latest_kf_only=True))
    later.append(IterationPhase(50, freeze_poses=False, freeze_sigma_mlp=False))
    return [SchedulePhase(1, [IterationPhase(1000, freeze_poses=True)]), SchedulePhase(-1, later)]


def phases_for_pass(schedule: List[SchedulePhase], opt_count: int) -> List[IterationPhase]:
    """The iteration schedule of the opt_count-th optimization pass
    (1-based), walking the schedule's num_keyframes buckets."""
    remaining = opt_count
    for phase in schedule:
        if phase.num_keyframes == -1 or remaining <= phase.num_keyframes:
            return phase.iteration_schedule
        remaining -= phase.num_keyframes
    return schedule[-1].iteration_schedule


@dataclass
class OnlineCameraConfig:
    """The online camera phase: after each lidar pass, the intensity branch
    trains from the window's matched images with sigma detached."""

    enabled: bool = False
    K: Optional[np.ndarray] = None  # (3, 3) intrinsics
    lidar_to_camera: Optional[np.ndarray] = None  # (4, 4): camera pose = keyframe pose @ this
    iterations_per_window: int = 20
    n_rays: int = 1024
    # dynamic-object masking: called with the attached (H, W, C) image, returns
    # an (H, W) bool mask, True = trainable (static); data/dynamic_mask.py has
    # sources. None: every pixel trains.
    mask_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None


@dataclass
class OnlineMapperConfig:
    mapper: MapperConfig = field(default_factory=MapperConfig)
    keyframe_manager: KeyFrameManagerConfig = field(default_factory=KeyFrameManagerConfig)
    schedule: List[SchedulePhase] = field(default_factory=default_keyframe_schedule)
    n_sky_pad: int = 64
    seed: int = 0
    # checkpoints: VERBOSE every keyframe, STANDARD every 10th, DISABLED none;
    # pose states every keyframe unless DISABLED; a final one at stop
    log_level: str = "STANDARD"
    checkpoint_dir: Optional[str] = None
    log_losses: bool = False  # per-keyframe, per-phase loss CSVs
    loss_log_dir: Optional[str] = None
    mesh_device_indices: Optional[List[int]] = None  # queue A item 3
    camera: OnlineCameraConfig = field(default_factory=OnlineCameraConfig)
    debug: DebugFlags = field(default_factory=DebugFlags)


def _check_ported(cfg: OnlineMapperConfig) -> None:
    if cfg.mesh_device_indices:
        raise NotImplementedError("mesh_device_indices: a mapper over several cards is not ported "
                                  "(ROADMAP.md, queue A item 3)")


class OnlineMapper:
    def __init__(self, cfg: OnlineMapperConfig, cube, device="cuda",
                 step_draws: Optional[Callable[[KeyFrameWindow], StepDraws]] = None):
        _check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cube = cube.to(self.device)
        self.state: MapperState = init_mapper_state(
            torch.Generator(device=self.device).manual_seed(cfg.seed), cfg.mapper, self.device)
        self.kf_manager = KeyFrameManager(cfg.keyframe_manager, seed=cfg.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self._train_step = make_train_step(cfg.mapper, self.cube, self.device, self.generator)
        self._step_draws = step_draws
        # host mirror of state.global_step (reading the device's would sync)
        self._host_step = 0
        # optimization passes so far: picks the schedule's bucket
        self._opt_count = 0
        self._camera_step = None  # built on the first window with an image
        self._debug_probe = None  # built on the first window with a mapper dump flag on
        # images matched to a keyframe, and matched to a scan that never became one
        self.image_attaches = 0
        self.image_attach_drops = 0
        self.map_times: List[float] = []
        self.window_timer = WindowTimer()
        # callbacks called with (timestamp, tracked_pose, optimized_pose)
        self.keyframe_update_callbacks: List[Callable] = []

    # ------------------------------------------------------------------
    def _pose_mask(self, window_kfs, latest_only: bool) -> torch.Tensor:
        mask = np.zeros((self.cfg.mapper.max_keyframes,), np.float32)
        if latest_only:
            mask[window_kfs[-1].pose_index] = 1.0
        else:
            for kf in window_kfs:
                if not kf.is_anchored:
                    mask[kf.pose_index] = 1.0
        return torch.from_numpy(mask).to(self.device)

    def _set_pose(self, index: int, pose: np.ndarray) -> None:
        poses = self.state.poses.clone()
        poses[index] = se3.matrix_to_pose(torch.as_tensor(np.asarray(pose, np.float32), device=self.device))
        self.state = self.state._replace(poses=poses)

    # ------------------------------------------------------------------
    def process_frame(self, scan: LidarScan, timestamp: float, tracked_pose: np.ndarray,
                      gt_pose: Optional[np.ndarray] = None, sky: Optional[LidarScan] = None,
                      use_gt_pose: bool = False) -> bool:
        """The keyframe gate and the optimization. True if the map was
        optimized (a new keyframe, or HYBRID's stationary re-optimization)."""
        decision = self.kf_manager.decide(timestamp, tracked_pose)
        if decision == "SKIP":
            return False
        t0 = time.time()

        if decision == "NEW":
            pose_init = (gt_pose if (use_gt_pose and gt_pose is not None)
                         else self.kf_manager.rebase_pose(tracked_pose, self.state.poses.cpu().numpy()))
            kf = KeyFrame(scan=scan, timestamp=timestamp, pose_index=len(self.kf_manager),
                          tracked_pose=np.asarray(tracked_pose), gt_pose=gt_pose, sky=sky)
            assert kf.pose_index < self.cfg.mapper.max_keyframes, "max_keyframes exceeded"
            self.kf_manager.accept(kf)
            self._set_pose(kf.pose_index, pose_init)

        window_kfs = self.kf_manager.get_active_window()
        window = stack_window(window_kfs, n_sky_pad=self.cfg.n_sky_pad, device=self.device)

        self._opt_count += 1
        n_iters = 0
        n_acc = self.cfg.mapper.occ.n_iters_acc
        fixed = self.cfg.mapper.rays_strategy == "FIXED"
        self.window_timer.start()
        loss_rows: List[tuple] = []  # (phase index, iteration, aux) device scalars
        for phase_idx, phase in enumerate(phases_for_pass(self.cfg.schedule, self._opt_count)):
            flags = TrainStepFlags(freeze_sigma=phase.freeze_sigma_mlp, freeze_rgb=phase.freeze_rgb_mlp,
                                   freeze_poses=phase.freeze_poses, do_occ_update=False)
            pose_mask = self._pose_mask(window_kfs, phase.latest_kf_only)
            n_phase_iters, held = phase.num_iterations, {}
            if fixed:
                # one epoch over the padded scan, slicing one permutation
                n_phase_iters = max(1, window.dirs.shape[1] // self.cfg.mapper.rays_per_kf)
                if self._step_draws is None:
                    held = dict(perm=draw_permutation(window, self.generator, self.device),
                                u_occ=draw_occ_uniforms(self.cfg.mapper, self.generator, self.device))
            for it in range(n_phase_iters):
                occ = (self._host_step % n_acc) == n_acc - 1
                self._host_step += 1
                draws = (self._step_draws(window) if self._step_draws is not None
                         else draw_step(self.cfg.mapper, window, self.generator, self.device, **held))
                self.state, aux = self._train_step(self.state, window, flags._replace(do_occ_update=occ),
                                                   pose_mask, it, draws)
                if self.cfg.log_losses:
                    loss_rows.append((phase_idx, it, {c: aux[c] for c in self._LOSS_COLS if c in aux}))
                n_iters += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if loss_rows:
            self._write_loss_csvs(len(self.kf_manager), loss_rows)
        if self.cfg.debug.mapper_any:
            self._dump_debug_probe(window)
        self.window_timer.stop(n_iters)

        if self.cfg.camera.enabled:
            self._run_camera_phase(window_kfs)

        poses_np = self.state.poses.cpu().numpy()
        for cb in self.keyframe_update_callbacks:
            for k in window_kfs:
                cb(k.timestamp, k.tracked_pose, pose6_to_matrix(poses_np[k.pose_index]))

        self._maybe_checkpoint()
        self.map_times.append(time.time() - t0)
        return True

    def _dump_debug_probe(self, window: KeyFrameWindow):
        """One probe pass over the window from fresh draws (``step_draws``'
        when given, else the mapper's generator's), written by
        ``dump_window_probe`` under ``keyframe_<k>/``."""
        from loner_tpu_torch.mapping.optimizer import make_debug_probe
        from loner_tpu_torch.runtime.debug_dump import dump_window_probe

        if self._debug_probe is None:
            self._debug_probe = make_debug_probe(self.cfg.mapper, self.cube, self.device)
        draws = (self._step_draws(window) if self._step_draws is not None
                 else draw_step(self.cfg.mapper, window, self.generator, self.device))
        out = self._debug_probe(self.state, window, draws, 0)
        dump_window_probe(self.cfg.debug, f"keyframe_{len(self.kf_manager)}",
                          {k: v.cpu().numpy() for k, v in out.items()}, scale=self.cfg.mapper.world_scale,
                          shift=self.cube.shift.cpu().numpy())

    # ------------------------------------------------------------------
    # the online camera phase
    # ------------------------------------------------------------------
    def attach_image(self, scan, image, image_timestamp: float, scan_timestamp: Optional[float] = None,
                     mask: Optional[np.ndarray] = None) -> bool:
        """Attach a matched image to the keyframe of ``scan``, found by the
        scan's timestamp when given (robust to copies of the scan), else by
        identity. ``mask`` (or ``camera.mask_fn`` of the image) becomes the
        keyframe's pixel mask. False, counted in ``image_attach_drops``, if
        the scan never became a keyframe."""
        target = None
        for kf in reversed(self.kf_manager.keyframes):
            if (scan_timestamp is not None and abs(kf.timestamp - scan_timestamp) < 1e-6) or kf.scan is scan:
                target = kf
                break
        if target is None:
            self.image_attach_drops += 1
            return False
        target.image = np.asarray(image, np.float32)
        target.image_timestamp = image_timestamp
        if mask is None and self.cfg.camera.mask_fn is not None:
            mask = self.cfg.camera.mask_fn(target.image)
        if mask is not None:
            target.image_mask = np.asarray(mask, bool)
        self.image_attaches += 1
        return True

    def _run_camera_phase(self, window_kfs) -> int:
        """The intensity pass over the window's keyframes that carry an
        image, at their current optimized poses, sigma detached. The batch is
        static (``window_size`` images): missing slots are copies of the
        first image with an all-False mask. Returns the steps run."""
        from loner_tpu_torch.mapping.camera_optimizer import make_camera_train_step, stack_camera_window

        cam = self.cfg.camera
        kfs = [k for k in window_kfs if k.image is not None]
        if not kfs or cam.K is None:
            return 0
        b = self.cfg.keyframe_manager.window_size
        t_lc = np.eye(4) if cam.lidar_to_camera is None else np.asarray(cam.lidar_to_camera)
        poses_np = self.state.poses.cpu().numpy()
        imgs, masks, cam_poses = [], [], []
        for k in kfs[:b]:
            imgs.append(np.asarray(k.image, np.float32))
            masks.append(np.asarray(k.image_mask, bool) if k.image_mask is not None
                         else np.ones(k.image.shape[:2], bool))
            cam_poses.append(pose6_to_matrix(poses_np[k.pose_index]) @ t_lc)
        while len(imgs) < b:
            imgs.append(imgs[0])
            masks.append(np.zeros(imgs[0].shape[:2], bool))
            cam_poses.append(cam_poses[0])
        window = stack_camera_window(np.stack(imgs), np.stack(masks), np.stack(cam_poses), np.asarray(cam.K),
                                     device=self.device)
        if self._camera_step is None:
            self._camera_step = make_camera_train_step(self.cfg.mapper, self.cube, n_rays=cam.n_rays,
                                                       device=self.device, generator=self.generator)
        for _ in range(cam.iterations_per_window):
            self.state, _ = self._camera_step(self.state, window)
        return cam.iterations_per_window

    # ------------------------------------------------------------------
    _LOSS_COLS = ("loss", "depth_mse", "los_loss", "opacity_loss", "depth_eps", "js_mean")

    def _write_loss_csvs(self, kf_index: int, rows):
        """Per-keyframe, per-phase loss CSVs, read from the device once per
        window."""
        d = os.path.join(self.cfg.loss_log_dir or "losses", f"keyframe_{kf_index}")
        os.makedirs(d, exist_ok=True)
        by_phase = defaultdict(list)
        for phase_idx, it, aux in rows:
            by_phase[phase_idx].append([it] + [float(aux.get(c, float("nan"))) for c in self._LOSS_COLS])
        for phase_idx, vals in by_phase.items():
            np.savetxt(os.path.join(d, f"phase_{phase_idx}.csv"), np.asarray(vals), delimiter=",",
                       header="iteration," + ",".join(self._LOSS_COLS), comments="")

    def _ckpt_interval(self) -> Optional[int]:
        return {"VERBOSE": 1, "STANDARD": 10}.get(self.cfg.log_level.upper())

    def _maybe_checkpoint(self):
        """Pose states every keyframe and a full checkpoint every
        ``log_level`` interval; nothing when DISABLED."""
        d = self.cfg.checkpoint_dir
        interval = self._ckpt_interval()
        if not d or interval is None:
            return
        self.write_pose_states(d)
        if self._opt_count % interval == 0:
            self.save_checkpoint(d)

    def write_pose_states(self, directory: str):
        """The keyframes' timestamps and tracked, optimized and ground-truth
        poses as ``kf_poses.npz``."""
        os.makedirs(directory, exist_ok=True)
        kfs = self.kf_manager.keyframes
        poses_np = self.state.poses.cpu().numpy()
        empty = np.zeros((0, 4, 4))
        np.savez(
            os.path.join(directory, "kf_poses.npz"),
            timestamps=np.asarray([k.timestamp for k in kfs]),
            tracked=np.stack([k.tracked_pose for k in kfs]) if kfs else empty,
            optimized=np.stack([pose6_to_matrix(poses_np[k.pose_index]) for k in kfs]) if kfs else empty,
            has_gt=np.asarray([k.gt_pose is not None for k in kfs]),
            gt=np.stack([k.gt_pose if k.gt_pose is not None else np.eye(4) for k in kfs]) if kfs else empty,
        )

    def save_checkpoint(self, directory: str) -> str:
        """The full mapper state under ``directory/ckpt_<step>``."""
        return save_checkpoint(directory, int(self._host_step), self.state)

    def save_final(self, directory: str) -> str:
        """Pose states and a full checkpoint, whatever the log level."""
        self.write_pose_states(directory)
        return self.save_checkpoint(directory)

    def optimized_pose(self, kf: KeyFrame) -> np.ndarray:
        return pose6_to_matrix(self.state.poses[kf.pose_index].cpu().numpy())
