"""Offline implicit-map optimization from known (ground-truth) trajectories.

The port of ``loner_tpu/mapping/offline.py``, the Forest-Digital-Twin (FDT)
workload: train the sigma field on every scan of a sequence with the poses
fixed to ground truth, in epochs of shuffled windows, with the occupancy
grid updated every ``n_iters_acc`` steps, an L1-depth evaluation on held-out
scans after each epoch, and an early stop.

The held-out split and the epoch permutations come from numpy's
``default_rng(eval_seed)`` exactly as in the JAX package, so both packages
train on the same windows in the same order. The step draws come from a
``torch.Generator`` seeded with ``seed``, or from ``step_draws`` (a callable
of the window returning each step's :class:`StepDraws`) so that a caller can
replay another source's draws.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.geometry import se3
from loner_tpu_torch.geometry.rays import build_lidar_rays
from loner_tpu_torch.mapping.keyframe import KeyFrame, KeyFrameWindow, stack_window
from loner_tpu_torch.mapping.optimizer import (
    MapperConfig,
    MapperState,
    StepDraws,
    TrainStepFlags,
    init_mapper_state,
    make_render_fn,
    make_train_step,
)
from loner_tpu_torch.runtime.profiling import span


@dataclass
class OfflineConfig:
    """The offline loop's settings; the defaults are the reference FDT
    driver's."""

    window_size: int = 16
    iterations_per_window: int = 32
    max_epochs: int = 8
    l1_stop_threshold: float = 1.05  # meters: early stop on the held-out scans
    n_eval_scans: int = 6
    eval_seed: int = 8
    eval_rays_per_scan: int = 1024
    log_dir: Optional[str] = None
    # the occupancy update's transpose offline: "exact" (the offline
    # protocol has no real-time budget; the online path keeps "stochastic")
    occ_estimator: str = "exact"


@dataclass
class OfflineResult:
    state: MapperState
    l1_history: List[float] = field(default_factory=list)
    epochs_run: int = 0
    wall_time_s: float = 0.0
    iterations: int = 0
    eval_time_s: float = 0.0  # of wall_time_s, in evaluate_l1_depth
    losses: List[float] = field(default_factory=list)  # every step's loss


def _pose(kf: KeyFrame) -> np.ndarray:
    return kf.gt_pose if kf.gt_pose is not None else kf.tracked_pose


def evaluate_l1_depth(cfg: MapperConfig, cube, state: MapperState, keyframes: Sequence[KeyFrame],
                      n_rays: int = 1024, seed: int = 0, u_pdf: Optional[torch.Tensor] = None) -> float:
    """Mean |rendered - measured| depth (m) over up to ``n_rays`` rays of
    each keyframe whose range lies in [near, far - 0.25] (the reference's
    ``compute_l1_depth`` protocol), on the state's device. The rays are
    chosen by numpy's ``default_rng(seed)``; every keyframe's render uses the
    same inverse-CDF uniforms, ``u_pdf`` or one draw from a generator seeded
    with ``seed`` (the JAX package renders every keyframe with one key)."""
    dev = state.poses.device
    render_fn = make_render_fn(cfg, test=True, device=dev)
    if u_pdf is None and cfg.samples_strategy == "OGM":
        gen = torch.Generator(device=dev).manual_seed(seed)
        u_pdf = torch.rand((n_rays, cfg.n_samples_test // 2), generator=gen, device=dev)
    cube = cube.to(dev)
    rng = np.random.default_rng(seed)
    scale = cfg.world_scale
    errs = []
    for kf in keyframes:
        valid = np.asarray(kf.scan.valid)
        dist = np.asarray(kf.scan.distances)
        keep = valid & (dist > cfg.ray_range[0]) & (dist < cfg.ray_range[1] - 0.25)
        idx = np.flatnonzero(keep)
        if len(idx) == 0:
            continue
        idx = rng.choice(idx, size=min(n_rays, len(idx)), replace=False)
        # pad to the fixed eval batch
        pad = n_rays - len(idx)
        idx = np.concatenate([idx, np.zeros(pad, np.int64)]) if pad else idx
        mask = np.concatenate([np.ones(len(idx) - pad, bool), np.zeros(pad, bool)])

        bundle = build_lidar_rays(
            torch.as_tensor(np.asarray(kf.scan.ray_directions)[idx]).to(dev),
            torch.as_tensor(dist[idx]).to(dev),
            torch.as_tensor(np.asarray(_pose(kf), np.float32)).to(dev),
            cube, cfg.ray_range, point_valid=torch.as_tensor(mask).to(dev),
        )
        render = render_fn(state.params, state.occ_grid, bundle, u_pdf=u_pdf)
        m = bundle.valid.cpu().numpy()
        if m.sum():
            pred = render.depth.cpu().numpy() * scale
            gt = bundle.depth.cpu().numpy() * scale
            errs.append(np.abs(pred[m] - gt[m]))
    return float(np.concatenate(errs).mean()) if errs else float("nan")


def optimize_implicit_map(
    cfg: MapperConfig,
    cube,
    keyframes: List[KeyFrame],
    offline: OfflineConfig = OfflineConfig(),
    state: Optional[MapperState] = None,
    seed: int = 8,
    log_fn: Callable[[str], None] = print,
    device="cuda",
    step_draws: Optional[Callable[[KeyFrameWindow], StepDraws]] = None,
    eval_u_pdf: Optional[torch.Tensor] = None,
) -> OfflineResult:
    """Epochs over shuffled windows of the keyframes with their ground-truth
    poses frozen, on ``device`` (the state's, when a state is given).
    ``eval_u_pdf`` replaces the held-out renders' inverse-CDF draw."""
    if not keyframes:
        raise ValueError("no keyframes")
    t_start = time.time()
    dev = state.poses.device if state is not None else resolve_device(device)
    cfg = cfg._replace(
        window_size=min(offline.window_size, max(1, len(keyframes))),
        occ=cfg.occ._replace(estimator=offline.occ_estimator),
    )
    if state is None:
        state = init_mapper_state(torch.Generator(device=dev).manual_seed(seed), cfg, dev)
    # the poses: ground truth, never optimized here
    pose6 = se3.matrix_to_pose(torch.as_tensor(np.stack([_pose(kf) for kf in keyframes]), dtype=torch.float32))
    poses = state.poses.clone()
    poses[: len(keyframes)] = pose6.to(dev)
    state = state._replace(poses=poses)

    train_step = make_train_step(cfg, cube, dev, torch.Generator(device=dev).manual_seed(seed))
    flags = TrainStepFlags(freeze_sigma=False, freeze_rgb=True, freeze_poses=True, do_occ_update=False)
    pose_mask = torch.zeros((cfg.max_keyframes,), device=dev)

    # the held-out split (the reference holds out n_eval scans, seed 8)
    rng = np.random.default_rng(offline.eval_seed)
    order = rng.permutation(len(keyframes))
    n_eval = min(offline.n_eval_scans, max(0, len(keyframes) - cfg.window_size))
    eval_kfs = [keyframes[i] for i in order[:n_eval]]
    train_kfs = [keyframes[i] for i in order[n_eval:]] or keyframes
    n_sky_pad = next((kf.sky.ray_directions.shape[0] for kf in train_kfs if kf.sky is not None), 64)

    result = OfflineResult(state=state)
    it_total = 0
    best_l1 = float("inf")
    n_acc = cfg.occ.n_iters_acc
    for epoch in range(offline.max_epochs):
        with span("loner.offline.epoch"):
            perm = rng.permutation(len(train_kfs))
            losses = []
            for w_start in range(0, len(perm), cfg.window_size):
                sel = perm[w_start: w_start + cfg.window_size]
                if len(sel) < cfg.window_size:  # wrap round: every window has W keyframes
                    sel = np.concatenate([sel, perm[: cfg.window_size - len(sel)]])
                with span("loner.offline.stack_window"):
                    window = stack_window([train_kfs[i] for i in sel], n_sky_pad=n_sky_pad, device=dev)
                for it in range(offline.iterations_per_window):
                    occ = (it_total % n_acc) == n_acc - 1
                    with span("loner.offline.draws"):
                        draws = step_draws(window) if step_draws is not None else None
                    result.state, aux = train_step(result.state, window, flags._replace(do_occ_update=occ),
                                                   pose_mask, it, draws)
                    losses.append(aux["loss"])
                    it_total += 1
            with span("loner.offline.sync"):
                result.losses += [float(x) for x in torch.stack(losses).cpu()]

            eval_set = eval_kfs if eval_kfs else train_kfs[: min(4, len(train_kfs))]
            with span("loner.offline.eval") as evaluation:
                l1 = evaluate_l1_depth(cfg, cube, result.state, eval_set, offline.eval_rays_per_scan,
                                       offline.eval_seed, u_pdf=eval_u_pdf)
        result.eval_time_s += (evaluation.t1_ns - evaluation.t0_ns) * 1e-9
        result.l1_history.append(l1)
        result.epochs_run = epoch + 1
        log_fn(f"[offline] epoch {epoch + 1}/{offline.max_epochs}: L1 depth {l1:.3f} m, {it_total} iterations, "
               f"loss {result.losses[-1]:.4f}, {time.time() - t_start:.0f}s elapsed")
        if offline.log_dir:
            os.makedirs(offline.log_dir, exist_ok=True)
            with open(os.path.join(offline.log_dir, "l1_history.json"), "w") as f:
                json.dump(result.l1_history, f)
        # early stop: the threshold reached, or worse than the best by half
        if l1 < offline.l1_stop_threshold:
            log_fn(f"[offline] early stop: L1 {l1:.3f} < {offline.l1_stop_threshold}")
            break
        if l1 > best_l1 * 1.5 and epoch > 0:
            log_fn(f"[offline] early stop: L1 worsening ({l1:.3f} > {best_l1:.3f})")
            break
        best_l1 = min(best_l1, l1)

    result.wall_time_s = time.time() - t_start
    result.iterations = it_total
    return result
