"""The online mapper fed a keyframe stream: ``OnlineMapper.process_frame``.

Set-up simulates one lap of scans, builds the mapper with the
configuration's field and training settings, puts in the sigma weights the
seed makes and hands it the seed's step draws through its ``step_draws``
hook. It then feeds the first keyframe (its burn-in), the next ones with no
steps until one short of the window's size, and the one that fills the
window with its joint steps: those are the window's first steps over as
many distinct keyframes as it holds, with every pose but the anchor's
updated, and warm every shape the window uses. The check follows the
burn-in's first steps and the filling keyframe's first joint steps. The measured
window feeds keyframe after keyframe, each the moment the previous call
returned (a closed loop; every call ends in a synchronize), reusing the
lap's scans around it, until the window's seconds have passed. The rate is
all steps over all the window's time.

With ``trace``, the window runs the same, and afterwards the profiler
traces ``trace_keyframes`` more keyframes on the device alone, then one
more with the host's activity to name the idle gaps. Then the mapper is freed, and the
reference follows the run's first steps from the same inputs; the check
compares their readings with those the program gave in set-up.
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import check, fields, sensor
from benchmark.draws import WEIGHTS, step_draws, sub_seed
from benchmark.harness import Cell, LayerContext, Outcome
from benchmark.reference import field as ref_field
from benchmark.reference.train import OnlineInputs, Readings, follow_online, moved_rows, named_leaves
from benchmark.roofline import counts, kernels


def tiny(cell: Cell) -> None:
    """The cell cut, in place, to a size the CPU runs in seconds: the
    sensor, the lap and the training keys."""
    cell.mix["sensor"].update(channels=8, azimuth=64, scan_points=384, sky_points=64)
    cell.mix["lap"]["keyframes"] = 4
    tiny_train(cell.config["train"])


def tiny_train(train: dict) -> None:
    """The training keys that :func:`mapper_config` reads, cut for the CPU."""
    train.update(window_size=3, rays_per_kf=32, sky_rays_per_kf=8, n_samples_train=64, n_samples_test=64,
                 occ_voxels=16, occ_every=2, burn_in_iterations=4, iterations_per_keyframe=3)


def mapper_config(config: dict, mix: dict, scale: float):
    """The port's ``OnlineMapperConfig`` for the configuration and mix, its
    field built by the configuration's module in ``fields/``."""
    from loner_tpu_torch.mapping.keyframe_manager import KeyFrameManagerConfig
    from loner_tpu_torch.mapping.mapper import IterationPhase, OnlineMapperConfig, SchedulePhase
    from loner_tpu_torch.mapping.optimizer import MapperConfig
    from loner_tpu_torch.models.losses import LossConfig
    from loner_tpu_torch.models.occupancy_grid import OccGridConfig

    t, s = config["train"], mix["sensor"]
    nerf = fields.load(config).nerf_config(config["field"])
    loss = LossConfig(**{k: v for k, v in t["loss"].items() if k in LossConfig._fields})
    mcfg = MapperConfig(
        nerf=nerf, loss=loss,
        occ=OccGridConfig(voxel_size=t["occ_voxels"], lr=t["occ_lr"], n_iters_acc=t["occ_every"],
                          estimator=t["occ_estimator"]),
        ray_range=tuple(s["range_m"]), world_scale=scale, window_size=t["window_size"],
        max_keyframes=t["max_keyframes"], rays_per_kf=t["rays_per_kf"], sky_rays_per_kf=t["sky_rays_per_kf"],
        n_samples_train=t["n_samples_train"], n_samples_test=t["n_samples_test"], perturb=t["perturb"],
        samples_strategy=t["samples_strategy"], rays_strategy=t["rays_strategy"],
        mask_band_fraction=t["mask_band_fraction"], lr_sigma=t["lr_sigma"],
        lr_rgb=t["lr_rgb"], lr_pose=t["lr_pose"], rgb_weight_decay=t["rgb_weight_decay"],
        sigma_weight_decay=t["sigma_weight_decay"])
    # set-up: the burn-in, then keyframes with no steps until the window fills
    fill = [SchedulePhase(t["window_size"] - 2, [IterationPhase(0)])] if t["window_size"] > 2 else []
    schedule = [SchedulePhase(1, [IterationPhase(t["burn_in_iterations"], freeze_poses=True)]), *fill,
                SchedulePhase(-1, [IterationPhase(t["iterations_per_keyframe"], freeze_poses=False)])]
    kcfg = KeyFrameManagerConfig(selection_strategy="TEMPORAL", time_diff_seconds=mix.get("keyframe_interval_s", 3.0),
                                 window_selection="HYBRID", window_size=t["window_size"],
                                 num_recent_frames=t["num_recent_frames"])
    return mcfg, schedule, kcfg


class StepRecorder:
    """Wraps the mapper's train step: counts steps, keeps the host time of
    each call in the window, and takes the check's readings from the steps
    the reference follows (device scalars, read after the window)."""

    def __init__(self, step, burn_in: Optional[int], occ_every: int, initial_sigma: list):
        """``burn_in``: the index of the first joint step (None: none)."""
        self.step = step
        self.count = 0
        self.timing = False
        self.host_s: List[float] = []
        self.burn = -3 if burn_in is None else burn_in
        self.occ_step = occ_every - 1
        self.initial = initial_sigma
        self.compared = {0, 1, 2} | ({burn_in, burn_in + 1, burn_in + 2} if burn_in is not None else set())
        self.losses: Dict[int, torch.Tensor] = {}
        self.grads: Dict[str, torch.Tensor] = {}
        self.changes: Dict[str, torch.Tensor] = {}
        self.moments: Dict[str, torch.Tensor] = {}
        self.moved: Dict[str, torch.Tensor] = {}
        self._pose_start = None

    @staticmethod
    def _norm(t):
        return torch.linalg.vector_norm(t.detach().double())

    def __call__(self, state, window, flags, pose_mask, it, draws):
        i = self.count
        if i == self.burn:
            self._pose_start = state.poses
        t0 = time.perf_counter()
        new, aux = self.step(state, window, flags, pose_mask, it, draws)
        if self.timing:
            self.host_s.append(time.perf_counter() - t0)
        self.count += 1
        if i in self.compared:
            self.losses[i] = aux["loss"]
        if i == 0:
            mu = named_leaves(new.opt_sigma.mu)
            self.grads.update({f"sigma.{n}": self._norm(m / 0.1) for n, m in mu})
        if i == 2:
            now = named_leaves(new.params["sigma"])
            self.changes.update({f"sigma.{n}": self._norm(p - p0) for (n, p), p0 in zip(now, self.initial)})
            self.initial = None
        if i == self.occ_step:
            self.grads["occ_grid"] = self._norm(new.opt_occ.mu / 0.1)
            self.changes["occ_grid"] = self._norm(new.occ_grid - state.occ_grid)
        if i == self.burn:
            self.grads["poses"] = self._norm(new.opt_poses.mu / 0.1)
        if i == self.burn + 2:
            self.changes["poses"] = self._norm(new.poses - self._pose_start)
            self.moments["poses"] = self._norm(new.opt_poses.mu)
            self.moved["poses"] = new.poses - self._pose_start
            self._pose_start = None
        return new, aux

    def readings(self) -> Readings:
        def host(d):
            return {k: float(v) for k, v in d.items()}

        return Readings(host(self.losses), host(self.grads), host(self.changes), host(self.moments),
                        {k: moved_rows(v) for k, v in self.moved.items()})


def draws_hook(seed: int, train: dict, dev: torch.device):
    """The ``step_draws`` hook: the i-th call returns step i's draws from
    the seed (``benchmark/draws.py``) as the port's ``StepDraws``."""
    from loner_tpu_torch.mapping.optimizer import StepDraws

    count = [0]

    def draws(window):
        d = step_draws(seed, count[0], window.window_size, window.dirs.shape[1], window.sky_dirs.shape[1],
                       train["rays_per_kf"], train["sky_rays_per_kf"], train["n_samples_train"], dev)
        count[0] += 1
        return StepDraws(**d)

    return draws


def _scan(arrs: dict, t: float, sky_range: float):
    from loner_tpu_torch.data.scan import LidarScan

    p, s = len(arrs["dists"]), len(arrs["sky_valid"])
    scan = LidarScan(arrs["dirs"], arrs["dists"], np.full(p, t, np.float32), arrs["valid"])
    sky = LidarScan(arrs["sky_dirs"], np.full(s, sky_range, np.float32), np.full(s, t, np.float32),
                    arrs["sky_valid"])
    return scan, sky


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare(cell: Cell, seed: int, device: str):
    """(the lap's scans, what the reference is handed): the scans, the
    world cube and the configuration, all made from the mix and the seed;
    first refuses a field that the benchmark cannot build."""
    fields.load(cell.config)
    scans = sensor.make_scans(cell.mix, torch.device(device), seed)
    s = cell.mix["sensor"]
    scale, shift = sensor.world_cube(np.stack([a["pose"] for a in scans]), s["range_m"][1])
    w = cell.config["train"]["window_size"]
    inputs = OnlineInputs(seed=seed, field=cell.config["field"], train=cell.config["train"], keyframes=scans[:w],
                          scale=scale, shift=shift, ray_range=tuple(s["range_m"]), device=device)
    return scans, inputs


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float, work_dir: Path,
        fault: Optional[str] = None) -> Outcome:
    """``fault`` plants one of :data:`FAULTS` in the program, for the check's
    own test: ``"unchanged"`` (each step returns its state as it was),
    ``"half_batch"`` (the loss over the first half of the rays alone) or
    ``"latest_pose"`` (the latest keyframe's pose updated alone)."""
    from loner_tpu_torch.geometry.world_cube import WorldCube
    from loner_tpu_torch.mapping.mapper import OnlineMapper, OnlineMapperConfig

    config, mix = cell.config, cell.mix
    t, s = config["train"], mix["sensor"]
    dev = torch.device(device)
    scans, inputs = prepare(cell, seed, device)
    t_scans = time.time() - t_start
    scale, shift = inputs.scale, inputs.shift
    cube = WorldCube(scale, torch.as_tensor(shift))
    mcfg, schedule, kcfg = mapper_config(config, mix, scale)
    n_sky = s["sky_points"]
    ocfg = OnlineMapperConfig(mapper=mcfg, keyframe_manager=kcfg, schedule=schedule, n_sky_pad=n_sky,
                              seed=int(seed), log_level="DISABLED")
    mapper = OnlineMapper(ocfg, cube, device=dev, step_draws=draws_hook(seed, t, dev))
    sigma = ref_field.init_sigma(torch.Generator(device=dev).manual_seed(sub_seed(seed, WEIGHTS)), config["field"], dev)
    for (n, a), (_, b) in zip(named_leaves(sigma), named_leaves(mapper.state.params["sigma"])):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise RuntimeError(f"sigma leaf {n}: the benchmark makes {tuple(a.shape)}, the port holds {tuple(b.shape)}")
    mapper.state = mapper.state._replace(params={"sigma": sigma, "intensity": mapper.state.params["intensity"]})
    recorder = StepRecorder(_plant_step(fault, mapper._train_step), t["burn_in_iterations"], t["occ_every"],
                            [x.clone() for _, x in named_leaves(sigma)])
    mapper._train_step = recorder
    restore = _plant_loss(fault)
    t_mapper = time.time() - t_start

    sky_range = s["range_m"][1] + 1.0
    lap = len(scans)
    interval = mix["keyframe_interval_s"]
    k = 0

    def feed():
        nonlocal k
        arrs = scans[k % lap]
        scan, sky = _scan(arrs, k * interval, sky_range)
        mapper.process_frame(scan, k * interval, arrs["pose"], gt_pose=arrs["pose"], sky=sky)
        k += 1

    while k < t["window_size"]:
        feed()
    _sync(dev)
    setup_keyframes = len(mapper.map_times)
    skipped0 = int(mapper.state.skipped_steps)
    setup_s = time.time() - t_start
    print(f"[bench] set-up: scans at {t_scans:.2f} s, mapper and weights at {t_mapper:.2f} s, "
          f"{recorder.count} steps over {k} keyframes done at {setup_s:.2f} s", file=sys.stderr)

    peak_setup = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    steps0 = recorder.count
    recorder.timing = True
    w0 = time.perf_counter()
    while True:
        feed()
        elapsed = time.perf_counter() - w0
        if elapsed >= seconds:
            break
    recorder.timing = False
    window_steps = recorder.count - steps0
    peak_window = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = int(mapper.state.skipped_steps) - skipped0
    kf_s = mapper.map_times[setup_keyframes:]
    if kf_s:
        print(f"[bench] keyframe seconds in the window: first {[round(x, 3) for x in kf_s[:4]]}, median "
              f"{float(np.median(kf_s)):.3f}, last {[round(x, 3) for x in kf_s[-4:]]}", file=sys.stderr)

    n_points = t["window_size"] * (t["rays_per_kf"] + t["sky_rays_per_kf"]) * t["n_samples_train"]
    layer = LayerContext(config=config, mix=mix, window_steps=window_steps, window_s=elapsed,
                         host_step_s=list(recorder.host_s), peak_window_bytes=peak_window,
                         flops_per_step=counts.train_step_flops(n_points, config["field"]))
    if trace:
        from benchmark.trace import traced

        counters = kernels.counters()
        before = {name: fn.launches for name, fn in counters.items()}
        c0 = recorder.count
        _sync(dev)
        with traced(work_dir, dev.type == "cuda", host=False) as holder:
            for _ in range(mix["trace_keyframes"]):
                feed()
            _sync(dev)
        layer.trace = holder[0]
        layer.traced_steps = recorder.count - c0
        layer.launches = {name: [(n_points, fn.launches - before[name])] for name, fn in counters.items()}
        with traced(work_dir, dev.type == "cuda", host=True) as holder:
            feed()
            _sync(dev)
        layer.trace.idle_by_host = holder[0].idle_by_host
    restore()

    prog = recorder.readings()
    del mapper, recorder
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.compare(prog, follow_online(inputs))
    return Outcome(end_to_end={"map_steps_per_s": window_steps / elapsed, "setup_s": setup_s},
                   attempted=window_steps, failed=failed, numbers=numbers,
                   memory_peak_bytes=max(peak_setup, peak_window), layer=layer)


def _plant_step(fault: Optional[str], step):
    """``step``; with ``fault="unchanged"`` a step that returns the state it
    was given; with ``fault="latest_pose"`` one that updates the latest
    keyframe's pose alone where the window's poses are due."""
    if fault == "latest_pose":
        def latest(state, window, flags, pose_mask, it, draws):
            rows = torch.nonzero(pose_mask).flatten()
            if len(rows):
                pose_mask = torch.zeros_like(pose_mask)
                pose_mask[rows.max()] = 1.0
            return step(state, window, flags, pose_mask, it, draws)

        return latest
    if fault != "unchanged":
        return step

    def unchanged(state, window, flags, pose_mask, it, draws):
        _, aux = step(state, window, flags, pose_mask, it, draws)
        return state, aux

    return unchanged


def _plant_loss(fault: Optional[str]):
    """With ``fault="half_batch"`` the train step's loss takes the first half
    of the rays alone, the mean over them; returns the undo."""
    if fault not in (None, *FAULTS):
        raise ValueError(f"unknown fault {fault!r}")
    if fault != "half_batch":
        return lambda: None
    from loner_tpu_torch.mapping import optimizer

    loss_fn = optimizer.compute_lidar_loss

    def half(render, bundle, *a, **kw):
        keep = torch.arange(bundle.valid.shape[0], device=bundle.valid.device) < bundle.valid.shape[0] // 2
        return loss_fn(render, bundle._replace(valid=bundle.valid & keep), *a, **kw)

    optimizer.compute_lidar_loss = half
    return lambda: setattr(optimizer, "compute_lidar_loss", loss_fn)


FAULTS = ("unchanged", "half_batch", "latest_pose")


def readings(cell: Cell, seed: int, mode: str, device: str, work_dir: Path) -> Dict[str, float]:
    """One seed's compared numbers for the check's limits: the program
    (``"program"``), the reference one precision down in its place
    (``"control"``), or the program with one of :data:`FAULTS` planted."""
    if mode == "control":
        _, inputs = prepare(cell, seed, device)
        return check.compare(follow_online(inputs, lower=True), follow_online(inputs))
    fault = None if mode == "program" else mode
    return run(cell, seed=seed, seconds=0.0, trace=False, device=device, t_start=time.time(), work_dir=work_dir,
               fault=fault).numbers
