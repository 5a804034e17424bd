"""The FDT RGB phase: ``mapping/camera_optimizer.py::optimize_intensity``.

After the lidar epochs, the intensity branch trains from masked camera
images, the sigma branch detached and the poses fixed at ground truth.
Set-up ray-casts the offline mix's sequence and the camera images (one a
pose, coloured from a palette the seed draws, with a seeded mask box), puts
in the sigma and intensity weights the seed makes, runs the configuration's
lidar epochs of the offline loop (``optimize_implicit_map``, as
``offline_map.py`` runs it) so that the occupancy grid and sigma hold the
scene, stacks the images as one camera window and runs the first call of
the RGB loop (every shape the window uses). The window calls the loop
again with its state, ``rgb_iterations`` steps a call, until its seconds
have passed; each call ends in its one L1 read-back. The rate is all camera
steps over all the window's time.

The loop builds its camera step inside itself; the benchmark wraps the step
it builds (replacing the module's ``make_camera_train_step`` for the length
of the run) to count steps, time them, hand each its draws from the seed
(``reference/camera.py::camera_draws``) and take the check's readings from
the window's first three steps, with a copy of the intensity state each of
them starts from. The reference recomputes each of those steps from the
program's state before it (``follow_camera``'s ``states``), so that each
step is held alone and rounding does not compound from one to the next. ``frozen_moved`` counts the sigma, keyframe-pose and
camera-pose values the run's camera steps changed (exact: 0). A traced
stretch whose device trace holds fewer launches of a kernel than its
counter counted (the profiler dropped records) is traced again.
"""
from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import check, sensor
from benchmark.draws import RENDER, WEIGHTS, sub_seed
from benchmark.drivers import offline_map
from benchmark.drivers.online_mapper import _sync, draws_hook, mapper_config
from benchmark.harness import Cell, LayerContext, Outcome
from benchmark.reference import camera as ref_camera
from benchmark.reference import field as ref_field
from benchmark.reference.train import Readings, named_leaves
from benchmark.roofline import kernels
from benchmark.roofline.camera import camera_step_flops

FAULTS = ("unchanged", "half_batch", "sigma_trained")
# a device trace that lost kernel records is taken again, up to this many times
# in all (the profiler drops a few hundred of a 20-step stretch's 56,762 device
# records in about one stretch in seven on an H100)
TRACE_ATTEMPTS = 3


def tiny(cell: Cell) -> None:
    """The cell cut, in place, to a size the CPU runs in seconds: the offline
    mix's cut, images of 32 x 18, 64 rays a step, short calls."""
    offline_map.tiny(cell)
    cam = cell.mix["camera"]
    f = 32 / cam["width"]
    cam["K"] = [[v * f for v in row] for row in cam["K"][:2]] + [cam["K"][2]]
    cam.update(width=32, height=18, trace_steps=3)
    cell.config["rgb_phase"].update(rgb_rays=64, rgb_iterations=4)


def quat_xyzw_to_matrix(q) -> np.ndarray:
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def camera_poses(mix: dict) -> np.ndarray:
    """(B, 4, 4) world_T_camera: each pose of the trajectory @ lidar_to_camera."""
    lc = mix["camera"]["lidar_to_camera"]
    t_lc = np.eye(4)
    t_lc[:3, :3] = quat_xyzw_to_matrix(lc["orientation_xyzw"])
    t_lc[:3, 3] = lc["xyz"]
    return np.stack([p @ t_lc for p in sensor.trajectory(mix)])


def camera_images(mix: dict, seed: int, device) -> tuple:
    """(images (B, H, W, 3) float32, masks (B, H, W) bool, poses (B, 4, 4)):
    each camera's pixels ray-cast through their centres against the mix's
    scene (``sensor.ray_cast``, out to the sensor's range), coloured by the
    surface hit (a bark colour a tree, the ground's, the sky's for a miss)
    from a palette drawn from the seed, with Gaussian noise from the seed;
    each mask False inside one box drawn from the seed."""
    cam = mix["camera"]
    h, w = cam["height"], cam["width"]
    boxes = sensor.scene_boxes(mix)
    poses = camera_poses(mix)
    rng = np.random.default_rng(sub_seed(seed, ref_camera.IMAGES))
    sky = rng.uniform((0.55, 0.65, 0.80), (0.75, 0.85, 1.00))
    ground = rng.uniform((0.25, 0.30, 0.10), (0.45, 0.50, 0.25))
    bark = rng.uniform((0.25, 0.15, 0.08), (0.55, 0.40, 0.25), size=(len(boxes), 3))
    palette = torch.as_tensor(np.concatenate([bark, ground[None], sky[None]]), dtype=torch.float32, device=device)
    v, u = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    pix = np.stack([u, v, np.ones_like(u)], axis=-1).reshape(-1, 3)
    d_cam = torch.as_tensor(pix @ np.linalg.inv(np.asarray(cam["K"], np.float64)).T, device=device)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    centres = torch.as_tensor([c for c, _ in boxes], dtype=torch.float64, device=device)
    halves = torch.as_tensor([s for _, s in boxes], dtype=torch.float64, device=device) / 2
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, ref_camera.IMAGES, 1))
    images, masks = [], []
    for pose in poses:
        p = torch.as_tensor(pose, device=device)
        dirs = d_cam @ p[:3, :3].T
        dist = sensor.ray_cast(boxes, p[:3, 3], dirs, mix["sensor"]["range_m"][1])
        hit = torch.isfinite(dist)
        pts = p[:3, 3] + torch.where(hit, dist, torch.zeros_like(dist))[:, None] * dirs
        on_box = torch.all(torch.abs(pts[:, None, :] - centres[None]) <= halves[None] + 1e-6, dim=-1)
        surface = torch.where(on_box.any(dim=1), torch.argmax(on_box.to(torch.uint8), dim=1),
                              torch.full_like(dist, len(boxes), dtype=torch.long))
        surface = torch.where(hit, surface, torch.full_like(surface, len(boxes) + 1))
        img = palette[surface] + cam["noise"] * torch.randn((h * w, 3), generator=gen, device=device)
        images.append(torch.clamp(img, 0.0, 1.0).reshape(h, w, 3).cpu().numpy())
        share = rng.uniform(*cam["mask_share"])
        aspect = rng.uniform(0.5, 2.0)
        bh = int(np.clip(round(math.sqrt(share * h * w / aspect)), 1, h))
        bw = int(np.clip(round(share * h * w / bh), 1, w))
        y0, x0 = rng.integers(0, h - bh + 1), rng.integers(0, w - bw + 1)
        m = np.ones((h, w), bool)
        m[y0:y0 + bh, x0:x0 + bw] = False
        masks.append(m)
    return np.stack(images).astype(np.float32), np.stack(masks), poses


def _keyframes(scans: List[dict], mix: dict):
    from loner_tpu_torch.data.scan import LidarScan
    from loner_tpu_torch.mapping.keyframe import KeyFrame

    sky_range = mix["sensor"]["range_m"][1] + 1.0
    kfs = []
    for i, sc in enumerate(scans):
        p, q = len(sc["dists"]), len(sc["sky_valid"])
        kf = KeyFrame(scan=LidarScan(sc["dirs"], sc["dists"], np.full(p, float(i), np.float32), sc["valid"]),
                      timestamp=float(i), pose_index=i, tracked_pose=sc["pose"], gt_pose=sc["pose"],
                      sky=LidarScan(sc["sky_dirs"], np.full(q, sky_range, np.float32), np.full(q, float(i), np.float32),
                                    sc["sky_valid"]))
        kf.compute_band_indices(tuple(mix["band_z_m"]))
        kfs.append(kf)
    return kfs


class CameraRecorder:
    """Wraps each camera step the loop builds: counts steps, keeps the host
    time of each call in the window, hands each step its draws from the
    seed, and takes the check's readings from the steps ``first``,
    ``first + 1`` and ``first + 2`` (device scalars, read after the run)."""

    def __init__(self, seed: int, rgb: dict, n_samples: int, fault: Optional[str]):
        self.seed, self.rgb, self.n_samples, self.fault = seed, rgb, n_samples, fault
        self.count = 0
        self.first: Optional[int] = None
        self.timing = False
        self.host_s: List[float] = []
        self.losses: Dict[int, torch.Tensor] = {}
        self.grads: Dict[str, torch.Tensor] = {}
        self.changes: Dict[str, torch.Tensor] = {}
        self.states: List[tuple] = []  # what each checked step started from (``_snapshot``)
        self._start = None

    def draws(self, window, device):
        from loner_tpu_torch.mapping.camera_optimizer import CameraDraws

        b, h, w = window.intensities.shape[:3]
        return CameraDraws(**ref_camera.camera_draws(self.seed, self.count, self.rgb["rgb_rays"], b, h, w,
                                                     self.n_samples, device))

    def wrap(self, step, cfg, cube):
        step = _plant_step(self.fault, step, cfg, cube)

        def recorded(state, window, draws=None):
            i = self.count
            d = self.draws(window, state.poses.device)
            t0 = time.perf_counter()
            new, aux = step(state, window, d)
            if self.timing:
                self.host_s.append(time.perf_counter() - t0)
            self.count += 1
            if self.first is not None and self.first <= i < self.first + 3:
                self.states.append(_snapshot(state))
                self.losses[i] = aux["loss"]
                if i == self.first:
                    self._start = named_leaves(state.params["intensity"])
                    self.grads = {f"intensity.{n}": _norm(g) for n, g in named_leaves(aux["grads"]["intensity"])}
                if i == self.first + 2:
                    now = named_leaves(new.params["intensity"])
                    self.changes = {f"intensity.{n}": _norm(p - p0) for (n, p), (_, p0) in zip(now, self._start)}
                    self._start = None
            return new, aux

        return recorded

    def readings(self) -> Readings:
        def host(d):
            return {k: float(v) for k, v in d.items()}

        return Readings(host(self.losses), host(self.grads), host(self.changes))


def _snapshot(state) -> tuple:
    """Host copies of what a camera step starts from, in ``follow_camera``'s
    ``states`` form: the intensity leaves, their Adam moments and count
    (on the host, so that the window's device memory holds the program's
    alone)."""
    opt = state.opt_intensity

    def copies(tree):
        return [t.detach().to("cpu", copy=True) for _, t in named_leaves(tree)]

    return copies(state.params["intensity"]), copies(opt.mu), copies(opt.nu), opt.count.detach().to("cpu", copy=True)


def _norm(t: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(t.detach().double())


@contextlib.contextmanager
def _wrapped_camera_steps(recorder: CameraRecorder):
    """The loop's ``make_camera_train_step`` returns the recorder's wrap of
    the step it builds."""
    from loner_tpu_torch.mapping import camera_optimizer

    make = camera_optimizer.make_camera_train_step
    camera_optimizer.make_camera_train_step = lambda cfg, cube, *a, **kw: recorder.wrap(make(cfg, cube, *a, **kw),
                                                                                         cfg, cube)
    try:
        yield
    finally:
        camera_optimizer.make_camera_train_step = make


def _plant_step(fault: Optional[str], step, cfg, cube):
    """``step``; with ``fault="unchanged"`` one that returns the state it was
    given; with ``fault="sigma_trained"`` one that also trains the sigma
    group by the same render with sigma not detached."""
    if fault == "unchanged":
        def unchanged(state, window, draws):
            _, aux = step(state, window, draws)
            return state, aux

        return unchanged
    if fault != "sigma_trained":
        return step
    from loner_tpu_torch.mapping import camera_optimizer as cam
    from loner_tpu_torch.mapping.optimizer import _masked_group, _tree_unflatten, tree_leaves
    from loner_tpu_torch.models.rendering import render_rays

    def sigma_trained(state, window, draws):
        new, aux = step(state, window, draws)
        c = cube.to(state.poses.device)
        bundle, target, z_vals = cam.camera_rays_and_samples(cfg, c, window, state.occ_grid, draws)
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(state.params["sigma"])]
        params = {"sigma": _tree_unflatten(state.params["sigma"], leaves), "intensity": state.params["intensity"]}
        with torch.enable_grad():
            render = render_rays(params, bundle, z_vals, cfg.nerf, draws.enc_key, sigma_only=False, detach_sigma=False,
                                 key_intensity=draws.enc_key_intensity)
            loss, _ = cam.compute_camera_loss(render, target, bundle.valid, cfg.loss)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        with torch.no_grad():
            sigma, opt_sigma = _masked_group(_tree_unflatten(state.params["sigma"], grads), state.opt_sigma,
                                             state.params["sigma"], False, aux["finite"], cfg.lr_sigma, cfg.lr_gamma,
                                             cfg.sigma_weight_decay)
        return new._replace(params={"sigma": sigma, "intensity": new.params["intensity"]}, opt_sigma=opt_sigma), aux

    return sigma_trained


def _plant_loss(fault: Optional[str]):
    """With ``fault="half_batch"`` the camera loss takes the first half of the
    rays alone; returns the undo."""
    if fault not in (None, *FAULTS):
        raise ValueError(f"unknown fault {fault!r}")
    if fault != "half_batch":
        return lambda: None
    from loner_tpu_torch.mapping import camera_optimizer as cam

    loss_fn = cam.compute_camera_loss

    def half(render, target, valid, cfg):
        keep = torch.arange(valid.shape[0], device=valid.device) < valid.shape[0] // 2
        return loss_fn(render, target, valid & keep, cfg)

    cam.compute_camera_loss = half
    return lambda: setattr(cam, "compute_camera_loss", loss_fn)


def _frozen(state, window) -> List[torch.Tensor]:
    """Copies of what a camera step must not change: the sigma leaves, the
    keyframe poses and the camera poses."""
    return [t.detach().clone() for t in
            [x for _, x in named_leaves(state.params["sigma"])] + [state.poses, window.poses]]


def _moved(before: List[torch.Tensor], state, window) -> int:
    now = [x for _, x in named_leaves(state.params["sigma"])] + [state.poses, window.poses]
    return int(sum(int(torch.count_nonzero(a != b)) for a, b in zip(before, now)))


def lost_records(summary, counted: Dict[str, int]) -> Dict[str, tuple]:
    """The kernels whose launches the device trace holds fewer of than their
    counters counted, each with (counted, traced): records the profiler
    dropped. A trace that holds more launches than counted is a miscount,
    which ``counts.roofline_share`` refuses, and is not taken again."""
    out = {}
    for name, n in counted.items():
        seen = summary.time_of(kernels.load(name).TRACE_NAME)[1]
        if n > 0 and seen < n:
            out[name] = (n, seen)
    return out


def compare(prog: Readings, ref: Readings, frozen_moved: int) -> Dict[str, float]:
    """The check's numbers: ``cam_loss_gap`` (the camera loss's largest
    relative gap over the three steps), ``grad_gap`` and ``change_gap`` (per
    intensity leaf, as ``check.py`` reads them; the worst leaf) and
    ``frozen_moved``; each leaf's and step's gap under ``<number>.<part>``."""
    numbers = {("cam_" + k if k.split(".")[0] == "loss_gap" else k): v
               for k, v in check.compare(prog, ref).items()
               if k.split(".")[0] in ("loss_gap", "grad_gap", "change_gap")}
    numbers["frozen_moved"] = float(frozen_moved)
    return numbers


def setup(cell: Cell, seed: int, device: str, recorder: CameraRecorder):
    """Everything up to the window: (state, window, cube, the port's config,
    the reference's inputs, the frozen values' copies); leaves the recorder
    at the window's first step."""
    from loner_tpu_torch.geometry.world_cube import WorldCube
    from loner_tpu_torch.mapping.camera_optimizer import optimize_intensity, stack_camera_window
    from loner_tpu_torch.mapping.offline import OfflineConfig, optimize_implicit_map
    from loner_tpu_torch.mapping.optimizer import init_mapper_state

    config, mix = cell.config, cell.mix
    t, o, rgb = config["train"], mix["offline"], config["rgb_phase"]
    dev = torch.device(device)
    scans, inputs, _ = offline_map.prepare(cell, seed, device)
    cube = WorldCube(inputs.scale, torch.as_tensor(inputs.shift))
    mcfg, _, _ = mapper_config(config, mix, inputs.scale)
    mcfg = mcfg._replace(window_size=o["window_size"], rays_strategy=mix["rays_strategy"],
                         loss=mcfg.loss._replace(cam_lambda=rgb["cam_lambda"]))
    images, masks, cam_poses = camera_images(mix, seed, dev)

    state = init_mapper_state(torch.Generator(device=dev).manual_seed(0), mcfg, dev)
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, WEIGHTS))
    params = {"sigma": ref_field.init_sigma(gen, config["field"], dev),
              "intensity": ref_camera.init_intensity(gen, config["field"], dev)}
    for (n, a), (_, b) in zip(named_leaves(params), named_leaves(state.params)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise RuntimeError(f"leaf {n}: the benchmark makes {tuple(a.shape)}, the port holds {tuple(b.shape)}")
    state = state._replace(params=params)

    ocfg = OfflineConfig(window_size=o["window_size"], iterations_per_window=o["iterations_per_window"],
                         max_epochs=rgb["lidar_epochs"], l1_stop_threshold=-float("inf"),
                         n_eval_scans=o["n_eval_scans"], eval_seed=o["eval_seed"],
                         eval_rays_per_scan=o["eval_rays_per_scan"], occ_estimator=o["occ_estimator"])
    eval_u = torch.rand((o["eval_rays_per_scan"], t["n_samples_test"] // 2),
                        generator=torch.Generator(device=dev).manual_seed(sub_seed(seed, RENDER)), device=dev)
    state = optimize_implicit_map(mcfg, cube, _keyframes(scans, mix), ocfg, state=state, log_fn=lambda m: None,
                                  device=dev, step_draws=draws_hook(seed, t, dev), eval_u_pdf=eval_u).state
    window = stack_camera_window(images, masks, cam_poses, np.asarray(mix["camera"]["K"], np.float64),
                                 upsample=rgb["upsample"], device=dev)
    state = optimize_intensity(mcfg, cube, state, window, n_iterations=rgb["rgb_iterations"],
                               n_rays=rgb["rgb_rays"], log_every=rgb["rgb_iterations"], log_fn=lambda m: None,
                               device=dev)
    _sync(dev)
    recorder.first = recorder.count
    ref = ref_camera.CameraInputs(
        seed=seed, field=config["field"], train=t, rgb=rgb, images=window.intensities, masks=window.masks,
        cam_poses=cam_poses, K=np.asarray(mix["camera"]["K"], np.float64), scale=inputs.scale, shift=inputs.shift,
        ray_range=tuple(mix["sensor"]["range_m"]), first_step=recorder.first, sigma=state.params["sigma"],
        intensity=state.params["intensity"], mu=state.opt_intensity.mu, nu=state.opt_intensity.nu,
        count=int(state.opt_intensity.count), occ=state.occ_grid, device=device)
    return state, window, cube, mcfg, ref, _frozen(state, window)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float, work_dir: Path,
        fault: Optional[str] = None) -> Outcome:
    """``fault`` plants one of :data:`FAULTS` in the program: ``"unchanged"``
    (each step returns its state as it was), ``"half_batch"`` (the loss over
    the first half of the rays alone) or ``"sigma_trained"`` (the sigma group
    trained by the camera loss too)."""
    from loner_tpu_torch.mapping.camera_optimizer import optimize_intensity

    config, mix = cell.config, cell.mix
    t, rgb, cam = config["train"], config["rgb_phase"], mix["camera"]
    dev = torch.device(device)
    recorder = CameraRecorder(seed, rgb, t["n_samples_train"], fault)
    restore = _plant_loss(fault)
    with _wrapped_camera_steps(recorder):
        state, window, cube, mcfg, ref, frozen = setup(cell, seed, device, recorder)

        def call(st, steps):
            return optimize_intensity(mcfg, cube, st, window, n_iterations=steps, n_rays=rgb["rgb_rays"],
                                      log_every=steps, log_fn=lambda m: None, device=dev)

        setup_s = time.time() - t_start
        skipped0 = int(state.skipped_steps)
        peak_setup = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        steps0 = recorder.count
        recorder.timing = True
        w0 = time.perf_counter()
        while True:
            state = call(state, rgb["rgb_iterations"])
            _sync(dev)
            elapsed = time.perf_counter() - w0
            if elapsed >= seconds:
                break
        recorder.timing = False
        window_steps = recorder.count - steps0
        peak_window = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        failed = int(state.skipped_steps) - skipped0
        n_points = rgb["rgb_rays"] * t["n_samples_train"]
        layer = LayerContext(config=config, mix=mix, window_steps=window_steps, window_s=elapsed,
                             host_step_s=list(recorder.host_s), step_span="loner.camera.step",
                             peak_window_bytes=peak_window, flops_per_step=camera_step_flops(n_points, config["field"]))
        if trace:
            from benchmark.trace import traced

            chunks = config["field"]["point_chunks"]
            per_launch = n_points // chunks if n_points % chunks == 0 else n_points
            ctrs = kernels.counters()
            for attempt in range(TRACE_ATTEMPTS):
                before = {name: fn.launches for name, fn in ctrs.items()}
                c0 = recorder.count
                with traced(work_dir, dev.type == "cuda", host=False) as holder:
                    state = call(state, cam["trace_steps"])
                    _sync(dev)
                counted = {name: fn.launches - before[name] for name, fn in ctrs.items()}
                lost = lost_records(holder[0], counted)
                if not lost:
                    break
                print(f"[bench] the device trace lost records of {lost} (attempt {attempt + 1} of {TRACE_ATTEMPTS})",
                      file=sys.stderr, flush=True)
            layer.trace = holder[0]
            layer.traced_steps = recorder.count - c0
            layer.launches = {name: [(per_launch, n)] for name, n in counted.items()}
            with traced(work_dir, dev.type == "cuda", host=True) as holder:
                state = call(state, cam["trace_steps"])
                _sync(dev)
            layer.trace.idle_by_host = holder[0].idle_by_host
    restore()

    moved = _moved(frozen, state, window)
    prog, states = recorder.readings(), recorder.states
    del state, recorder, frozen
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = compare(prog, ref_camera.follow_camera(ref, states=states), moved)
    return Outcome(end_to_end={"map_steps_per_s": window_steps / elapsed, "setup_s": setup_s},
                   attempted=window_steps, failed=failed, numbers=numbers,
                   memory_peak_bytes=max(peak_setup, peak_window), layer=layer)


def readings(cell: Cell, seed: int, mode: str, device: str, work_dir: Path) -> Dict[str, float]:
    """One seed's compared numbers for the check's limits: the program, the
    reference one precision down in its place (from the state the program's
    set-up left), or the program with one of :data:`FAULTS` planted."""
    if mode == "control":
        from loner_tpu_torch.mapping.camera_optimizer import optimize_intensity

        rgb = cell.config["rgb_phase"]
        recorder = CameraRecorder(seed, rgb, cell.config["train"]["n_samples_train"], None)
        with _wrapped_camera_steps(recorder):
            state, window, cube, mcfg, ref, _ = setup(cell, seed, device, recorder)
            optimize_intensity(mcfg, cube, state, window, n_iterations=3, n_rays=rgb["rgb_rays"], log_every=3,
                               log_fn=lambda m: None, device=torch.device(device))
        states = recorder.states
        del state, recorder
        return compare(ref_camera.follow_camera(ref, lower=True, states=states),
                       ref_camera.follow_camera(ref, states=states), 0)
    return run(cell, seed=seed, seconds=0.0, trace=False, device=device, t_start=time.time(), work_dir=work_dir,
               fault=None if mode == "program" else mode).numbers
