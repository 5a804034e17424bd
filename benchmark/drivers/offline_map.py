"""Offline map optimization: ``mapping/offline.py::optimize_implicit_map``.

The Forest-Digital-Twin protocol over a recorded sequence: poses frozen at
ground truth, epochs of shuffled windows of keyframes, a fixed count of
iterations a window, the exact occupancy update, the held-out scans'
L1-depth render after each epoch. Set-up ray-casts the sequence, builds the
keyframes with their MASK trunk bands, puts in the sigma weights the seed
makes, and runs the first epoch (the steps the check follows, and every
shape the window uses). The window calls the loop again with its state, one
epoch a call, until its seconds have passed; the rate is all train steps
over all the window's time, the eval renders included. Step draws come from
the seed through the ``step_draws`` hook, and the eval renders' inverse-CDF
uniforms too.

The loop builds its train step inside itself; the benchmark wraps the step
it builds, to count steps and take the check's readings, by replacing the
loop module's ``make_train_step`` for the length of the run.
"""
from __future__ import annotations

import contextlib
import gc
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import check, fields, sensor
from benchmark.draws import RENDER, WEIGHTS, sub_seed
from benchmark.drivers.online_mapper import (StepRecorder, _plant_loss, _plant_step, _sync, draws_hook, mapper_config,
                                             tiny_train)
from benchmark.harness import Cell, LayerContext, Outcome
from benchmark.reference import field as ref_field
from benchmark.reference.train import OnlineInputs, band_indices, follow_offline, named_leaves
from benchmark.roofline import counts, kernels

FAULTS = ("unchanged", "half_batch")


def tiny(cell: Cell) -> None:
    """The cell cut, in place, to a size the CPU runs in seconds: the
    sensor, the circles, the forest, the offline loop and the training keys."""
    mix = cell.mix
    mix["sensor"].update(channels=8, azimuth=64, scan_points=384, sky_points=64)
    for c in mix["circles"]:
        c["poses"] = 3
    mix["offline"].update(window_size=2, iterations_per_window=3, n_eval_scans=2, eval_rays_per_scan=32)
    mix["forest"]["trees"] = 12
    tiny_train(cell.config["train"])


def prepare(cell: Cell, seed: int, device: str):
    """(the sequence's scans with their trunk bands, what the reference is
    handed, the first window's keyframes in the loop's order); first refuses
    a field that the benchmark cannot build."""
    fields.load(cell.config)
    mix, s = cell.mix, cell.mix["sensor"]
    scans = sensor.make_scans(mix, torch.device(device), seed)
    for sc in scans:
        sc["band"] = band_indices(sc, tuple(mix["band_z_m"]))
    scale, shift = sensor.world_cube(np.stack([a["pose"] for a in scans]), s["range_m"][1])
    train = dict(cell.config["train"], rays_strategy=mix["rays_strategy"], window_size=mix["offline"]["window_size"])
    inputs = OnlineInputs(seed=seed, field=cell.config["field"], train=train, keyframes=scans, scale=scale,
                          shift=shift, ray_range=tuple(s["range_m"]), device=device)
    # the loop's split and first epoch's order: numpy's default_rng(eval_seed)
    o = mix["offline"]
    rng = np.random.default_rng(o["eval_seed"])
    order = rng.permutation(len(scans))
    n_eval = min(o["n_eval_scans"], max(0, len(scans) - o["window_size"]))
    train_ids = order[n_eval:]
    perm = rng.permutation(len(train_ids))
    first = [int(train_ids[i]) for i in perm[:o["window_size"]]]
    return scans, inputs, first


@contextlib.contextmanager
def _wrapped_steps(wrap):
    """The offline loop's ``make_train_step`` returns ``wrap(step)``."""
    from loner_tpu_torch.mapping import offline

    make = offline.make_train_step
    offline.make_train_step = lambda *a, **kw: wrap(make(*a, **kw))
    try:
        yield
    finally:
        offline.make_train_step = make


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float, work_dir: Path,
        fault: Optional[str] = None) -> Outcome:
    """``fault`` plants one of :data:`FAULTS` in the program, as the online
    driver does."""
    from loner_tpu_torch.data.scan import LidarScan
    from loner_tpu_torch.geometry.world_cube import WorldCube
    from loner_tpu_torch.mapping.keyframe import KeyFrame
    from loner_tpu_torch.mapping.offline import OfflineConfig, optimize_implicit_map
    from loner_tpu_torch.mapping.optimizer import init_mapper_state

    config, mix = cell.config, cell.mix
    t, s, o = config["train"], mix["sensor"], mix["offline"]
    dev = torch.device(device)
    scans, inputs, _ = prepare(cell, seed, device)
    cube = WorldCube(inputs.scale, torch.as_tensor(inputs.shift))
    mcfg, _, _ = mapper_config(config, mix, inputs.scale)
    mcfg = mcfg._replace(window_size=o["window_size"], rays_strategy=mix["rays_strategy"])
    sky_range = s["range_m"][1] + 1.0
    kfs = []
    for i, sc in enumerate(scans):
        p, q = len(sc["dists"]), len(sc["sky_valid"])
        kf = KeyFrame(scan=LidarScan(sc["dirs"], sc["dists"], np.full(p, float(i), np.float32), sc["valid"]),
                      timestamp=float(i), pose_index=i, tracked_pose=sc["pose"], gt_pose=sc["pose"],
                      sky=LidarScan(sc["sky_dirs"], np.full(q, sky_range, np.float32), np.full(q, float(i), np.float32),
                                    sc["sky_valid"]))
        kf.compute_band_indices(tuple(mix["band_z_m"]))
        kfs.append(kf)
    ocfg = OfflineConfig(window_size=o["window_size"], iterations_per_window=o["iterations_per_window"],
                         max_epochs=1, l1_stop_threshold=-float("inf"), n_eval_scans=o["n_eval_scans"],
                         eval_seed=o["eval_seed"], eval_rays_per_scan=o["eval_rays_per_scan"],
                         occ_estimator=o["occ_estimator"])
    draws = draws_hook(seed, t, dev)
    eval_u = torch.rand((o["eval_rays_per_scan"], t["n_samples_test"] // 2),
                        generator=torch.Generator(device=dev).manual_seed(sub_seed(seed, RENDER)), device=dev)
    state = init_mapper_state(torch.Generator(device=dev).manual_seed(0), mcfg, dev)
    sigma = ref_field.init_sigma(torch.Generator(device=dev).manual_seed(sub_seed(seed, WEIGHTS)), config["field"], dev)
    state = state._replace(params={"sigma": sigma, "intensity": state.params["intensity"]})
    recorder = StepRecorder(None, None, t["occ_every"], [x.clone() for _, x in named_leaves(sigma)])

    def wrap(step):
        recorder.step = _plant_step(fault, step)
        return recorder

    def epoch(st):
        return optimize_implicit_map(mcfg, cube, kfs, ocfg, state=st, log_fn=lambda m: None, device=dev,
                                     step_draws=draws, eval_u_pdf=eval_u).state

    restore = _plant_loss(fault)
    with _wrapped_steps(wrap):
        state = epoch(state)
        _sync(dev)
        setup_s = time.time() - t_start
        skipped0 = int(state.skipped_steps)
        peak_setup = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        steps0 = recorder.count
        recorder.timing = True
        w0 = time.perf_counter()
        while True:
            state = epoch(state)
            _sync(dev)
            elapsed = time.perf_counter() - w0
            if elapsed >= seconds:
                break
        recorder.timing = False
        window_steps = recorder.count - steps0
        peak_window = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        failed = int(state.skipped_steps) - skipped0
        n_points = o["window_size"] * (t["rays_per_kf"] + t["sky_rays_per_kf"]) * t["n_samples_train"]
        layer = LayerContext(config=config, mix=mix, window_steps=window_steps, window_s=elapsed,
                             host_step_s=list(recorder.host_s), peak_window_bytes=peak_window,
                             flops_per_step=counts.train_step_flops(n_points, config["field"]))
        if trace:
            from benchmark.trace import traced

            ctrs = kernels.counters()
            before = {name: fn.launches for name, fn in ctrs.items()}
            c0 = recorder.count
            with traced(work_dir, dev.type == "cuda", host=False) as holder:
                state = epoch(state)
                _sync(dev)
            layer.trace = holder[0]
            layer.traced_steps = steps = recorder.count - c0
            # per step one launch of each train kernel over the window's
            # points; the rest are the eval renders' field chunks
            eval_points = o["eval_rays_per_scan"] * t["n_samples_test"] // mcfg.nerf.point_chunks
            layer.launches = {}
            for name, fn in ctrs.items():
                n = fn.launches - before[name]
                layer.launches[name] = [(n_points, min(n, steps)), (eval_points, max(0, n - steps))]
            with traced(work_dir, dev.type == "cuda", host=True) as holder:
                state = epoch(state)
                _sync(dev)
            layer.trace.idle_by_host = holder[0].idle_by_host
    restore()

    prog = recorder.readings()
    del state, recorder
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _, inputs, first = prepare(cell, seed, device)
    numbers = check.compare(prog, follow_offline(inputs, first))
    return Outcome(end_to_end={"map_steps_per_s": window_steps / elapsed, "setup_s": setup_s},
                   attempted=window_steps, failed=failed, numbers=numbers,
                   memory_peak_bytes=max(peak_setup, peak_window), layer=layer)


def readings(cell: Cell, seed: int, mode: str, device: str, work_dir: Path) -> Dict[str, float]:
    """One seed's compared numbers for the check's limits, as the online
    driver's."""
    if mode == "control":
        _, inputs, first = prepare(cell, seed, device)
        return check.compare(follow_offline(inputs, first, lower=True), follow_offline(inputs, first))
    return run(cell, seed=seed, seconds=0.0, trace=False, device=device, t_start=time.time(), work_dir=work_dir,
               fault=None if mode == "program" else mode).numbers
