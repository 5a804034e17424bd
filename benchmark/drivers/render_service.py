"""Virtual lidar sweeps from a map: ``analysis/renderer.py::render_lidar_scan``.

The synthetic-sensor service's traffic: one client asks for a sweep, gets
depth, variance and the keep mask back as host arrays, and asks for the
next. Set-up makes the map from the seed (the sigma weights and the
occupancy grid's logits) and renders one sweep to warm every shape. Each
request's pose lies on the lap at an angle drawn from the seed, and its
inverse-CDF uniforms (``u_pdf``, one row a ray) are drawn on the device
from the seed and the request's index. The rate is all rays returned over
all the window's time.

With ``trace``, the profiler then traces ``trace_requests`` more requests
on the device alone and one with the host's activity. After the window,
``check_chunks`` chunks of rays, drawn from the seed among those the window
returned, are rendered again by the reference from the same inputs.
"""
from __future__ import annotations

import gc
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import sensor
from benchmark.draws import RENDER, WEIGHTS, sub_seed
from benchmark.drivers.online_mapper import mapper_config, tiny_train
from benchmark.harness import Cell, LayerContext, Outcome
from benchmark.reference import field as ref_field
from benchmark.reference.geometry import lidar_rays
from benchmark.reference.render import ogm_z_vals, render
from benchmark.roofline import counts, kernels


def tiny(cell: Cell) -> None:
    """The cell cut, in place, to a size the CPU runs in seconds: the
    sweep, the lap, the chunks, the check and the trace, and the training
    keys."""
    cell.mix["sensor"].update(channels=8, azimuth=64)
    cell.mix["lap"]["keyframes"] = 4
    cell.mix.update(chunk_rays=128, check_chunks=2, trace_requests=1)
    tiny_train(cell.config["train"])


def _map(cell: Cell, seed: int, dev: torch.device):
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, WEIGHTS))
    sigma = ref_field.init_sigma(gen, cell.config["field"], dev)
    v = cell.config["train"]["occ_voxels"]
    occ = cell.mix["occ_logit_std"] * torch.randn((v, v, v), generator=gen, device=dev)
    return sigma, occ


def _request(seed: int, j: int, n_rays: int, n_half: int, lap: dict, dev: torch.device):
    """(pose (4, 4), u_pdf (n_rays, n_half)) of request ``j``."""
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, RENDER, j))
    theta = float(torch.rand((), generator=gen, device=dev)) * 2 * math.pi
    pose = sensor.lap_poses(1, lap["radius_m"], lap["height_m"])[0]
    c, s = math.cos(theta), math.sin(theta)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    pose[:3, :3] = rot @ pose[:3, :3]
    pose[:3, 3] = rot @ pose[:3, 3]
    return pose, torch.rand((n_rays, n_half), generator=gen, device=dev)


def _numbers(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray], mix: dict, far: float) -> Dict[str, float]:
    """Depth and variance gaps of the sampled rays, and the keep flips of
    the rays whose reference depth and variance lie clear of the keep
    thresholds by more than the limits' tolerance."""
    d_r, v_r = ref["depth"], ref["variance"]
    thr = ref["var_threshold"]
    d_gap = np.abs(prog["depth"] - d_r) / np.maximum(np.abs(d_r), 1e-3)
    v_gap = np.abs(prog["variance"] - v_r) / np.maximum(np.abs(v_r), 1e-3 * thr)
    clear = (np.abs(v_r - thr) > 1e-2 * thr) & (np.abs(d_r - 0.99 * far) > 1e-2 * far)
    flips = (prog["keep"] != ref["keep"]) & clear
    return {"depth_gap": float(d_gap.max()), "variance_gap": float(v_gap.max()), "keep_flips": float(flips.sum())}


def reference_render(cell: Cell, sigma: dict, occ: torch.Tensor, scale: float, shift: np.ndarray, pose: np.ndarray,
                     dirs: np.ndarray, u_pdf: torch.Tensor, lower: bool = False, rays_per_pass: int = 2048) -> dict:
    """The reference's depth, variance and keep for the rays ``dirs`` at
    ``pose``, in passes of ``rays_per_pass`` rays."""
    dev = occ.device
    t, s = cell.config["train"], cell.mix["sensor"]
    torch.backends.cuda.matmul.allow_tf32 = False
    shift_t = torch.as_tensor(shift, device=dev)
    pose_t = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
    depth, var = [], []
    with torch.no_grad():
        for a in range(0, len(dirs), rays_per_pass):
            d = torch.as_tensor(np.asarray(dirs[a:a + rays_per_pass], np.float32), device=dev)
            rays = lidar_rays(d, torch.zeros(d.shape[0], device=dev), pose_t, scale, shift_t, tuple(s["range_m"]))
            z = ogm_z_vals(rays, occ, t["n_samples_test"], 0.0, None, u_pdf[a:a + rays_per_pass])
            r = render(sigma, rays, z, cell.config["field"], lower)
            depth.append(r.depth * scale)
            var.append(r.variance * scale * scale)
    depth_m, var_m = torch.cat(depth).cpu().numpy(), torch.cat(var).cpu().numpy()
    # the service keeps a ray whose variance in cube units lies under the
    # threshold (render_lidar_scan scales both sides by scale^2)
    thr = cell.mix["var_threshold"] * scale * scale
    keep = (var_m < thr) & (depth_m < s["range_m"][1] * 0.99)
    return {"depth": depth_m, "variance": var_m, "keep": keep, "var_threshold": thr}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float, work_dir: Path,
        fault: Optional[str] = None, lower: bool = False) -> Outcome:
    """``fault="altered"`` shifts every 97th ray's depth by 1% and flips its
    keep where the service returns it (the check's own test); ``lower`` puts the reference
    one precision down in the program's place (the control)."""
    from loner_tpu_torch.analysis.renderer import render_lidar_scan
    from loner_tpu_torch.geometry.world_cube import WorldCube
    from loner_tpu_torch.mapping.optimizer import init_mapper_state

    mix, t, s = cell.mix, cell.config["train"], cell.mix["sensor"]
    dev = torch.device(device)
    scale, shift = sensor.world_cube(sensor.trajectory(mix), s["range_m"][1])
    cube = WorldCube(scale, torch.as_tensor(shift))
    mcfg, _, _ = mapper_config(cell.config, mix, scale)
    sigma, occ = _map(cell, seed, dev)
    state = init_mapper_state(torch.Generator(device=dev).manual_seed(0), mcfg, dev)
    state = state._replace(params={"sigma": sigma, "intensity": state.params["intensity"]}, occ_grid=occ)
    n_rays = s["channels"] * s["azimuth"]
    n_half = t["n_samples_test"] // 2
    dirs = sensor.lidar_directions(s["channels"], s["azimuth"], tuple(s["vfov_deg"]))

    def serve(j: int) -> dict:
        pose, u = _request(seed, j, n_rays, n_half, mix["lap"], dev)
        if lower:
            out = reference_render(cell, sigma, occ, scale, shift, pose, dirs, u, lower=True)
        else:
            out = render_lidar_scan(mcfg, cube, state, pose, n_channels=s["channels"], n_azimuth=s["azimuth"],
                                    vfov_deg=tuple(s["vfov_deg"]), var_threshold=mix["var_threshold"],
                                    chunk=mix["chunk_rays"], u_pdf=u)
        out = {k: out[k] for k in ("depth", "variance", "keep")}
        if fault == "altered":
            out["depth"], out["keep"] = out["depth"].copy(), out["keep"].copy()
            out["depth"][::97] *= 1.01
            out["keep"][::97] = ~out["keep"][::97]
        return out

    serve(0)  # warm-up: every shape of a request
    j = 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - t_start
    peak_setup = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    answers: Dict[int, dict] = {}
    w0 = time.perf_counter()
    while True:
        answers[j] = serve(j)
        j += 1
        elapsed = time.perf_counter() - w0
        if elapsed >= seconds:
            break
    peak_window = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n_req = len(answers)
    n_points = n_rays * t["n_samples_test"]
    layer = LayerContext(config=cell.config, mix=mix, window_steps=n_req, window_s=elapsed,
                         peak_window_bytes=peak_window, flops_per_step=counts.render_flops(n_points, cell.config["field"]))
    if trace:
        from benchmark.trace import traced

        counters = kernels.counters()
        before = {name: fn.launches for name, fn in counters.items()}
        with traced(work_dir, dev.type == "cuda", host=False) as holder:
            for _ in range(mix["trace_requests"]):
                serve(j)
                j += 1
        layer.trace = holder[0]
        layer.traced_steps = mix["trace_requests"]
        per_launch = mix["chunk_rays"] * t["n_samples_test"] // mcfg.nerf.point_chunks
        layer.launches = {name: [(per_launch, fn.launches - before[name])] for name, fn in counters.items()}
        with traced(work_dir, dev.type == "cuda", host=True) as holder:
            serve(j)
        layer.trace.idle_by_host = holder[0].idle_by_host

    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = _check(cell, seed, answers, sigma, occ, scale, shift, dirs, n_half, dev)
    return Outcome(end_to_end={"render_rays_per_s": n_req * n_rays / elapsed, "setup_s": setup_s},
                   attempted=n_req, failed=0, numbers=numbers, memory_peak_bytes=max(peak_setup, peak_window),
                   layer=layer)


def _check(cell: Cell, seed: int, answers: Dict[int, dict], sigma, occ, scale, shift, dirs, n_half, dev):
    """The reference on ``check_chunks`` chunks of rays drawn from the seed
    among the window's requests."""
    mix = cell.mix
    chunk = mix["chunk_rays"]
    n_rays = len(dirs)
    rng = np.random.default_rng(sub_seed(seed, RENDER, 1 << 30))
    reqs = sorted(answers)
    picks = [(int(rng.choice(reqs)), int(rng.integers(0, n_rays // chunk))) for _ in range(mix["check_chunks"])]
    prog: Dict[str, List[np.ndarray]] = {"depth": [], "variance": [], "keep": []}
    ref: Dict[str, List[np.ndarray]] = {"depth": [], "variance": [], "keep": []}
    thr = 0.0
    for j, c in picks:
        pose, u = _request(seed, j, n_rays, n_half, mix["lap"], dev)
        sl = slice(c * chunk, (c + 1) * chunk)
        r = reference_render(cell, sigma, occ, scale, shift, pose, dirs[sl], u[sl])
        for k in prog:
            prog[k].append(answers[j][k][sl])
            ref[k].append(r[k])
        thr = r["var_threshold"]
        del u
    ref_all = {k: np.concatenate(v) for k, v in ref.items()}
    ref_all["var_threshold"] = thr
    return _numbers({k: np.concatenate(v) for k, v in prog.items()}, ref_all, mix, cell.mix["sensor"]["range_m"][1])


FAULTS = ("altered",)


def readings(cell: Cell, seed: int, mode: str, device: str, work_dir: Path) -> Dict[str, float]:
    """One seed's compared numbers for the check's limits: the program
    (``"program"``), the reference one precision down in its place
    (``"control"``), or the service with one of :data:`FAULTS` planted."""
    return run(cell, seed=seed, seconds=0.0, trace=False, device=device, t_start=time.time(), work_dir=work_dir,
               fault=None if mode in ("program", "control") else mode, lower=mode == "control").numbers
