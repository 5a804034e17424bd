"""Offline renders of a trained map: virtual lidar scans and camera images.

The port of ``loner_tpu/analysis/renderer.py``: the field work (rays,
sampler, field, compositing) runs through the eval render
(``make_render_fn``) on the state's device, the rays in chunks of at most
``chunk``; results come back as numpy arrays. ``render_lidar_scan`` drops
rays whose depth variance reaches ``var_threshold`` or that never
terminated inside the range; ``assemble_global_cloud`` merges the scans
along a trajectory into one voxel-averaged cloud.

OGM's inverse-CDF uniforms are the only random draws: ``u_pdf`` (one row
per ray of the set, sliced per chunk) or, without it, a generator on the
state's device (one seeded with 0 when none is given, so that every scan of
a trajectory renders with the same draws, as the JAX package's renders all
start from one key).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from loner_tpu_torch.data import synthetic
from loner_tpu_torch.geometry.rays import build_camera_rays, build_lidar_rays, camera_ray_directions
from loner_tpu_torch.mapping.optimizer import MapperConfig, make_render_fn
from loner_tpu_torch.runtime.profiling import span


def _render_chunked(cfg: MapperConfig, state, dirs: np.ndarray, pose: np.ndarray, build_fn,
                    chunk: int = 16384, u_pdf: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None, rgb: bool = False,
                    render_strategy: str = "default", peak_consistency: bool = False) -> Dict[str, np.ndarray]:
    """Render the direction set ``dirs`` (N, 3) at ``pose`` in chunks of at
    most ``chunk`` rays on the state's device; ``build_fn(dirs, pose)``
    makes each chunk's rays. Returns numpy arrays: depth, variance, opacity
    (cube units), rgb with ``rgb``, and with ``peak_consistency``
    peak_depth, |z at the largest weight - expected depth|."""
    dev = state.poses.device
    render_fn = make_render_fn(cfg, test=True, sigma_only=not rgb, render_strategy=render_strategy, device=dev)
    if u_pdf is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dirs_t = torch.as_tensor(np.asarray(dirs, np.float32), device=dev)
    pose_t = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
    keys = ["depth", "variance", "opacity"] + ["rgb"] * rgb + ["peak_depth"] * peak_consistency
    out = {k: [] for k in keys}
    for s in range(0, dirs_t.shape[0], chunk):
        with span("loner.render.chunk"):
            bundle = build_fn(dirs_t[s:s + chunk], pose_t)
            u = None if u_pdf is None else u_pdf[s:s + chunk].to(dev)
            r = render_fn(state.params, state.occ_grid, bundle, u_pdf=u, generator=generator)
            out["depth"].append(r.depth)
            out["variance"].append(r.variance)
            out["opacity"].append(r.opacity)
            if rgb:
                out["rgb"].append(r.rgb)
            if peak_consistency:
                # large where the weights along the ray are multi-modal or diffuse
                z_peak = torch.gather(r.z_vals, 1, torch.argmax(r.weights, dim=1, keepdim=True))[:, 0]
                out["peak_depth"].append(torch.abs(z_peak - r.depth))
    with span("loner.render.readback"):
        return {k: torch.cat(v).cpu().numpy() for k, v in out.items()}


def lidar_rays(cfg: MapperConfig, cube, dirs: torch.Tensor, pose: torch.Tensor):
    """The rays :func:`render_lidar_scan` renders: sensor-frame directions
    ``dirs`` (N, 3) at ``pose`` (4, 4, metric world_T_lidar), on their
    device, with ``cube`` there."""
    return build_lidar_rays(dirs, torch.zeros(dirs.shape[0], device=dirs.device), pose, cube, cfg.ray_range)


def render_lidar_scan(cfg: MapperConfig, cube, state, pose: np.ndarray, n_channels: int = 32, n_azimuth: int = 512,
                      vfov_deg: Tuple[float, float] = (-22.5, 22.5), var_threshold: Optional[float] = 1e-2,
                      chunk: int = 16384, u_pdf: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> Dict[str, np.ndarray]:
    """A virtual spinning-lidar sweep at ``pose`` (4, 4), metric
    world_T_lidar: metric ``depth`` and ``variance`` per direction, the
    ``keep`` mask (variance under ``var_threshold`` m^2 when given, depth
    under 0.99 of the range's far end), the kept rays' world ``points`` and
    the sensor-frame ``directions``."""
    dirs = synthetic.spinning_lidar_directions(n_channels, n_azimuth, vfov_deg)
    cube_d = cube.to(state.poses.device)
    out = _render_chunked(cfg, state, dirs, pose, lambda d, p: lidar_rays(cfg, cube_d, d, p), chunk, u_pdf,
                          generator)
    scale = cfg.world_scale
    depth_m = out["depth"] * scale
    keep = np.ones(len(dirs), bool)
    if var_threshold is not None:
        keep &= out["variance"] * scale * scale < var_threshold * scale * scale
    keep &= depth_m < cfg.ray_range[1] * 0.99  # rays that never terminated inside the range
    pose = np.asarray(pose)
    points = pose[:3, 3] + (dirs @ pose[:3, :3].T) * depth_m[:, None]
    return {"depth": depth_m, "variance": out["variance"] * scale * scale, "points": points[keep], "keep": keep,
            "directions": dirs}


def render_camera_image(cfg: MapperConfig, cube, state, pose: np.ndarray, K: np.ndarray, height: int, width: int,
                        chunk: int = 16384, rgb: bool = True, distortion: Optional[np.ndarray] = None,
                        render_strategy: str = "default", peak_consistency: bool = False,
                        u_pdf: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> Dict[str, np.ndarray]:
    """A full image at ``pose`` (4, 4), metric world_T_camera, through the
    intrinsics ``K``: metric ``depth`` and ``variance``, ``opacity``, the
    intensity branch's ``rgb`` (clipped to [0, 1]) with ``rgb``, and the
    metric ``peak_depth`` map with ``peak_consistency``, each (H, W[, C]).
    ``distortion`` (plumb-bob coefficients) makes the rays follow the
    distorted pixel grid; ``render_strategy`` picks the compositing."""
    if distortion is not None and np.any(distortion):
        from loner_tpu_torch.data.calibration import CameraCalibration, undistorted_pixel_rays

        dirs = undistorted_pixel_rays(CameraCalibration(K=np.asarray(K, float), distortion=np.asarray(distortion, float),
                                                        width=width, height=height))
    else:
        dirs = camera_ray_directions(height, width, torch.as_tensor(np.asarray(K), dtype=torch.float32)).numpy()
    cube_d = cube.to(state.poses.device)

    def build(d, p):
        return build_camera_rays(d, p, cube_d, cfg.ray_range)

    out = _render_chunked(cfg, state, dirs, pose, build, chunk, u_pdf, generator, rgb=rgb,
                          render_strategy=render_strategy, peak_consistency=peak_consistency)
    scale = cfg.world_scale
    result = {
        "depth": (out["depth"] * scale).reshape(height, width),
        "variance": (out["variance"] * scale * scale).reshape(height, width),
        "opacity": out["opacity"].reshape(height, width),
    }
    if rgb:
        result["rgb"] = np.clip(out["rgb"].reshape(height, width, -1), 0.0, 1.0)
    if peak_consistency:
        result["peak_depth"] = (out["peak_depth"] * scale).reshape(height, width)
    return result


def assemble_global_cloud(cfg: MapperConfig, cube, state, poses: np.ndarray, skip_step: int = 1,
                          voxel_size: float = 0.1, **scan_kwargs) -> np.ndarray:
    """Virtual scans at every ``skip_step``-th pose of ``poses`` (N, 4, 4),
    merged and voxel-downsampled; ``scan_kwargs`` go to each
    :func:`render_lidar_scan`."""
    clouds = [render_lidar_scan(cfg, cube, state, pose, **scan_kwargs)["points"] for pose in poses[::skip_step]]
    return voxel_downsample(np.concatenate(clouds, axis=0), voxel_size)


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """The mean of the points in each occupied voxel of ``voxel_size``."""
    if len(points) == 0:
        return points
    keys = np.floor(points / voxel_size).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], 3))
    np.add.at(sums, inv.reshape(-1), points)
    return sums / counts[:, None]
