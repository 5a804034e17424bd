"""The synthetic sensor stream a traffic mix describes: scene, lap, scans.

A spinning lidar (channels x azimuth steps over a vertical field of view)
is ray-cast against an analytic scene (a ground plane and axis-aligned
boxes: a courtyard, or a forest of trunks) from poses on circles, on the
device in float64. Each scan
keeps its returns within the range, padded with invalid points (or thinned
by a uniform stride) to the scan budget, and its misses as sky directions,
padded or thinned to the sky budget. The world cube that normalises the map
comes from the trajectory's poses and the range.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.draws import SCANS, sub_seed

# a ground plane at z = 0 and boxes (centre, full size), metres
COURTYARD = [
    ((20.0, 0.0, 2.5), (1.0, 40.0, 5.0)), ((-20.0, 0.0, 2.5), (1.0, 40.0, 5.0)),
    ((0.0, 20.0, 2.5), (40.0, 1.0, 5.0)), ((0.0, -20.0, 2.5), (40.0, 1.0, 5.0)),
    ((6.0, 5.0, 1.5), (1.5, 1.5, 3.0)), ((-5.0, -7.0, 2.0), (2.0, 2.0, 4.0)),
    ((-8.0, 8.0, 1.0), (3.0, 1.0, 2.0)), ((4.0, -4.0, 0.75), (1.0, 1.0, 1.5)),
]


def scene_boxes(mix: dict) -> list:
    """The mix's scene: the courtyard, or a forest of thin trunks (radius
    0.2-0.6 m, 6-14 m tall) scattered over +-extent by ``default_rng(seed)``,
    none within 3 m of the origin."""
    if mix["scene"] == "courtyard":
        return COURTYARD
    f = mix["forest"]
    rng = np.random.default_rng(f["seed"])
    boxes = []
    for _ in range(f["trees"]):
        x, y = rng.uniform(-f["extent_m"], f["extent_m"], 2)
        if abs(x) < 3 and abs(y) < 3:
            continue
        r, h = rng.uniform(0.2, 0.6), rng.uniform(6.0, 14.0)
        boxes.append(((x, y, h / 2), (2 * r, 2 * r, h)))
    return boxes


def lap_poses(n: int, radius: float, height: float) -> np.ndarray:
    """(n, 4, 4) world_T_lidar poses evenly on a circle, yaw along it."""
    theta = 2 * np.pi * np.arange(n) / n
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i, th in enumerate(theta):
        yaw = th + np.pi / 2
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        poses[i, :3, 3] = [radius * np.cos(th), radius * np.sin(th), height]
    return poses


def lidar_directions(channels: int, azimuth: int, vfov_deg: Tuple[float, float]) -> np.ndarray:
    """(azimuth * channels, 3) float64 unit directions, azimuth-major."""
    el = np.deg2rad(np.linspace(vfov_deg[0], vfov_deg[1], channels))
    az = np.linspace(0, 2 * np.pi, azimuth, endpoint=False)
    a, e = np.meshgrid(az, el, indexing="ij")
    return np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], axis=-1).reshape(-1, 3)


def ray_cast(boxes: list, origin: torch.Tensor, dirs: torch.Tensor, max_range: float) -> torch.Tensor:
    """First-hit distance per ray (inf where nothing lies within range)."""
    best = torch.full((dirs.shape[0],), float("inf"), dtype=dirs.dtype, device=dirs.device)
    t_g = (0.0 - origin[2]) / dirs[:, 2]
    best = torch.where((dirs[:, 2] < -1e-9) & (t_g > 0), torch.minimum(best, t_g), best)
    for centre, size in boxes:
        c = torch.as_tensor(centre, dtype=dirs.dtype, device=dirs.device)
        h = torch.as_tensor(size, dtype=dirs.dtype, device=dirs.device) / 2
        t1 = (c - h - origin) / dirs
        t2 = (c + h - origin) / dirs
        near = torch.nan_to_num(torch.minimum(t1, t2), nan=-float("inf")).amax(dim=1)
        far = torch.nan_to_num(torch.maximum(t1, t2), nan=float("inf")).amin(dim=1)
        hit = (near <= far) & (far > 0) & (near > 1e-6)
        best = torch.where(hit, torch.minimum(best, near), best)
    return torch.where(best > max_range, torch.full_like(best, float("inf")), best)


def _fit(idx: torch.Tensor, budget: int) -> Tuple[torch.Tensor, int]:
    """``idx`` thinned by a uniform stride to at most ``budget``."""
    if idx.numel() > budget:
        idx = idx[torch.linspace(0, idx.numel() - 1, budget, device=idx.device).long()]
    return idx, int(idx.numel())


def trajectory(mix: dict) -> np.ndarray:
    """The mix's poses: its lap, or its circles one after the other."""
    if "lap" in mix:
        lap = mix["lap"]
        return lap_poses(lap["keyframes"], lap["radius_m"], lap["height_m"])
    return np.concatenate([lap_poses(c["poses"], c["radius_m"], c["height_m"]) for c in mix["circles"]])


def make_scans(mix: dict, device, seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """One scan per pose of the mix's trajectory: ``dirs`` (P, 3), ``dists``
    (P,), ``valid`` (P,), ``sky_dirs`` (S, 3), ``sky_valid`` (S,) as float32
    and bool host arrays, and the ``pose`` (4, 4). A mix with
    ``range_noise_m`` adds Gaussian range noise drawn from ``seed``."""
    s = mix["sensor"]
    boxes = scene_boxes(mix)
    dirs = torch.as_tensor(lidar_directions(s["channels"], s["azimuth"], tuple(s["vfov_deg"])), device=device)
    noise = s.get("range_noise_m", 0.0)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, SCANS))
    out = []
    for pose in trajectory(mix):
        p = torch.as_tensor(pose, device=device)
        dist = ray_cast(boxes, p[:3, 3], dirs @ p[:3, :3].T, s["range_m"][1])
        if noise:
            dist = dist + noise * torch.randn(dist.shape, generator=gen, dtype=dist.dtype, device=device)
        hit, n_hit = _fit(torch.nonzero(torch.isfinite(dist))[:, 0], s["scan_points"])
        sky, n_sky = _fit(torch.nonzero(~torch.isfinite(dist))[:, 0], s["sky_points"])
        scan = {"dirs": np.zeros((s["scan_points"], 3), np.float32), "dists": np.zeros(s["scan_points"], np.float32),
                "valid": np.zeros(s["scan_points"], bool), "sky_dirs": np.zeros((s["sky_points"], 3), np.float32),
                "sky_valid": np.zeros(s["sky_points"], bool), "pose": pose}
        scan["dirs"][:n_hit] = dirs[hit].float().cpu().numpy()
        scan["dists"][:n_hit] = dist[hit].float().cpu().numpy()
        scan["valid"][:n_hit] = True
        scan["sky_dirs"][:n_sky] = dirs[sky].float().cpu().numpy()
        scan["sky_valid"][:n_sky] = True
        out.append(scan)
    return out


def world_cube(poses: np.ndarray, far: float, padding: float = 0.1) -> Tuple[float, np.ndarray]:
    """(scale, shift): the cube holding every pose's +-far view box,
    ``p_cube = (p_world + shift) / scale``, scale rounded to float32."""
    corners = np.array([[x, y, z] for x in (-far, far) for y in (-far, far) for z in (-far, far)], np.float64)
    pts = np.concatenate([(p[:3, :3] @ corners.T).T + p[:3, 3] for p in poses] + [poses[:, :3, 3]])
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    scale = np.linalg.norm(hi - lo) / (2 * np.sqrt(3.0)) * (1 + padding)
    return float(np.float32(scale)), (-(lo + (hi - lo) / 2)).astype(np.float32)
