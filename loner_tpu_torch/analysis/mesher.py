"""Meshing: splat rendered sample weights into a grid, extract an isosurface.

The port of ``loner_tpu/analysis/mesher.py``: virtual lidar scans from every
``skip_step``-th pose, rendered at the train step's sample count, whose
per-sample weights are max-splatted into a uniform grid over the world cube
on the state's device (``scatter_reduce_`` with "amax": a maximum does not
depend on the order of the writes, so the grid is the same on every
device); the isosurface at ``level`` comes from naive surface nets on the
host (one vertex per cell whose corners straddle the level, two triangles
per crossing edge), and the vertices are moved out of the cube into metric
coordinates.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from loner_tpu_torch.data import synthetic
from loner_tpu_torch.geometry.rays import build_lidar_rays
from loner_tpu_torch.mapping.optimizer import MapperConfig, make_render_fn


def _grid_frame(resolution: int, bounds=None) -> Tuple[np.ndarray, np.ndarray]:
    """(lo, voxel size) of a grid of ``resolution`` cells a side over
    ``bounds`` (lo, hi) in cube coordinates, [-1, 1]^3 when None."""
    if bounds is None:
        lo, hi = np.array([-1.0, -1.0, -1.0]), np.array([1.0, 1.0, 1.0])
    else:
        lo, hi = np.asarray(bounds[0], float), np.asarray(bounds[1], float)
    return lo, (hi - lo) / resolution


def _splat_into(grid: torch.Tensor, points: torch.Tensor, weights: torch.Tensor, lo: np.ndarray,
                voxel: np.ndarray) -> None:
    """Max-splat ``weights`` (M,) at ``points`` (M, 3) into the (R, R, R)
    float32 ``grid`` in place. The cell index is computed in float64 as
    numpy computes it; points outside the grid are dropped."""
    r = grid.shape[0]
    lo_t = torch.as_tensor(lo, dtype=torch.float64, device=points.device)
    voxel_t = torch.as_tensor(voxel, dtype=torch.float64, device=points.device)
    idx = torch.floor((points.to(torch.float64) - lo_t) / voxel_t).to(torch.int64)
    inb = torch.all((idx >= 0) & (idx < r), dim=1)
    idx, w = idx[inb], weights[inb].to(torch.float32)
    flat = idx[:, 0] * r * r + idx[:, 1] * r + idx[:, 2]
    grid.view(-1).scatter_reduce_(0, flat, w, reduce="amax", include_self=True)


def splat_weights_to_grid(points_cube, weights, resolution: int, bounds=None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Max-splat ``weights`` (N,) at ``points_cube`` (N, 3) into a (R, R, R)
    grid ordered [x, y, z], zero where nothing lands. Arrays or tensors;
    the splat runs on the points' device. Returns (grid (numpy float32),
    lo, voxel size)."""
    pts = torch.as_tensor(points_cube)
    lo, voxel = _grid_frame(resolution, bounds)
    grid = torch.zeros((resolution,) * 3, dtype=torch.float32, device=pts.device)
    _splat_into(grid, pts, torch.as_tensor(weights, device=pts.device), lo, voxel)
    return grid.cpu().numpy(), lo, voxel


def surface_nets(grid: np.ndarray, level: float, origin: np.ndarray, voxel: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Naive surface nets over the grid's vertices: a vertex at the centre
    of each cell whose 8 corners straddle ``level``, and a quad (two
    triangles) of the 4 cells around every grid edge with a sign change.
    Returns (vertices (V, 3), faces (F, 3) int64)."""
    occ = grid > level
    r = np.array(grid.shape)

    cell = np.zeros(tuple(r - 1), np.int32)  # occupied corners of each cell
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cell += occ[dx:r[0] - 1 + dx, dy:r[1] - 1 + dy, dz:r[2] - 1 + dz]
    active = (cell > 0) & (cell < 8)
    cell_ids = np.full(tuple(r - 1), -1, np.int64)
    act_idx = np.argwhere(active)
    cell_ids[tuple(act_idx.T)] = np.arange(len(act_idx))
    verts = origin + (act_idx + 0.5) * voxel

    faces = []
    for axis in range(3):
        # the edges from vertex (i, j, k) to its +1 neighbour along axis
        sl_a = tuple(slice(0, -1) if a == axis else slice(None) for a in range(3))
        sl_b = tuple(slice(1, None) if a == axis else slice(None) for a in range(3))
        ii = np.argwhere(occ[sl_a] != occ[sl_b])
        a1, a2 = [a for a in range(3) if a != axis]
        quads = []  # the 4 cells around each crossing edge: offsets {-1, 0} on the other two axes
        for d1 in (-1, 0):
            for d2 in (-1, 0):
                coord = ii.copy()
                coord[:, a1] += d1
                coord[:, a2] += d2
                ok = np.all((coord >= 0) & (coord < (r - 1)), axis=1)
                ids = np.full(len(ii), -1, np.int64)
                ids[ok] = cell_ids[tuple(coord[ok].T)]
                quads.append(ids)
        q = np.stack(quads, axis=1)  # (E, 4) in the order (-1,-1), (-1,0), (0,-1), (0,0)
        q = q[np.all(q >= 0, axis=1)]
        faces.append(np.stack([q[:, 0], q[:, 1], q[:, 3]], axis=1))
        faces.append(np.stack([q[:, 0], q[:, 3], q[:, 2]], axis=1))
    return verts, np.concatenate(faces, axis=0)


class Mesher:
    """Render, splat, extract: a metric mesh of the map. ``last_timings``
    holds the seconds of the last :meth:`get_mesh` by part."""

    def __init__(self, cfg: MapperConfig, cube, state):
        self.cfg = cfg
        self.cube = cube
        self.state = state
        self.last_timings: dict = {}

    def get_mesh(self, keyframe_poses: np.ndarray, resolution: int = 128, level: float = 0.1, skip_step: int = 1,
                 n_channels: int = 32, n_azimuth: int = 256, chunk: int = 16384,
                 u_pdf: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(vertices (V, 3) metric, faces (F, 3)) from virtual scans of
        ``n_channels`` x ``n_azimuth`` rays at every ``skip_step``-th pose
        of ``keyframe_poses`` (N, 4, 4), rendered at ``n_samples_train``
        samples a ray. OGM's uniforms: ``u_pdf``, one row per ray of all the
        scans in order, else ``generator`` (one seeded with 0 when None)."""
        dev = self.state.poses.device
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        render_fn = make_render_fn(self.cfg, test=False, device=dev)
        if u_pdf is None and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        cube = self.cube.to(dev)
        lo, voxel = _grid_frame(resolution)
        grid = torch.zeros((resolution,) * 3, dtype=torch.float32, device=dev)
        dirs = torch.as_tensor(synthetic.spinning_lidar_directions(n_channels, n_azimuth), dtype=torch.float32,
                               device=dev)
        times = {"render_s": 0.0, "splat_s": 0.0}
        row = 0
        for pose in keyframe_poses[::skip_step]:
            pose_t = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
            for s in range(0, dirs.shape[0], chunk):
                t0 = time.perf_counter()
                d = dirs[s:s + chunk]
                bundle = build_lidar_rays(d, torch.zeros(d.shape[0], device=dev), pose_t, cube, self.cfg.ray_range)
                u = None if u_pdf is None else u_pdf[row:row + d.shape[0]].to(dev)
                row += d.shape[0]
                r = render_fn(self.state.params, self.state.occ_grid, bundle, u_pdf=u, generator=generator)
                sync()
                t1 = time.perf_counter()
                # RenderResult.points is transposed, (3, N, S)
                _splat_into(grid, r.points.reshape(3, -1).T, r.weights.reshape(-1), lo, voxel)
                sync()
                times["render_s"] += t1 - t0
                times["splat_s"] += time.perf_counter() - t1
                del r
        t0 = time.perf_counter()
        verts, faces = surface_nets(grid.cpu().numpy(), level, lo, voxel)
        times["surface_nets_s"] = time.perf_counter() - t0
        self.last_timings = times
        # out of the world cube
        return verts * float(self.cfg.world_scale) - self.cube.shift.cpu().numpy(), faces


def save_ply(path: str, vertices: np.ndarray, faces: np.ndarray):
    """An ASCII PLY mesh."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in vertices:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")


def save_pcd(path: str, points: np.ndarray):
    """An ASCII PCD v0.7 cloud of (x y z) rows."""
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n")
        f.write("FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n")
        f.write(f"WIDTH {len(points)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {len(points)}\nDATA ascii\n")
        for p in points:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
