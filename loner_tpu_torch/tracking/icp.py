"""Point-to-plane ICP as Gauss-Newton steps on the tensors' device.

The port of ``loner_tpu/tracking/icp.py``: correspondences come from a
fixed-size voxel-hash grid (no k-d tree), normals from a batched 3 x 3 PCA,
and each update from a damped 6 x 6 Gauss-Newton solve, over a coarse-to-fine
schedule of distance thresholds. The JAX package runs the whole schedule as
one jitted program; here each stage is a Python loop of small operators, so
on a card the loop is bound by the host's launches.

The grid is bit-equal to the JAX one: the cell hash multiplies uint32 words
with wraparound, which is computed here in int64 with each product reduced
mod 2^32, and the points of a bucket keep the order of a stable sort.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.geometry import se3

_PRIMES = (73856093, 19349663, 83492791)
_U32 = 0xFFFFFFFF
# 27 neighbour-cell offsets, (27, 3), in the JAX package's order
_OFFSETS = [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


class IcpStage(NamedTuple):
    threshold: float = 1.0  # correspondence distance gate (meters)
    max_iterations: int = 10


class IcpConfig(NamedTuple):
    stages: Tuple[IcpStage, ...] = (IcpStage(1.5, 10), IcpStage(0.125, 10))
    n_buckets: int = 1 << 14
    bucket_slots: int = 8
    normal_neighbors: int = 10
    damping: float = 1e-6  # Levenberg damping on the 6 x 6 system


class VoxelHashGrid(NamedTuple):
    table: torch.Tensor  # (B, S) int64 indices into points, -1 = empty
    points: torch.Tensor  # (M, 3)
    valid: torch.Tensor  # (M,) bool
    cell_size: float


def _cells(points: torch.Tensor, cell_size: float) -> torch.Tensor:
    """Integer cell coordinates, int64 (floor in f32, then int32 as JAX). The
    divisor is a tensor on the points' device: CUDA divides by a host scalar
    as a product with its reciprocal, which rounds some quotients otherwise."""
    size = torch.full((), cell_size, dtype=points.dtype, device=points.device)
    return torch.floor(points / size).to(torch.int32).to(torch.int64)


def _hash_cells(cells: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """The JAX package's uint32 hash of (..., 3) cells: each coordinate as
    its two's-complement word times a prime mod 2^32, XORed, mod n_buckets."""
    c = cells & _U32
    h = ((c[..., 0] * _PRIMES[0]) & _U32) ^ ((c[..., 1] * _PRIMES[1]) & _U32) ^ ((c[..., 2] * _PRIMES[2]) & _U32)
    return h % n_buckets


def build_voxel_grid(points: torch.Tensor, valid: torch.Tensor, cell_size: float, n_buckets: int = 1 << 14,
                     slots: int = 8) -> VoxelHashGrid:
    """Points into hash buckets of up to ``slots`` entries each, in the order
    of a stable sort by hash; points past a bucket's slots are dropped."""
    m = points.shape[0]
    h = _hash_cells(_cells(points, cell_size), n_buckets)
    h = torch.where(valid, h, torch.full_like(h, n_buckets))  # invalid -> overflow bucket
    order = torch.argsort(h, stable=True)
    h_sorted = h[order]
    first_of_run = torch.searchsorted(h_sorted, h_sorted, right=False)
    ranks = torch.arange(m, device=points.device) - first_of_run
    size = n_buckets * slots
    dest = torch.where((ranks < slots) & (h_sorted < n_buckets), h_sorted * slots + ranks,
                       torch.full_like(h_sorted, size))
    flat = torch.full((size + 1,), -1, dtype=torch.int64, device=points.device)
    flat[dest] = order  # the extra slot takes every dropped point
    return VoxelHashGrid(flat[:size].reshape(n_buckets, slots), points, valid, cell_size)


def _candidates(grid: VoxelHashGrid, queries: torch.Tensor):
    """(candidate indices (Q, 27 S), squared distances with inf where there is
    no valid candidate)."""
    n_buckets = grid.table.shape[0]
    offsets = torch.tensor(_OFFSETS, dtype=torch.int64, device=queries.device)
    neigh = _cells(queries, grid.cell_size)[:, None, :] + offsets[None]
    cand = grid.table[_hash_cells(neigh, n_buckets)].reshape(queries.shape[0], -1)
    safe = torch.clamp(cand, min=0)
    d2 = torch.sum((grid.points[safe] - queries[:, None, :]) ** 2, dim=-1)
    ok = (cand >= 0) & grid.valid[safe]
    return cand, torch.where(ok, d2, torch.full_like(d2, float("inf")))


def nearest_neighbor(grid: VoxelHashGrid, queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest stored point of each query among its 27 surrounding cells:
    (index (Q,), distance (Q,)), the distance +inf where none was found."""
    cand, d2 = _candidates(grid, queries)
    best = torch.argmin(d2, dim=-1, keepdim=True)
    return torch.gather(cand, 1, best)[:, 0], torch.sqrt(torch.gather(d2, 1, best)[:, 0])


def k_nearest(grid: VoxelHashGrid, queries: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest stored points of each query among its 27 cells:
    (indices (Q, k), distances (Q, k)), inf-padded."""
    cand, d2 = _candidates(grid, queries)
    d2k, pos = torch.topk(d2, k, dim=-1, largest=False)
    return torch.gather(cand, 1, pos), torch.sqrt(d2k)


def estimate_normals(points: torch.Tensor, valid: torch.Tensor, radius: float, k: int = 10,
                     n_buckets: int = 1 << 14, slots: int = 8) -> torch.Tensor:
    """Per-point normals: the eigenvector of the smallest eigenvalue of the
    covariance of the k nearest points. The sign is arbitrary; point-to-plane
    Gauss-Newton does not depend on it."""
    grid = build_voxel_grid(points, valid, radius, n_buckets, slots)
    idx, dist = k_nearest(grid, points, k)
    neigh = points[torch.clamp(idx, min=0)]  # (M, k, 3)
    wf = (torch.isfinite(dist) & (idx >= 0)).to(points.dtype)[..., None]
    count = torch.clamp(torch.sum(wf, dim=1), min=1.0)
    mean = torch.sum(neigh * wf, dim=1) / count
    centered = (neigh - mean[:, None, :]) * wf
    cov = torch.einsum("mki,mkj->mij", centered, centered) / count[..., None]
    cov = cov + 1e-9 * torch.eye(3, dtype=points.dtype, device=points.device)
    _, vecs = torch.linalg.eigh(cov)
    return vecs[..., 0]


def _gn_step(T, src, src_valid, grid: VoxelHashGrid, normals, threshold: float, damping: float):
    """One point-to-plane Gauss-Newton update T <- exp(delta) T:
    (T, inlier rmse, fitness)."""
    p = src @ T[:3, :3].T + T[:3, 3]
    idx, dist = nearest_neighbor(grid, p)
    safe = torch.clamp(idx, min=0)
    q, n = grid.points[safe], normals[safe]
    wf = (src_valid & (idx >= 0) & (dist < threshold) & torch.isfinite(dist)).to(p.dtype)

    r = torch.sum(n * (p - q), dim=-1)
    # p' = p + t + omega x p: dr/dt = n, dr/domega = p x n
    J = torch.cat([n, torch.linalg.cross(p, n)], dim=-1)  # (N, 6)
    H = (J * wf[:, None]).T @ J + damping * torch.eye(6, dtype=p.dtype, device=p.device)
    b = -(J * (wf * r)[:, None]).sum(dim=0)
    delta = torch.linalg.solve(H, b)
    T_new = se3.pose_to_matrix(delta) @ T

    n_in = torch.sum(wf)
    rmse = torch.sqrt(torch.sum(wf * r * r) / torch.clamp(n_in, min=1.0))
    fitness = n_in / torch.clamp(torch.sum(src_valid.to(p.dtype)), min=1.0)
    return T_new, rmse, fitness


def make_icp(cfg: IcpConfig = IcpConfig(), device="cuda"):
    """The multi-stage ICP ``run(src (N, 3), src_valid, tgt (M, 3),
    tgt_valid, T_init) -> (T (4, 4), rmse, fitness)`` on ``device`` (the
    tensors are moved there). Normals come once, at the coarsest stage's
    radius; each stage builds its grid at its own threshold."""
    dev = resolve_device(device)

    def run(src, src_valid, tgt, tgt_valid, T_init):
        src, src_valid, tgt, tgt_valid, T = (x.to(dev) for x in (src, src_valid, tgt, tgt_valid, T_init))
        normals = estimate_normals(tgt, tgt_valid, cfg.stages[0].threshold, cfg.normal_neighbors,
                                   cfg.n_buckets, cfg.bucket_slots)
        rmse = fitness = torch.zeros((), dtype=src.dtype, device=dev)
        for stage in cfg.stages:
            grid = build_voxel_grid(tgt, tgt_valid, stage.threshold, cfg.n_buckets, cfg.bucket_slots)
            for _ in range(stage.max_iterations):
                T, rmse, fitness = _gn_step(T, src, src_valid, grid, normals, stage.threshold, cfg.damping)
        return T, rmse, fitness

    return run


def icp_point_to_plane(src: torch.Tensor, tgt: torch.Tensor, T_init: Optional[torch.Tensor] = None,
                       cfg: IcpConfig = IcpConfig(), src_valid: Optional[torch.Tensor] = None,
                       tgt_valid: Optional[torch.Tensor] = None, device="cuda"):
    """One-shot entry: build the ICP on ``device`` and run it once."""
    if T_init is None:
        T_init = torch.eye(4, dtype=src.dtype)
    if src_valid is None:
        src_valid = torch.ones(src.shape[0], dtype=torch.bool)
    if tgt_valid is None:
        tgt_valid = torch.ones(tgt.shape[0], dtype=torch.bool)
    return make_icp(cfg, device)(src, src_valid, tgt, tgt_valid, T_init)
