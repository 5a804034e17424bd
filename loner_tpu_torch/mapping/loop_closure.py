"""Loop closure and pose-graph refinement over keyframes.

The port of ``loner_tpu/mapping/loop_closure.py``:

  1. candidate pairs: keyframes far apart in index but near in space;
  2. loop factors: point-to-plane ICP re-alignment of the two scans (the
     tracker's ICP, ``tracking/icp.py::make_icp``), accepted by fitness and
     rmse;
  3. the graph: odometry between-factors from the tracked poses, the loop
     factors, and weak priors on the mapper's optimized poses, anchored at
     keyframe 0;
  4. the Gauss-Newton solve (``parallel/pose_graph.py``) on the SLAM's
     device; ``LonerSLAM.stop`` feeds the refined poses back to the mapper
     state and the trajectory logger.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np
import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.geometry import se3
from loner_tpu_torch.parallel.pose_graph import make_factors, make_priors, solve_pose_graph
from loner_tpu_torch.tracking.icp import IcpConfig, IcpStage, make_icp


@dataclass
class LoopClosureConfig:
    enabled: bool = False
    min_index_gap: int = 8  # candidate pairs are at least this many keyframes apart
    max_candidate_distance_m: float = 4.0
    max_candidates: int = 16  # the ICP budget of one refinement
    # skip candidates within this index radius of a chosen pair, so that the
    # ICP budget spreads along the loop
    suppression_radius: int = 1
    # accept gates: fitness ~0.5 is normal for partly overlapping spinning
    # lidar scans (sky misses), so the rmse gate rejects most
    min_fitness: float = 0.35
    max_rmse: float = 0.3
    icp: IcpConfig = field(default_factory=lambda: IcpConfig(stages=(IcpStage(1.5, 10), IcpStage(0.25, 10)),
                                                             n_buckets=1 << 13))
    target_points: int = 2048
    odometry_weight: float = 1.0
    loop_weight: float = 2.0
    prior_weight: float = 0.01  # a weak pull toward the mapper's poses
    gn_iterations: int = 10


def _kf_cloud(kf, target_points: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sensor-frame points of a keyframe's scan, uniformly downsampled to
    ``target_points`` and zero-padded to it, and their validity."""
    dirs = np.asarray(kf.scan.ray_directions)
    dist = np.asarray(kf.scan.distances)
    idx = np.flatnonzero(np.asarray(kf.scan.valid))
    n = target_points
    if len(idx) > n:
        idx = idx[np.linspace(0, len(idx) - 1, n).astype(np.int64)]
    pts = dirs[idx] * dist[idx, None]
    pad = n - len(idx)
    v = np.concatenate([np.ones(len(idx), bool), np.zeros(pad, bool)])
    if pad:
        pts = np.concatenate([pts, np.zeros((pad, 3), pts.dtype)])
    return pts.astype(np.float32), v


def find_candidates(positions: np.ndarray, cfg: LoopClosureConfig) -> List[Tuple[int, int]]:
    """Keyframe pairs (i, j), j - i >= min_index_gap, within
    max_candidate_distance_m of each other; closest first, near-duplicates of
    a chosen pair skipped, at most max_candidates."""
    k = len(positions)
    cands = []
    for i in range(k):
        for j in range(i + cfg.min_index_gap, k):
            d = float(np.linalg.norm(positions[i] - positions[j]))
            if d <= cfg.max_candidate_distance_m:
                cands.append((d, i, j))
    cands.sort()
    out = []
    r = cfg.suppression_radius
    for _, i, j in cands:
        if any(abs(i - a) <= r and abs(j - b) <= r for a, b in out):
            continue
        out.append((i, j))
        if len(out) >= cfg.max_candidates:
            break
    return out


def generate_loop_factors(keyframes: Sequence, poses: np.ndarray, cfg: LoopClosureConfig,
                          device="cuda") -> List[tuple]:
    """ICP-verified loop-closure edges (i, j, T_i^-1 T_j float64, weight)
    from the current keyframe poses (K, 4, 4); the ICP runs on ``device``."""
    icp = make_icp(cfg.icp, device)
    edges = []
    for i, j in find_candidates(poses[:, :3, 3], cfg):
        pts_i, v_i = _kf_cloud(keyframes[i], cfg.target_points)
        pts_j, v_j = _kf_cloud(keyframes[j], cfg.target_points)
        # the initial guess from the current poses: T_ij maps j's sensor frame into i's
        T_init = np.linalg.inv(poses[i]) @ poses[j]
        T_rel, rmse, fitness = icp(torch.from_numpy(pts_j), torch.from_numpy(v_j), torch.from_numpy(pts_i),
                                   torch.from_numpy(v_i), torch.as_tensor(T_init, dtype=torch.float32))
        rmse, fitness = float(rmse), float(fitness)
        if fitness >= cfg.min_fitness and rmse <= cfg.max_rmse:
            # information-scaled: a tight fit outweighs a marginal one, and
            # must out-pull the odometry chain it contradicts
            w = cfg.loop_weight * fitness / max(rmse, 0.01)
            edges.append((i, j, T_rel.cpu().numpy().astype(np.float64), w))
    return edges


def refine_keyframe_poses(keyframes: Sequence, optimized_poses: np.ndarray, cfg: LoopClosureConfig, mesh=None,
                          device="cuda") -> Tuple[np.ndarray, dict]:
    """Odometry factors from the tracked poses, ICP loop factors and weak
    priors on the mapper's poses (K, 4, 4), solved by Gauss-Newton on
    ``device``. Returns (refined (K, 4, 4) float64, info dict)."""
    dev = resolve_device(device)
    k = len(keyframes)
    tracked = np.stack([kf.tracked_pose for kf in keyframes])
    edges = [(i, i + 1, np.linalg.inv(tracked[i]) @ tracked[i + 1], cfg.odometry_weight) for i in range(k - 1)]
    loops = generate_loop_factors(keyframes, optimized_poses, cfg, dev)
    edges.extend(loops)
    priors = make_priors([(i, optimized_poses[i], cfg.prior_weight) for i in range(k)])
    pose6 = se3.matrix_to_pose(torch.as_tensor(np.asarray(optimized_poses, np.float32))).to(dev)
    refined6, cost = solve_pose_graph(pose6, make_factors(edges), n_iters=cfg.gn_iterations, mesh=mesh,
                                      priors=priors)
    refined = se3.pose_to_matrix(refined6).cpu().numpy().astype(np.float64)
    return refined, {"n_loop_closures": len(loops), "n_factors": len(edges), "final_cost": float(cost)}
