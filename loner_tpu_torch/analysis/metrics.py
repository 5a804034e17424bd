"""Trajectory and map metrics, matching the reference's evaluation protocol.

A copy of ``loner_tpu/analysis/metrics.py`` (numpy and scipy only), so that
the port imports nothing of the JAX package.

Covers ``analysis/compute_metrics/traj`` (evo-style ATE/RPE on TUM
trajectories with timestamp association, ``analysis/compute_metrics/
README.md``) and ``analysis/evaluate_lidar_map.py`` (accuracy / completion /
chamfer / precision / recall / F-score after ICP re-alignment). Implemented
natively (no evo/open3d in this environment): Umeyama SE(3) alignment,
cKDTree nearest neighbors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


def associate_by_time(
    t_a: np.ndarray, t_b: np.ndarray, max_diff: float = 0.1
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association (evo's --t_max_diff protocol).
    Returns index arrays (into a, into b)."""
    ia, ib = [], []
    used = np.zeros(len(t_b), bool)
    order = np.argsort(t_a)
    for i in order:
        j = np.searchsorted(t_b, t_a[i])
        best, best_d = -1, max_diff + 1e-9
        for jj in (j - 1, j, j + 1):
            if 0 <= jj < len(t_b) and not used[jj]:
                d = abs(t_b[jj] - t_a[i])
                if d < best_d:
                    best, best_d = jj, d
        if best >= 0:
            used[best] = True
            ia.append(i)
            ib.append(best)
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares SE(3) (optionally Sim(3)) alignment src -> dst.
    Returns (R, t, s)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / var_s
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(
    est_poses: np.ndarray,  # (N,4,4)
    gt_poses: np.ndarray,  # (M,4,4)
    est_times: Optional[np.ndarray] = None,
    gt_times: Optional[np.ndarray] = None,
    max_diff: float = 0.1,
    align: bool = True,
) -> Dict[str, float]:
    """Absolute trajectory error (RMSE/mean/median/max of translation error
    after association + SE(3) alignment) — the evo_ape protocol."""
    if est_times is not None and gt_times is not None:
        ia, ib = associate_by_time(est_times, gt_times, max_diff)
        est = est_poses[ia]
        gt = gt_poses[ib]
    else:
        n = min(len(est_poses), len(gt_poses))
        est, gt = est_poses[:n], gt_poses[:n]
    assert len(est) > 0, "no associated poses"

    p_est = est[:, :3, 3]
    p_gt = gt[:, :3, 3]
    if align and len(est) >= 3:
        R, t, s = umeyama_alignment(p_est, p_gt)
        p_est = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "n": int(len(err)),
    }


def rpe(
    est_poses: np.ndarray,
    gt_poses: np.ndarray,
    delta: int = 1,
) -> Dict[str, float]:
    """Relative pose error over a frame delta (translation + rotation)."""
    n = min(len(est_poses), len(gt_poses)) - delta
    terr, rerr = [], []
    for i in range(n):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        ang = np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1))
        rerr.append(ang)
    terr = np.asarray(terr)
    rerr = np.asarray(rerr)
    return {
        "trans_rmse": float(np.sqrt(np.mean(terr**2))),
        "rot_rmse_deg": float(np.degrees(np.sqrt(np.mean(rerr**2)))),
        "n": int(n),
    }


def icp_realign(src: np.ndarray, dst: np.ndarray, iterations: int = 20, threshold: float = 1.0):
    """Small host-side point-to-point ICP for map re-alignment before map
    metrics (the reference re-aligns with o3d ICP,
    ``analysis/evaluate_lidar_map.py:26-55``)."""
    T = np.eye(4)
    tree = cKDTree(dst)
    cur = src.copy()
    for _ in range(iterations):
        d, idx = tree.query(cur, k=1)
        m = d < threshold
        if m.sum() < 10:
            break
        R, t, _ = umeyama_alignment(cur[m], dst[idx[m]])
        cur = (R @ cur.T).T + t
        dT = np.eye(4)
        dT[:3, :3] = R
        dT[:3, 3] = t
        T = dT @ T
    return cur, T


def map_metrics(
    est_points: np.ndarray,  # (N,3) estimated map cloud
    gt_points: np.ndarray,  # (M,3) groundtruth cloud
    f_score_threshold: float = 0.1,
    realign: bool = True,
) -> Dict[str, float]:
    """Accuracy (est->gt), completion (gt->est), chamfer, precision/recall/
    F-score at a distance threshold (``analysis/evaluate_lidar_map.py:59-80``)."""
    if realign:
        est_points, _ = icp_realign(est_points, gt_points)
    tree_gt = cKDTree(gt_points)
    tree_est = cKDTree(est_points)
    d_est_to_gt, _ = tree_gt.query(est_points, k=1)
    d_gt_to_est, _ = tree_est.query(gt_points, k=1)

    accuracy = float(d_est_to_gt.mean())
    completion = float(d_gt_to_est.mean())
    chamfer = accuracy + completion
    precision = float((d_est_to_gt < f_score_threshold).mean())
    recall = float((d_gt_to_est < f_score_threshold).mean())
    f_score = 2 * precision * recall / max(precision + recall, 1e-12)
    return {
        "accuracy": accuracy,
        "completion": completion,
        "chamfer": chamfer,
        "precision": precision,
        "recall": recall,
        "f_score": f_score,
    }
