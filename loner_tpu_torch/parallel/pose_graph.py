"""Pose-graph refinement over keyframes by Gauss-Newton.

The port of ``loner_tpu/parallel/pose_graph.py`` on one device: odometry
between-factors, loop-closure factors and unary priors on se(3) 6-vectors,
a dense normal system (6K, 6K) and ``n_iters`` Gauss-Newton steps with an
anchor prior on one pose. The JAX package can shard the factors over a
device mesh (``mesh``); that form is queue A item 3 and raises here.

Residuals are the smooth first-order se(3) error of the JAX package
(translation and the antisymmetric part of the rotation), differentiable at
zero error. Their Jacobians are taken with respect to the raw 6-vectors
through ``se3.pose_to_matrix`` by forward-mode autodiff, batched over the
factors, as ``jax.jacfwd`` takes them; and the update is ``poses +
delta`` in that same chart, as the JAX package does: a
right-perturbation retraction would mismatch those Jacobians and can
diverge on loopy graphs. Factors are float32 (their relative transforms are
formed in float64 by the callers); the solve is float32 with the JAX
package's damping and anchor weight.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from loner_tpu_torch.geometry import se3


class PoseGraphFactors(NamedTuple):
    """Between-factors i -> j with measured relative transform z (se3
    6-vector of T_i^-1 T_j), padded to a static count; ``weight`` is 0 for
    padding."""

    i: torch.Tensor  # (F,) int64
    j: torch.Tensor  # (F,) int64
    z: torch.Tensor  # (F, 6) float32
    weight: torch.Tensor  # (F,) float32

    def to(self, device) -> "PoseGraphFactors":
        return type(self)(*(t.to(device) for t in self))


class PosePriors(NamedTuple):
    """Unary priors: pose i should equal z (se3 6-vector) with a weight."""

    i: torch.Tensor  # (P,) int64
    z: torch.Tensor  # (P, 6) float32
    weight: torch.Tensor  # (P,) float32

    def to(self, device) -> "PosePriors":
        return type(self)(*(t.to(device) for t in self))


def _pose6_rows(transforms, pad: int) -> torch.Tensor:
    """(n + pad, 6) float32 se3 6-vectors of (4, 4) transforms, zero-padded."""
    z = se3.matrix_to_pose(torch.as_tensor(np.stack([np.asarray(T, np.float32) for T in transforms])))
    return torch.cat([z, torch.zeros((pad, 6), dtype=z.dtype)]) if pad else z


def make_priors(entries, n_pad: Optional[int] = None) -> PosePriors:
    """entries: list of (i, T (4, 4), weight), padded to ``n_pad``."""
    n = len(entries)
    pad = (n_pad or n) - n
    return PosePriors(
        torch.as_tensor([e[0] for e in entries] + [0] * pad, dtype=torch.int64),
        _pose6_rows([e[1] for e in entries], pad),
        torch.as_tensor([e[2] if len(e) > 2 else 1.0 for e in entries] + [0.0] * pad, dtype=torch.float32),
    )


def make_factors(edges, n_pad: Optional[int] = None) -> PoseGraphFactors:
    """edges: list of (i, j, T_rel (4, 4), weight), padded to ``n_pad``."""
    n = len(edges)
    pad = (n_pad or n) - n
    return PoseGraphFactors(
        torch.as_tensor([e[0] for e in edges] + [0] * pad, dtype=torch.int64),
        torch.as_tensor([e[1] for e in edges] + [0] * pad, dtype=torch.int64),
        _pose6_rows([e[2] for e in edges], pad),
        torch.as_tensor([e[3] if len(e) > 3 else 1.0 for e in edges] + [0.0] * pad, dtype=torch.float32),
    )


def _error_vector(E: torch.Tensor) -> torch.Tensor:
    """[t_E, vee((R_E - R_E^T) / 2)] of error transforms E (..., 4, 4)."""
    R = E[..., :3, :3]
    rot = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    return torch.cat([E[..., :3, 3], rot * 0.5], dim=-1)


def _between_residual(pi: torch.Tensor, pj: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Smooth residual (..., 6) of E = Z^-1 Ti^-1 Tj: first-order equal to
    log(E) near the identity and, unlike the exact log, differentiable at
    zero."""
    E = se3.inverse(se3.pose_to_matrix(z)) @ se3.inverse(se3.pose_to_matrix(pi)) @ se3.pose_to_matrix(pj)
    return _error_vector(E)


def _prior_residual(pi: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Smooth unary residual (..., 6) of E = Z^-1 T_i."""
    return _error_vector(se3.inverse(se3.pose_to_matrix(z)) @ se3.pose_to_matrix(pi))


def _jacobian(fn, args, argnum: int) -> torch.Tensor:
    """d fn(*args) / d args[argnum], (F, 6, 6), by forward-mode autodiff: one
    pass per input coordinate, batched over the F factors. (It is what
    ``jax.jacfwd`` computes; ``torch.func.jacfwd`` is not used because it
    promotes some float32 tangents to float64.)"""
    cols = []
    with fwAD.dual_level():
        for c in range(args[argnum].shape[-1]):
            tangent = torch.zeros_like(args[argnum])
            tangent[..., c] = 1.0
            duals = list(args)
            duals[argnum] = fwAD.make_dual(args[argnum], tangent)
            cols.append(fwAD.unpack_dual(fn(*duals)).tangent)
    return torch.stack(cols, dim=-1)


def _factor_system(pi, pj, z, w):
    """Each factor's (Hii, Hjj, Hij, bi, bj, cost), batched over factors."""
    r = _between_residual(pi, pj, z)
    Ji = _jacobian(_between_residual, (pi, pj, z), 0)  # (F, 6, 6)
    Jj = _jacobian(_between_residual, (pi, pj, z), 1)
    w3 = w[:, None, None]
    Jit, Jjt = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
    return (w3 * (Jit @ Ji), w3 * (Jjt @ Jj), w3 * (Jit @ Jj), w[:, None] * (Jit @ r[..., None])[..., 0],
            w[:, None] * (Jjt @ r[..., None])[..., 0], w * torch.sum(r * r, dim=-1))


def _prior_system(pi, z, w):
    r = _prior_residual(pi, z)
    J = _jacobian(_prior_residual, (pi, z), 0)
    Jt = J.transpose(-1, -2)
    return w[:, None, None] * (Jt @ J), w[:, None] * (Jt @ r[..., None])[..., 0], w * torch.sum(r * r, dim=-1)


def _assemble(poses6: torch.Tensor, factors: PoseGraphFactors, k: int, priors: Optional[PosePriors] = None):
    """Dense normal system: H (K, K, 6, 6), b (K, 6) and the total cost."""
    pi, pj = poses6[factors.i], poses6[factors.j]
    Hii, Hjj, Hij, bi, bj, cost = _factor_system(pi, pj, factors.z, factors.weight)
    H = torch.zeros((k, k, 6, 6), dtype=poses6.dtype, device=poses6.device)
    b = torch.zeros((k, 6), dtype=poses6.dtype, device=poses6.device)
    # repeated (i, j) blocks sum: accumulate, never a plain assignment
    H.index_put_((factors.i, factors.i), Hii, accumulate=True)
    H.index_put_((factors.j, factors.j), Hjj, accumulate=True)
    H.index_put_((factors.i, factors.j), Hij, accumulate=True)
    H.index_put_((factors.j, factors.i), Hij.transpose(-1, -2), accumulate=True)
    b.index_add_(0, factors.i, bi)
    b.index_add_(0, factors.j, bj)
    total = torch.sum(cost)
    if priors is not None:
        Hp, bp, cp = _prior_system(poses6[priors.i], priors.z, priors.weight)
        H.index_put_((priors.i, priors.i), Hp, accumulate=True)
        b.index_add_(0, priors.i, bp)
        total = total + torch.sum(cp)
    return H, b, total


@torch.no_grad()
def solve_pose_graph(poses6: torch.Tensor, factors: PoseGraphFactors, n_iters: int = 10, damping: float = 1e-6,
                     anchor_index: int = 0, anchor_weight: float = 1e6, mesh=None, axis: str = "data",
                     priors: Optional[PosePriors] = None):
    """Gauss-Newton pose-graph optimization on ``poses6``'s device (the
    factors and priors are moved there). Returns (refined (K, 6), the cost
    at the last linearisation point, a scalar tensor)."""
    if mesh is not None:
        raise NotImplementedError("solve_pose_graph(mesh=...): factors sharded over several cards are not "
                                  "ported (ROADMAP.md, queue A item 3)")
    dev = poses6.device
    factors = factors.to(dev)
    priors = None if priors is None else priors.to(dev)
    k = poses6.shape[0]
    eye6 = torch.eye(6, dtype=poses6.dtype, device=dev)
    eye = torch.eye(6 * k, dtype=poses6.dtype, device=dev)
    poses, cost = poses6, torch.zeros((), dtype=poses6.dtype, device=dev)
    for _ in range(n_iters):
        H, b, cost = _assemble(poses, factors, k, priors)
        H[anchor_index, anchor_index] += anchor_weight * eye6  # the anchor pins the gauge
        Hd = H.permute(0, 2, 1, 3).reshape(6 * k, 6 * k) + damping * eye
        delta = torch.linalg.solve(Hd, -b.reshape(6 * k)).reshape(k, 6)
        poses = poses + delta
    return poses, cost


def odometry_factors_from_tracking(tracked_poses: np.ndarray, weight: float = 1.0):
    """Consecutive between-factors of a tracked trajectory (T_i^-1 T_{i+1}
    in float64)."""
    return [(i, i + 1, np.linalg.inv(tracked_poses[i]) @ tracked_poses[i + 1], weight)
            for i in range(len(tracked_poses) - 1)]
