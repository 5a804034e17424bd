"""so(3)/se(3) operations on tensors.

The port of ``loner_tpu/geometry/se3.py`` for the mapper's train step: poses
are 6-vectors ``[tx, ty, tz, rx, ry, rz]`` (translation + axis-angle) or 4x4
homogeneous matrices. Everything is differentiable and batched over leading
dimensions. The quaternion, slerp and interpolation functions come with the
tracking slice.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector, (..., 3) -> (..., 3, 3)."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) by Rodrigues, with
    the series branch near 0 so that it is differentiable at the identity."""
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta_sq + _EPS**2)
    small = theta_sq < 1e-8
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / (theta_sq + _EPS**2))
    K = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3). Safe at the
    identity; near theta = pi the axis comes from the symmetric part."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    vee = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    generic_scale = torch.where(
        torch.abs(sin_theta) < 1e-6,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * sin_theta + _EPS * torch.sign(sin_theta + _EPS)),
    )
    w_generic = generic_scale[..., None] * vee

    # near pi: (R + R^T)/2 = cI + (1-c) aa^T gives |a|; off-diagonals its signs
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + _EPS), min=0.0)
    axis_abs = torch.sqrt(axis_sq)
    sym_xy = R[..., 0, 1] + R[..., 1, 0]
    sym_xz = R[..., 0, 2] + R[..., 2, 0]
    sym_yz = R[..., 1, 2] + R[..., 2, 1]
    k = torch.argmax(axis_abs, dim=-1)

    def sgn(v):
        return torch.where(v >= 0, 1.0, -1.0).to(R.dtype)

    one = torch.ones_like(sym_xy)
    signs_k0 = torch.stack([one, sgn(sym_xy), sgn(sym_xz)], dim=-1)
    signs_k1 = torch.stack([sgn(sym_xy), one, sgn(sym_yz)], dim=-1)
    signs_k2 = torch.stack([sgn(sym_xz), sgn(sym_yz), one], dim=-1)
    signs = torch.where(
        (k == 0)[..., None], signs_k0, torch.where((k == 1)[..., None], signs_k1, signs_k2)
    )
    axis = axis_abs * signs
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + _EPS)
    flip = torch.sum(axis * vee, dim=-1)
    axis = axis * torch.where(flip < 0, -1.0, 1.0).to(R.dtype)[..., None]
    w_pi = theta[..., None] * axis

    near_pi = (math.pi - theta) < 1e-2
    return torch.where(near_pi[..., None], w_pi, w_generic)


def pose_to_matrix(p: torch.Tensor) -> torch.Tensor:
    """6-vector [t, w] (..., 6) -> homogeneous matrix (..., 4, 4)."""
    return _homogeneous(exp_so3(p[..., 3:6]), p[..., 0:3])


def matrix_to_pose(T: torch.Tensor) -> torch.Tensor:
    """Homogeneous matrix (..., 4, 4) -> 6-vector (..., 6)."""
    return torch.cat([T[..., :3, 3], log_so3(T[..., :3, :3])], dim=-1)


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation and (..., 3) translation -> (..., 4, 4)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    return Ta @ Tb


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of rigid transforms (..., 4, 4), from R^T and -R^T t."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t_inv = -(Rt @ T[..., :3, 3, None])[..., 0]
    return _homogeneous(Rt, t_inv)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transforms to (..., N, 3) points."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [x, y, z, w] (..., 4) -> rotation matrix (..., 3, 3)."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion [x, y, z, w] (..., 4), w >= 0.
    Branch-free: all four Shepperd branches are computed and the one with the
    largest squared component is kept."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw_sq = torch.clamp(1.0 + tr, min=0.0) / 4.0
    qx_sq = torch.clamp(1.0 + m00 - m11 - m22, min=0.0) / 4.0
    qy_sq = torch.clamp(1.0 - m00 + m11 - m22, min=0.0) / 4.0
    qz_sq = torch.clamp(1.0 - m00 - m11 + m22, min=0.0) / 4.0

    qw = torch.sqrt(qw_sq + _EPS)
    q_w = torch.stack([(m21 - m12) / (4.0 * qw), (m02 - m20) / (4.0 * qw), (m10 - m01) / (4.0 * qw), qw], dim=-1)
    qx = torch.sqrt(qx_sq + _EPS)
    q_x = torch.stack([qx, (m01 + m10) / (4 * qx), (m02 + m20) / (4 * qx), (m21 - m12) / (4 * qx)], dim=-1)
    qy = torch.sqrt(qy_sq + _EPS)
    q_y = torch.stack([(m01 + m10) / (4 * qy), qy, (m12 + m21) / (4 * qy), (m02 - m20) / (4 * qy)], dim=-1)
    qz = torch.sqrt(qz_sq + _EPS)
    q_z = torch.stack([(m02 + m20) / (4 * qz), (m12 + m21) / (4 * qz), qz, (m10 - m01) / (4 * qz)], dim=-1)

    best = torch.argmax(torch.stack([qx_sq, qy_sq, qz_sq, qw_sq], dim=-1), dim=-1)[..., None]
    q = torch.where(best == 3, q_w, torch.where(best == 0, q_x, torch.where(best == 1, q_y, q_z)))
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0).to(q.dtype)


def slerp_rotation(R0: torch.Tensor, R1: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Geodesic interpolation between rotations; ``alpha`` (...,) broadcasts."""
    w = log_so3(R0.transpose(-1, -2) @ R1)
    return R0 @ exp_so3(w * alpha[..., None])


def interpolate_transform(T0: torch.Tensor, T1: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Lerp of the translation and slerp of the rotation; ``alpha`` (...,)
    broadcasts against the batch dimensions of T0 and T1."""
    t = T0[..., :3, 3] + (T1[..., :3, 3] - T0[..., :3, 3]) * alpha[..., None]
    R = slerp_rotation(T0[..., :3, :3], T1[..., :3, :3], alpha)
    return _homogeneous(R, t)
