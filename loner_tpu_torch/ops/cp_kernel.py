"""CP feature-line encode: kernels B1 (forward) and B2 (backward).

The port of ``loner_tpu/ops/cp_kernel.py``. Per level l and axis a, a
feature line ``(res_l, F)`` is linearly interpolated at the point's a
coordinate; the level's features are the product of the three axis features.

Layouts are the JAX package's: points ``(3, N)`` f32 in [0, 1], lines
``(3L, F, 128)`` f32 level-major ([lvl0_x, lvl0_y, lvl0_z, lvl1_x, ...]) with
rows padded to 128 (res <= 128; padded rows stay zero and get no gradient),
features ``(L*F, N)`` f32.

* :func:`cp_fwd` / :func:`cp_bwd` are the kernel wrappers (CUDA source in
  ``csrc/cp_kernel.cu``, replacing ``loner_tpu/ops/cp_kernel.py::_fwd_kernel``
  and ``::_bwd_kernel``). Each takes its plain version for a CPU tensor and
  launches its kernel for a CUDA tensor; ``launches`` counts the launches.
  :func:`cp_bwd_plan` sizes B2's launch and refuses lines it cannot take.
* :func:`cp_encode_ref` / :func:`cp_bwd_ref` are the plain versions. The plain
  backward is written by hand after ``_bwd_kernel``, not taken from autograd:
  ``dpts`` is zero outside the open interval 0 < x < 1.
* :func:`cp_encode_t` is the differentiable encode (``torch.autograd.Function``).
* :func:`cp_fwd_gather` computes the forward by another design (CUDA source in
  ``csrc/cp_gather.cu``, replacing the lane-gather probe's
  ``scripts/bench_lane_gather.py::_gather_fwd_kernel``); its plain version
  :func:`cp_fwd_gather_ref` is :func:`cp_encode_ref`.

``mm`` ("f32" | "bf16") is the JAX package's knob for the backward's one
product: with "bf16", ``g * feat_b * feat_c`` and the two hat weights are
rounded to bf16 before they multiply into ``dlines``; ``dpts`` and the
forward stay exact f32.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.ops import kernels

CP_PAD_R = 128  # padded line length


def _check_mm(mm: str) -> bool:
    if mm not in ("f32", "bf16"):
        raise ValueError(f"unknown cp matmul mode {mm!r}")
    return mm == "bf16"


def init_cp_lines(
    generator: torch.Generator,
    resolutions: Sequence[int],
    n_features: int,
    device="cuda",
) -> torch.Tensor:
    """(3L, F, 128) f32 lines; active rows 1 + 0.1*N(0,1), padded rows zero."""
    device = resolve_device(device)
    out = torch.zeros((3 * len(resolutions), n_features, CP_PAD_R), dtype=torch.float32, device=device)
    for i in range(3 * len(resolutions)):
        res = int(resolutions[i // 3])
        if res > CP_PAD_R:
            raise ValueError(f"cp resolution {res} > {CP_PAD_R}")
        vals = torch.randn((n_features, res), generator=generator, device=device)
        out[i, :, :res] = 1.0 + 0.1 * vals
    return out


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _axis_iwf(x: torch.Tensor, res: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N,) in [0,1] -> (i0 long, frac) for an res-row line."""
    pix = torch.clamp(x, 0.0, 1.0) * (res - 1)
    i0 = torch.clamp(torch.floor(pix), 0, res - 2).long()
    return i0, pix - i0.to(pix.dtype)


def cp_encode_ref(lines_t: torch.Tensor, pts_t: torch.Tensor, resolutions: Sequence[int]) -> torch.Tensor:
    """(L*F, N) features by gathers (the plain forward)."""
    outs = []
    for lvl, res in enumerate(resolutions):
        feats = []
        for a in range(3):
            line = lines_t[3 * lvl + a]  # (F, 128)
            i0, f = _axis_iwf(pts_t[a], int(res))
            v0 = line[:, i0]
            v1 = line[:, i0 + 1]
            feats.append(v0 * (1.0 - f)[None, :] + v1 * f[None, :])
        outs.append(feats[0] * feats[1] * feats[2])
    return torch.cat(outs, dim=0)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def cp_bwd_ref(
    lines_t: torch.Tensor,
    pts_t: torch.Tensor,
    g: torch.Tensor,
    resolutions: Sequence[int],
    n_features: int,
    mm: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dlines (3L, F, 128), dpts (3, N)): the plain backward, with
    ``_bwd_kernel``'s semantics."""
    bf16 = _check_mm(mm)
    f_dim = n_features
    dlines = torch.zeros_like(lines_t)
    dpts = torch.zeros_like(pts_t)
    live = (pts_t > 0.0) & (pts_t < 1.0)
    for lvl, res in enumerate(resolutions):
        gl = g[lvl * f_dim : (lvl + 1) * f_dim]  # (F, N)
        iwf, feats, diffs = [], [], []
        for a in range(3):
            line = lines_t[3 * lvl + a]
            i0, f = _axis_iwf(pts_t[a], int(res))
            v0, v1 = line[:, i0], line[:, i0 + 1]
            iwf.append((i0, f))
            feats.append(v0 * (1.0 - f)[None, :] + v1 * f[None, :])
            diffs.append(v1 - v0)
        for a in range(3):
            gother = gl * feats[(a + 1) % 3] * feats[(a + 2) % 3]  # (F, N)
            dxa = torch.sum(gother * diffs[a], dim=0) * float(res - 1)
            dpts[a] += torch.where(live[a], dxa, torch.zeros_like(dxa))
            i0, f = iwf[a]
            w_lo, w_hi = 1.0 - f, f
            if bf16:
                gother, w_lo, w_hi = _round_bf16(gother), _round_bf16(w_lo), _round_bf16(w_hi)
            dlines[3 * lvl + a].index_add_(1, i0, gother * w_lo[None, :])
            dlines[3 * lvl + a].index_add_(1, i0 + 1, gother * w_hi[None, :])
    return dlines, dpts


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_args(lines_t, pts_t, resolutions, n_features):
    n_levels = len(resolutions)
    kernels.require(pts_t, "pts_t", torch.float32)
    kernels.require(lines_t, "lines_t", torch.float32, (3 * n_levels, n_features, CP_PAD_R))
    if pts_t.dim() != 2 or pts_t.shape[0] != 3:
        raise ValueError(f"pts_t: expected (3, N), got {tuple(pts_t.shape)}")
    if lines_t.device != pts_t.device:
        raise ValueError("lines_t and pts_t lie on different devices")
    for r in resolutions:
        if not 2 <= int(r) <= CP_PAD_R:
            raise ValueError(f"cp resolution {r} outside [2, {CP_PAD_R}]")
    return (ctypes.c_int * n_levels)(*[int(r) for r in resolutions])


def cp_fwd(lines_t: torch.Tensor, pts_t: torch.Tensor, resolutions: Sequence[int], n_features: int) -> torch.Tensor:
    """(L*F, N) features: kernel B1 on CUDA, the plain forward on CPU."""
    if pts_t.device.type == "cpu":
        return cp_encode_ref(lines_t, pts_t, resolutions)
    res = _check_args(lines_t, pts_t, resolutions, n_features)
    n = pts_t.shape[1]
    out = torch.empty((len(resolutions) * n_features, n), dtype=torch.float32, device=pts_t.device)
    if n == 0:
        return out
    with torch.cuda.device(pts_t.device):
        rc = kernels.load().loner_cp_fwd(
            pts_t.data_ptr(), lines_t.data_ptr(), out.data_ptr(), n, len(resolutions), n_features,
            ctypes.cast(res, ctypes.c_void_p), kernels.stream_ptr(pts_t),
        )
    kernels.check(rc, "cp_fwd")
    cp_fwd.launches += 1
    return out


kernels.counted(cp_fwd)

# The gather-based forward of the lane-gather probe computes cp_encode_ref's
# function in its order: the same clip, floor, lerp and product.
cp_fwd_gather_ref = cp_encode_ref

_SMEM_BYTES = 232_448  # the most dynamic shared memory a block may use on an H100


def cp_fwd_gather(lines_t: torch.Tensor, pts_t: torch.Tensor, resolutions: Sequence[int], n_features: int) -> torch.Tensor:
    """(L*F, N) features by direct lookups in the padded lines held whole in
    shared memory (CUDA source ``csrc/cp_gather.cu``, replacing
    ``scripts/bench_lane_gather.py::_gather_fwd_kernel``) on CUDA; the plain
    forward on CPU. Same function as :func:`cp_fwd`."""
    if pts_t.device.type == "cpu":
        return cp_fwd_gather_ref(lines_t, pts_t, resolutions)
    res = _check_args(lines_t, pts_t, resolutions, n_features)
    if lines_t.numel() * 4 > _SMEM_BYTES:
        raise ValueError(f"lines_t: {lines_t.numel() * 4} bytes do not fit in a block's shared memory")
    if lines_t.data_ptr() % 16:
        raise ValueError("lines_t: expected 16-byte aligned storage")
    n = pts_t.shape[1]
    out = torch.empty((len(resolutions) * n_features, n), dtype=torch.float32, device=pts_t.device)
    if n == 0:
        return out
    with torch.cuda.device(pts_t.device):
        rc = kernels.load().loner_cp_gather_fwd(
            pts_t.data_ptr(), lines_t.data_ptr(), out.data_ptr(), n, len(resolutions), n_features,
            ctypes.cast(res, ctypes.c_void_p), kernels.stream_ptr(pts_t),
        )
    kernels.check(rc, "cp_fwd_gather")
    cp_fwd_gather.launches += 1
    return out


kernels.counted(cp_fwd_gather)


CP_MAX_LEVELS = 8
CP_BWD_RUN = 16  # consecutive points a B2 thread walks (fixed in csrc/cp_kernel.cu)
CP_BWD_MAX_THREADS = 256  # the kernel's __launch_bounds__
CP_BWD_CELL_POINTS = 4096  # most (level, point) cells a B2 block stages per tile


class CpBwdPlan(NamedTuple):
    """B2's launch: each of ``runs * feature_lanes`` threads walks ``run``
    consecutive points of a ``tile = runs * run`` point tile for one feature
    lane (features lane, lane + feature_lanes, ...); ``threads`` is that
    count rounded up to whole warps; ``smem_bytes`` holds the block's dlines
    (3 * sum(res) rows at a stride of F | 1 floats, padded to 16 bytes), the
    larger of the tile's cells (4 words per point and level) and its dpts
    partial sums (3 * feature_lanes + 1 floats per point; none at F = 16,
    where the sums are reduced over a half-warp by shuffles), and the next
    tile's points and the tile's live masks (4 words per point)."""

    run: int
    runs: int
    feature_lanes: int
    threads: int
    tile: int
    smem_bytes: int


def cp_bwd_plan(resolutions: Sequence[int], n_features: int) -> CpBwdPlan:
    """B2's launch for these lines; raises ``ValueError`` where they do not
    fit (more than 8 levels, a resolution outside [2, 128], or more shared
    memory than a block may have)."""
    n_levels = len(resolutions)
    if not 1 <= n_levels <= CP_MAX_LEVELS:
        raise ValueError(f"cp backward takes 1 to {CP_MAX_LEVELS} levels, got {n_levels}")
    for r in resolutions:
        if not 2 <= int(r) <= CP_PAD_R:
            raise ValueError(f"cp resolution {r} outside [2, {CP_PAD_R}]")
    if n_features < 1:
        raise ValueError(f"cp backward needs at least one feature, got {n_features}")
    lanes = min(n_features, CP_BWD_MAX_THREADS)
    run = CP_BWD_RUN
    runs = max(1, min(CP_BWD_MAX_THREADS // lanes, CP_BWD_CELL_POINTS // (run * n_levels)))
    tile = runs * run
    table = 3 * sum(int(r) for r in resolutions) * (n_features | 1)
    parts = 0 if n_features == 16 else tile * (3 * lanes + 1)
    smem = 4 * (-(-table // 4) * 4 + max(4 * n_levels * tile, parts) + 4 * tile)
    if smem > _SMEM_BYTES:
        raise ValueError(f"cp backward: {smem} bytes of shared memory for F={n_features}, "
                         f"res {tuple(resolutions)}; a block has {_SMEM_BYTES}")
    return CpBwdPlan(run, runs, lanes, -(-lanes * runs // 32) * 32, tile, smem)


def cp_bwd(
    lines_t: torch.Tensor,
    pts_t: torch.Tensor,
    g: torch.Tensor,
    resolutions: Sequence[int],
    n_features: int,
    mm: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dlines, dpts): kernel B2 on CUDA, the plain backward on CPU."""
    if pts_t.device.type == "cpu":
        return cp_bwd_ref(lines_t, pts_t, g, resolutions, n_features, mm)
    bf16 = _check_mm(mm)
    res = _check_args(lines_t, pts_t, resolutions, n_features)
    plan = cp_bwd_plan(resolutions, n_features)
    n = pts_t.shape[1]
    kernels.require(g, "g", torch.float32, (len(resolutions) * n_features, n))
    dlines = torch.zeros_like(lines_t)
    dpts = torch.empty_like(pts_t)
    if n == 0:
        return dlines, dpts
    with torch.cuda.device(pts_t.device):
        rc = kernels.load().loner_cp_bwd(
            pts_t.data_ptr(), lines_t.data_ptr(), g.data_ptr(), dlines.data_ptr(), dpts.data_ptr(),
            n, len(resolutions), n_features, ctypes.cast(res, ctypes.c_void_p), int(bf16),
            plan.runs, plan.threads, plan.smem_bytes, kernels.stream_ptr(pts_t),
        )
    kernels.check(rc, "cp_bwd")
    cp_bwd.launches += 1
    return dlines, dpts


kernels.counted(cp_bwd)


# ---------------------------------------------------------------------------
# differentiable encode
# ---------------------------------------------------------------------------


class _CPEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lines_t, pts_t, resolutions, n_features, mm):
        lines_t = lines_t.contiguous()
        pts_t = pts_t.contiguous()
        ctx.save_for_backward(lines_t, pts_t)
        ctx.cfg = (tuple(resolutions), n_features, mm)
        return cp_fwd(lines_t, pts_t, resolutions, n_features)

    @staticmethod
    def backward(ctx, g):
        lines_t, pts_t = ctx.saved_tensors
        resolutions, n_features, mm = ctx.cfg
        dlines, dpts = cp_bwd(lines_t, pts_t, g.contiguous(), resolutions, n_features, mm)
        return dlines, dpts, None, None, None


def cp_encode_t(
    lines_t: torch.Tensor,
    pts_t: torch.Tensor,
    resolutions: Sequence[int],
    n_features: int,
    mm: str = "f32",
) -> torch.Tensor:
    """(L*F, N) CP features of pts_t (3, N) in [0, 1], differentiable in
    both arguments."""
    _check_mm(mm)
    return _CPEncode.apply(lines_t, pts_t, tuple(int(r) for r in resolutions), n_features, mm)
