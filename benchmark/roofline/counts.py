"""Operations and bytes of the kernels and of a whole step, from shapes.

Bytes count each input read once and each output written once, whatever a
kernel reads again. FLOPs count the arithmetic the algorithm needs. A
kernel's least time is the larger of its bytes at the HBM peak and its
f32 operations at the f32 peak; its roofline share is that least time over
the time the trace gives it. The step counts its MLP GEMMs (forward, and
the weight and input gradients) and its encoder's interpolation.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

from benchmark.reference.field import encoding_dim

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def cp_fwd(n: int, levels: int, features: int) -> Tuple[float, float]:
    """B1: points (3, N) f32 and lines (3L, F, 128) f32 in, features (LF, N)
    f32 out. Per point and level: three lerps of F features (3 FLOPs each)
    and the product of the three axes (2F)."""
    lines = 3 * levels * features * 128 * 4
    return 12.0 * n + lines + 4.0 * levels * features * n, 11.0 * levels * features * n


def cp_bwd(n: int, levels: int, features: int) -> Tuple[float, float]:
    """B2: points, lines and the features' gradient in; the lines' gradient
    and the points' gradient out. Per point and level: the forward's lerps
    again (9F) and, per axis, the other axes' product with the gradient (2F),
    its dot with the line's slope (2F) and the two hat-weighted adds (4F)."""
    lines = 3 * levels * features * 128 * 4
    return 12.0 * n + lines + 4.0 * levels * features * n + lines + 12.0 * n, 33.0 * levels * features * n


def hash_fwd(n: int, levels: int, features: int) -> Tuple[float, float]:
    """B4: points (3, N) f32 and the gathered corner rows (L, 8F, N) bf16
    in, features (LF, N) f32 out. Per point and level: the 8 trilinear
    weights (19 FLOPs) and F sums of 8 weighted corners (16F)."""
    return 12.0 * n + 2.0 * levels * 8 * features * n + 4.0 * levels * features * n, (16.0 * features + 19) * levels * n


def hash_dpts(n: int, levels: int, features: int) -> Tuple[float, float]:
    """B5: points, corner rows and the features' gradient in, (3, N) out."""
    return (12.0 * n + 2.0 * levels * 8 * features * n + 4.0 * levels * features * n + 12.0 * n,
            (16.0 * features + 19 + 48) * levels * n)


KERNELS = {"cp_fwd": cp_fwd, "cp_bwd": cp_bwd, "hash_fwd": hash_fwd, "hash_dpts": hash_dpts}
# each kernel's name in a device trace (the __global__ functions of loner_tpu_torch/csrc/)
KERNEL_NAMES = {"cp_fwd": "cp_fwd_kernel", "cp_bwd": "cp_bwd_kernel", "hash_fwd": "fused_fwd_kernel",
                "hash_dpts": "fused_dpts_kernel", "pdf_sample": "pdf_sample_kernel"}


def kernel_shape(kernel: str, field: dict) -> tuple:
    """(levels, features) a kernel runs at under the configuration's field."""
    if kernel.startswith("cp_"):
        return len(field["cp_resolutions"]), field["cp_features"]
    return field["hash_levels"], field["hash_features"]


def roofline_share(ctx, kernel: str):
    """Percent of the roofline a kernel reached in the traced stretch: the
    least time of its launches (``ctx.launches``: each size and its count)
    over its device time. None where the trace holds none of its launches."""
    if ctx.trace is None:
        return None
    seconds, n = ctx.trace.time_of(KERNEL_NAMES[kernel])
    sizes = ctx.launches.get(kernel, [])
    launches = sum(c for _, c in sizes)
    if n == 0 or seconds <= 0 or launches == 0:
        return None
    if launches != n:
        raise RuntimeError(f"{kernel}: the counter says {launches} launches, the trace holds {n}")
    shape = kernel_shape(kernel, ctx.config["field"])
    return 100.0 * sum(c * least_time(*KERNELS[kernel](p, *shape)) for p, c in sizes) / seconds


def least_time(bytes_: float, flops: float) -> float:
    return max(bytes_ / PEAKS["hbm_bytes_per_s"], flops / PEAKS["f32_flops_per_s"])


def mlp_forward_flops(n: int, field: dict) -> float:
    dims = [encoding_dim(field)] + [field["sigma_hidden_dim"]] * field["sigma_hidden_layers"] + [1]
    return 2.0 * n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def encoder_flops(n: int, field: dict, backward: bool) -> float:
    if field["encoder"] == "triad":
        lv, f = len(field["cp_resolutions"]), field["cp_features"]
        return cp_fwd(n, lv, f)[1] + (cp_bwd(n, lv, f)[1] if backward else 0.0)
    lv, f = field["hash_levels"], field["hash_features"]
    # the table gradient: 8 weights times F features a point and level
    return hash_fwd(n, lv, f)[1] + ((hash_dpts(n, lv, f)[1] + 16.0 * f * lv * n) if backward else 0.0)


def train_step_flops(n: int, field: dict) -> float:
    """Forward, weight-gradient and input-gradient GEMMs of the sigma MLP
    (three times the forward) and the encoder's forward and backward."""
    return 3.0 * mlp_forward_flops(n, field) + encoder_flops(n, field, backward=True)


def render_flops(n: int, field: dict) -> float:
    return mlp_forward_flops(n, field) + encoder_flops(n, field, backward=False)
