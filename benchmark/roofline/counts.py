"""Operations and bytes of the kernels and of a whole step, from shapes.

Each kernel's bytes and FLOPs are in its module under ``kernels/``. A
kernel's least time is the larger of its bytes at the HBM peak and its f32
operations at the f32 peak; its roofline share is that least time over the
time the trace gives it. The step counts its MLP GEMMs (forward, and the
weight and input gradients) and its encoder's interpolation, as the
encoder's reference module counts it.
"""
from __future__ import annotations

import json
from pathlib import Path

from benchmark.reference import encoders
from benchmark.reference.field import encoding_dim
from benchmark.roofline import kernels

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def roofline_share(ctx, kernel: str):
    """Percent of the roofline a kernel reached in the traced stretch: the
    least time of its launches (``ctx.launches``: each size and its count)
    over its device time. None where the trace holds none of its launches."""
    if ctx.trace is None:
        return None
    k = kernels.load(kernel)
    seconds, n = ctx.trace.time_of(k.TRACE_NAME)
    sizes = ctx.launches.get(kernel, [])
    launches = sum(c for _, c in sizes)
    if n == 0 or seconds <= 0 or launches == 0:
        return None
    if launches != n:
        raise RuntimeError(f"{kernel}: the counter says {launches} launches, the trace holds {n}")
    shape = k.shape(ctx.config["field"])
    return 100.0 * sum(c * least_time(*k.counts(p, *shape)) for p, c in sizes) / seconds


def least_time(bytes_: float, flops: float) -> float:
    return max(bytes_ / PEAKS["hbm_bytes_per_s"], flops / PEAKS["f32_flops_per_s"])


def mlp_forward_flops(n: int, field: dict) -> float:
    dims = [encoding_dim(field)] + [field["sigma_hidden_dim"]] * field["sigma_hidden_layers"] + [1]
    return 2.0 * n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def encoder_flops(n: int, field: dict, backward: bool) -> float:
    return encoders.load(field).flops(n, field, backward)


def train_step_flops(n: int, field: dict) -> float:
    """Forward, weight-gradient and input-gradient GEMMs of the sigma MLP
    (three times the forward) and the encoder's forward and backward."""
    return 3.0 * mlp_forward_flops(n, field) + encoder_flops(n, field, backward=True)


def render_flops(n: int, field: dict) -> float:
    return mlp_forward_flops(n, field) + encoder_flops(n, field, backward=False)
