"""Rounding in plain PyTorch: bf16 values, and the control's forward-only
roundings (fp8 e4m3 under a per-tensor scale, bf16) that pass the gradient
as it is."""
from __future__ import annotations

import torch


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def fp8_forward(x: torch.Tensor) -> torch.Tensor:
    """x's values rounded to fp8 (e4m3) under a per-tensor scale that maps
    its largest magnitude to fp8's largest (448), as an fp8 GEMM takes its
    operands; its gradient passed as it is."""
    xd = x.detach()
    scale = 448.0 / torch.clamp(torch.amax(torch.abs(xd)), min=1e-30)
    return x + ((xd * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale - xd)


def bf16_forward(x: torch.Tensor) -> torch.Tensor:
    return x + (bf16(x.detach()) - x.detach())
