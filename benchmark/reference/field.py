"""The sigma field in plain PyTorch: its encoder, the MLP and their initial
weights.

The encoder is the module ``reference/encoders/<encoder>.py`` that the
configuration's ``field`` block names, with its forward and its
hand-written backward. The sigma MLP rounds its operands to bf16 and
multiplies in f32 (so the weight gradient is rounded to bf16 too).
``lower=True`` computes the field one precision step down, as the control
of the benchmark's check: the MLP's operands rounded on to fp8 (e4m3,
scaled per tensor) and the encoder's features as its module rounds them.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference import encoders
from benchmark.reference.precision import bf16, fp8_forward


def init_mlp(gen: torch.Generator, in_dim: int, hidden: int, layers: int, out_dim: int, device) -> dict:
    """He-normal weights (in, out), zero biases."""
    dims = [in_dim] + [hidden] * layers + [out_dim]
    ws = [torch.randn((dims[i], dims[i + 1]), generator=gen, device=device) * math.sqrt(2.0 / dims[i])
          for i in range(len(dims) - 1)]
    return {"w": ws, "b": [torch.zeros((d,), device=device) for d in dims[1:]]}


def init_sigma(gen: torch.Generator, field: dict, device) -> dict:
    """The sigma branch's parameters ``{"table": ..., "mlp": ...}`` for the
    configuration's ``field`` block: the encoder's drawn first."""
    table = encoders.load(field).init(gen, field, device)
    mlp = init_mlp(gen, encoding_dim(field), field["sigma_hidden_dim"], field["sigma_hidden_layers"], 1, device)
    return {"table": table, "mlp": mlp}


def encoding_dim(field: dict) -> int:
    return encoders.load(field).encoding_dim(field)


def encode(table, pts: torch.Tensor, field: dict, lower: bool = False) -> torch.Tensor:
    """(D, N) features of points (3, N) in [0, 1]."""
    return encoders.load(field).encode(table, pts, field, lower)


def mlp_t(params: dict, x: torch.Tensor, lower: bool = False) -> torch.Tensor:
    """(out, N) of x (in, N): bf16 operands, f32 products, relu between."""
    n = len(params["w"])
    h = x
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        wo, ho = bf16(w.T), bf16(h)
        if lower:
            wo, ho = fp8_forward(wo), fp8_forward(ho)
        h = wo @ ho + b[:, None]
        if i < n - 1:
            h = torch.relu(h)
    return h


def sigma_t(params: dict, pts_cube: torch.Tensor, field: dict, lower: bool = False) -> torch.Tensor:
    """Sigma logits (N,) of cube points (3, N) in [-1, 1]."""
    h = encode(params["table"], (pts_cube + 1.0) / 2.0, field, lower)
    sigma = mlp_t(params["mlp"], h, lower)[0]
    return torch.nan_to_num(sigma, nan=0.0, posinf=3.4e38, neginf=-3.4e38)
