"""Small dense MLPs as plain parameter dicts.

The port of ``loner_tpu/models/mlp.py``: weights are ``(in, out)``, He-normal,
and the hot path is transposed (features leading, points minor). With
``compute_dtype="bfloat16"`` the operands are rounded to bf16 and the product
is taken in f32, which is what the JAX package's
``dot(bf16, bf16, preferred_element_type=f32)`` computes; a bf16
``torch.matmul`` would instead round its output to bf16. The f32 products must not drop to
TF32: ``mapping.optimizer.make_train_step`` sets
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default) and
the float32 matmul precision to "highest".
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from loner_tpu_torch.device import resolve_device


class MLPConfig(NamedTuple):
    in_dim: int
    out_dim: int
    hidden_dim: int = 64
    n_hidden_layers: int = 1
    activation: str = "relu"
    compute_dtype: str = "float32"


_ACTS = {"relu": torch.relu}  # the activations the ported configs use


def init_mlp(generator: torch.Generator, cfg: MLPConfig, device="cuda") -> dict:
    """He-normal init; {"w": [W0, W1, ...], "b": [b0, b1, ...]}, W (in, out)."""
    device = resolve_device(device)
    dims = [cfg.in_dim] + [cfg.hidden_dim] * cfg.n_hidden_layers + [cfg.out_dim]
    ws, bs = [], []
    for i in range(len(dims) - 1):
        std = math.sqrt(2.0 / dims[i])
        ws.append(torch.randn((dims[i], dims[i + 1]), generator=generator, device=device) * std)
        bs.append(torch.zeros((dims[i + 1],), dtype=torch.float32, device=device))
    return {"w": ws, "b": bs}


def _operand(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if bf16 else x


def round_weights(params: dict, cfg: MLPConfig) -> dict:
    """A bf16 MLP's ``params`` with its weights rounded to bf16 once, here,
    kept as ``"w_rounded"``, which :func:`mlp_apply_t` takes as they are (an
    f32 MLP's ``params`` come back unchanged). A step that hands the MLP to
    several devices rounds before the copies: each device's f32 weight
    gradient comes back through its copy, the copies' gradients sum in f32,
    and the sum rounds to bf16 once, as XLA rounds a replicated weight's
    gradient after the sum over its shards. Rounding on each device would
    round each device's gradient before the sum."""
    if cfg.compute_dtype != "bfloat16":
        return params
    return {"w_rounded": [_operand(w, True) for w in params["w"]], "b": params["b"]}


def mlp_apply_t(params: dict, x_t: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    """Transposed MLP: x_t (in_dim, N) -> (out_dim, N). ``params`` holds
    ``"w"``, or ``"w_rounded"`` from :func:`round_weights`."""
    act = _ACTS[cfg.activation]
    bf16 = cfg.compute_dtype == "bfloat16"
    rounded = "w_rounded" in params
    ws = params["w_rounded"] if rounded else params["w"]
    h = x_t
    n = len(ws)
    for i, (w, b) in enumerate(zip(ws, params["b"])):
        h = (w.T if rounded else _operand(w.T, bf16)) @ _operand(h, bf16) + b[:, None]
        if i < n - 1:
            h = act(h)
    return h
