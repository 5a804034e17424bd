"""TriadField positional encoding: CP feature lines, Fourier features and an
optional fat-row hash level.

The port of ``loner_tpu/ops/triad_field.py``: the CP term (kernels B1/B2
through :func:`loner_tpu_torch.ops.cp_kernel.cp_encode_t`), sin/cos Fourier
features, and with ``hash_levels > 0`` the fused hash encoder (kernels B4/B5
through :func:`loner_tpu_torch.ops.fused_encoder.fused_hash_encode_t`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.ops.cp_kernel import cp_encode_t, init_cp_lines
from loner_tpu_torch.ops.fused_encoder import FusedHashConfig, fused_hash_encode_t, init_fused_table


class TriadConfig(NamedTuple):
    cp_resolutions: Tuple[int, ...] = (16, 32, 64, 128)
    cp_features: int = 16
    fourier_freqs: int = 6  # per axis: sin+cos of 2^j pi p, j < fourier_freqs
    hash_levels: int = 0  # 0 disables the hash term
    hash_base_resolution: int = 512
    hash_per_level_scale: float = 2.0
    hash_log2_cells: int = 16
    hash_bwd: str = "strided"
    # with one hash level the strided backward has no level axis to thin by,
    # so the keep-stride carries the whole reduction of scattered rows
    hash_bwd_stride: int = 8
    hash_features: int = 16
    hash_save_residual: bool = True
    cp_dtype: str = "f32"  # the CP backward's product: "f32" | "bf16"

    @property
    def output_dim(self) -> int:
        d = len(self.cp_resolutions) * self.cp_features
        d += 2 * 3 * self.fourier_freqs
        d += self.hash_features * self.hash_levels
        return d

    def hash_config(self, slot_period: int = 512) -> FusedHashConfig:
        return FusedHashConfig(
            n_levels=self.hash_levels,
            log2_cells=self.hash_log2_cells,
            base_resolution=self.hash_base_resolution,
            per_level_scale=self.hash_per_level_scale,
            bwd=self.hash_bwd,
            bwd_stride=self.hash_bwd_stride,
            slot_period=slot_period,
            n_features=self.hash_features,
            save_residual=self.hash_save_residual,
        )


def init_triad(generator: torch.Generator, cfg: TriadConfig, device="cuda") -> dict:
    dev = resolve_device(device)
    params = {}
    if len(cfg.cp_resolutions) > 0:
        params["cp"] = init_cp_lines(generator, cfg.cp_resolutions, cfg.cp_features, dev)
    if cfg.hash_levels > 0:
        params["hash"] = init_fused_table(generator, cfg.hash_config(), dev)
    return params


def fourier_encode_t(pts_t: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """(2*3*J, N) sin/cos(2^j pi p) with p = 2x - 1 in [-1, 1]."""
    p = 2.0 * pts_t - 1.0
    outs = []
    for j in range(n_freqs):
        arg = p * (math.pi * (2.0**j))
        outs.append(torch.sin(arg))
        outs.append(torch.cos(arg))
    return torch.cat(outs, dim=0)


def triad_encode_t(
    params: dict,
    pts_t: torch.Tensor,
    cfg: TriadConfig,
    key: Optional[torch.Tensor] = None,
    slot_period: int = 512,
) -> torch.Tensor:
    """(output_dim, N) features of pts_t (3, N) in [0, 1]. ``key`` and
    ``slot_period`` drive the hash term's strided table gradient."""
    feats = []
    if len(cfg.cp_resolutions) > 0:
        feats.append(cp_encode_t(params["cp"], pts_t, cfg.cp_resolutions, cfg.cp_features, cfg.cp_dtype))
    if cfg.fourier_freqs > 0:
        feats.append(fourier_encode_t(pts_t, cfg.fourier_freqs))
    if cfg.hash_levels > 0:
        feats.append(fused_hash_encode_t(params["hash"], pts_t, cfg.hash_config(slot_period), key))
    return torch.cat(feats, dim=0)
