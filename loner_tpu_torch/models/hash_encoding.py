"""Multi-resolution hash-grid encoding (Instant-NGP style): the "exact"
encoder.

The port of ``loner_tpu/models/hash_encoding.py``. L levels of trilinear
feature grids, dense at coarse resolutions and spatially hashed once a
level outgrows the table:

  * level scale s_l = base_resolution * growth^l - 1, resolution ceil(s_l) + 1
  * a position x in [0, 1] maps to x * s_l + 0.5: floor -> cell, frac -> weights
  * spatial hash (x*1) xor (y*2654435761) xor (z*805459861) mod T
  * dense tight indexing while resolution^3 <= T
  * table init uniform in [-1e-4, 1e-4)

Layouts are the JAX package's: the table ``(L, F, T)``, points ``(3, N)``,
features ``(L*F, N)``. The gradient is plain autograd through the gather,
as JAX differentiates it. The config, primes and corner table here are also
what the "packed" (``ops/hash_encode_fast.py``) and "cell"
(``ops/cell_hash.py``) encoders read.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from loner_tpu_torch.device import resolve_device

_PRIMES = (1, 2654435761, 805459861)

# the 8 corner offsets of a unit cube (8, 3): bit0 = x, bit1 = y, bit2 = z
_CORNERS = np.array([[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)], dtype=np.int64)


class HashEncodingConfig(NamedTuple):
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 18
    base_resolution: int = 16
    per_level_scale: float = 2.0

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    def level_scales(self) -> np.ndarray:
        """s_l per level (float64; the encoders round it to float32)."""
        ls = np.arange(self.n_levels, dtype=np.float64)
        return self.base_resolution * self.per_level_scale**ls - 1.0

    def level_resolutions(self) -> np.ndarray:
        return np.ceil(self.level_scales()).astype(np.int64) + 1

    def level_is_dense(self) -> np.ndarray:
        res = self.level_resolutions()
        return (res.astype(object) ** 3 <= self.table_size).astype(bool)


def f32_scale(scale: float) -> float:
    """A level scale rounded to float32, as ``jnp.float32(scale)`` multiplies:
    a float64 scale moves points across cells."""
    return float(np.float32(scale))


def init_hash_table(generator: torch.Generator, cfg: HashEncodingConfig, device="cuda") -> torch.Tensor:
    """(L, F, T) f32 feature table, uniform in [-1e-4, 1e-4)."""
    dev = resolve_device(device)
    shape = (cfg.n_levels, cfg.n_features_per_level, cfg.table_size)
    return torch.rand(shape, generator=generator, device=dev) * 2e-4 - 1e-4


def _corner_indices_t(cells: torch.Tensor, res: int, dense: bool, table_size: int) -> torch.Tensor:
    """Table index (int64) of each of the 8 corners, corner axis leading:
    cells (3, N) -> (8, N). The JAX package's uint32 hash computed in int64:
    a corner is below 2^20 and a prime below 2^32, so no product overflows,
    and the low bits of the products and XORs do not depend on the high
    ones (T is a power of two)."""
    corners = cells[None, :, :] + torch.as_tensor(_CORNERS, device=cells.device)[:, :, None]  # (8, 3, N)
    corners = torch.clamp(corners, 0, res - 1)
    if dense:
        return corners[:, 0] + corners[:, 1] * res + corners[:, 2] * (res * res)
    h = (corners[:, 0] * _PRIMES[0]) ^ (corners[:, 1] * _PRIMES[1]) ^ (corners[:, 2] * _PRIMES[2])
    return h & (table_size - 1)


def _trilinear_w(frac: torch.Tensor) -> torch.Tensor:
    """(3, N) frac -> (8, N) corner weights: the product over the axes of
    frac or 1 - frac."""
    c = torch.as_tensor(_CORNERS, dtype=frac.dtype, device=frac.device)[:, :, None]  # (8, 3, 1)
    w_axis = c * frac[None] + (1.0 - c) * (1.0 - frac[None])  # (8, 3, N)
    return w_axis[:, 0] * w_axis[:, 1] * w_axis[:, 2]


def _level_cells(pts_t: torch.Tensor, scale: float):
    """(cells int64 (3, N), frac (3, N)) of one level. The product and the
    sum round separately, as JAX computes them."""
    scaled = pts_t * f32_scale(scale) + 0.5
    cellf = torch.floor(scaled)
    return cellf.long(), scaled - cellf


def hash_encode_t(table: torch.Tensor, pts_t: torch.Tensor, cfg: HashEncodingConfig) -> torch.Tensor:
    """table (L, F, T), pts_t (3, N) in [0, 1] -> features (L*F, N), level
    major (tcnn's output layout, transposed)."""
    scales, resolutions, dense = cfg.level_scales(), cfg.level_resolutions(), cfg.level_is_dense()
    outputs = []
    for lvl in range(cfg.n_levels):
        cells, frac = _level_cells(pts_t, scales[lvl])
        idx = _corner_indices_t(cells, int(resolutions[lvl]), bool(dense[lvl]), cfg.table_size)
        feats = table[lvl][:, idx]  # (F, 8, N)
        outputs.append(torch.sum(feats * _trilinear_w(frac)[None], dim=1))  # (F, N)
    return torch.cat(outputs, dim=0)


def hash_encode(table: torch.Tensor, pts: torch.Tensor, cfg: HashEncodingConfig) -> torch.Tensor:
    """(N, 3) -> (N, L*F); use :func:`hash_encode_t` on hot paths."""
    return hash_encode_t(table, pts.T, cfg).T
