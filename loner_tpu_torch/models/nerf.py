"""Decoupled sigma/intensity neural field and its encoders.

The port of ``loner_tpu/models/nerf.py``:

  * sigma branch:      encode(pos) -> MLP (64 x 1 hidden) -> 1 logit
  * intensity branch:  encode(pos) [+ SH(viewdirs)] -> MLP (64 x 4) -> colors

``encoding_impl`` picks the encoder: "triad" (the TriadField: CP lines +
Fourier features, and a fat-row hash level when ``triad.hash_levels > 0``),
"fused" (the FusedHash per-level hash encoding), "cell" (CellHash, one row
gather per level), "packed" (the bf16 pair-packed hash grid) and any other
string the exact multi-resolution hash grid, each sized by the branch's
:class:`HashEncodingConfig`. The transposed queries keep features leading
and the point axis minor: ``query_sigma_t`` -> (N,), ``query_nerf_t`` ->
(num_colors + 1, N) rows [colors..., sigma]. With ``detach_sigma`` (the
camera phase) the sigma branch runs without gradients. The intensity
branch (its encoder, the SH encoding, its MLP and the sigmoid) records one
``loner.field.intensity`` span a query. Positions arrive in
world-cube coordinates [-1, 1]^3 and map to [0, 1]^3.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.models.hash_encoding import HashEncodingConfig, hash_encode_t, init_hash_table
from loner_tpu_torch.models.mlp import MLPConfig, init_mlp, mlp_apply_t
from loner_tpu_torch.models.sh_encoding import sh_encode_t
from loner_tpu_torch.ops.cell_hash import CellHashConfig, cell_hash_encode_t, init_cell_table
from loner_tpu_torch.ops.fused_encoder import FusedHashConfig, fused_hash_encode_t, init_fused_table
from loner_tpu_torch.ops.hash_encode_fast import hash_encode_packed_t
from loner_tpu_torch.ops.triad_field import TriadConfig, init_triad, triad_encode_t
from loner_tpu_torch.runtime.profiling import span


class NeRFConfig(NamedTuple):
    num_colors: int = 3
    enable_view_dependence: bool = True
    sh_degree: int = 4
    pos_encoding_sigma: HashEncodingConfig = HashEncodingConfig(log2_hashmap_size=18)
    pos_encoding_intensity: HashEncodingConfig = HashEncodingConfig(log2_hashmap_size=19)
    sigma_hidden_dim: int = 64
    sigma_hidden_layers: int = 1
    intensity_hidden_dim: int = 64
    intensity_hidden_layers: int = 4
    compute_dtype: str = "bfloat16"
    encoding_impl: str = "triad"  # "triad" | "fused" | "cell" | "packed" | anything else: the exact hash grid
    triad: TriadConfig = TriadConfig()
    encoding_bwd: str = "strided"  # fused: "strided" | "exact"; cell: "level1" ("strided" too) | "exact"
    encoding_bwd_stride: int = 2  # fused, strided: keep every k-th slot group
    encoding_slot_period: int = 512  # fused, strided: samples per ray (S)
    point_chunks: int = 4  # sequential point chunks of render_rays (1 = one pass)

    def _triad_for(self, enc: HashEncodingConfig) -> TriadConfig:
        """Per-branch triad config: the hash table is sized from the branch's
        encoding config (log2 18 for sigma, 19 for intensity)."""
        return self.triad._replace(hash_log2_cells=max(enc.log2_hashmap_size - 2, 8))

    def _encoding_dim(self, enc: HashEncodingConfig) -> int:
        if self.encoding_impl == "triad":
            return self._triad_for(enc).output_dim
        return enc.output_dim

    def sigma_mlp_config(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self._encoding_dim(self.pos_encoding_sigma),
            out_dim=1,
            hidden_dim=self.sigma_hidden_dim,
            n_hidden_layers=self.sigma_hidden_layers,
            compute_dtype=self.compute_dtype,
        )

    def intensity_mlp_config(self) -> MLPConfig:
        in_dim = self._encoding_dim(self.pos_encoding_intensity)
        if self.enable_view_dependence:
            in_dim += self.sh_degree**2
        return MLPConfig(
            in_dim=in_dim,
            out_dim=self.num_colors,
            hidden_dim=self.intensity_hidden_dim,
            n_hidden_layers=self.intensity_hidden_layers,
            compute_dtype=self.compute_dtype,
        )


def fused_config_from(cfg: NeRFConfig, enc: HashEncodingConfig) -> FusedHashConfig:
    """Capacity-comparable FusedHash config: 2^log2 vertices x 2 features ->
    2^(log2-2) cells x 16 features (one row per cell)."""
    return FusedHashConfig(
        n_levels=enc.n_levels,
        log2_cells=max(enc.log2_hashmap_size - 2, 8),
        base_resolution=enc.base_resolution,
        per_level_scale=enc.per_level_scale,
        bwd="strided" if cfg.encoding_bwd == "strided" else "exact",
        bwd_stride=cfg.encoding_bwd_stride,
        slot_period=cfg.encoding_slot_period,
    )


def cell_config_from(enc: HashEncodingConfig, bwd: str = "exact") -> CellHashConfig:
    """Capacity-comparable CellHash config: 2^log2 vertices x 2 features ->
    2^(log2-2) cells x 16 features."""
    return CellHashConfig(
        n_levels=enc.n_levels,
        log2_cells=max(enc.log2_hashmap_size - 2, 8),
        base_resolution=enc.base_resolution,
        per_level_scale=enc.per_level_scale,
        bwd=bwd,
    )


def _init_table(generator: torch.Generator, cfg: NeRFConfig, enc: HashEncodingConfig, device):
    impl = cfg.encoding_impl
    if impl == "triad":
        return init_triad(generator, cfg._triad_for(enc), device)
    if impl == "fused":
        return init_fused_table(generator, fused_config_from(cfg, enc), device)
    if impl == "cell":
        return init_cell_table(generator, cell_config_from(enc), device)
    return init_hash_table(generator, enc, device)


def init_nerf(generator: torch.Generator, cfg: NeRFConfig, device="cuda") -> dict:
    dev = resolve_device(device)
    return {
        "sigma": {
            "table": _init_table(generator, cfg, cfg.pos_encoding_sigma, dev),
            "mlp": init_mlp(generator, cfg.sigma_mlp_config(), dev),
        },
        "intensity": {
            "table": _init_table(generator, cfg, cfg.pos_encoding_intensity, dev),
            "mlp": init_mlp(generator, cfg.intensity_mlp_config(), dev),
        },
    }


def _sanitize_sigma(sigma: torch.Tensor) -> torch.Tensor:
    """Non-finite sigma clamped like the reference (``nerf_tcnn.py:74-78``)."""
    return torch.nan_to_num(sigma, nan=0.0, posinf=3.4e38, neginf=-3.4e38)


def _encode_t(cfg: NeRFConfig, table, pos_t: torch.Tensor, enc: HashEncodingConfig,
              key: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``key`` (two words) draws the strided table gradient's rotation
    ("triad", "fused") or turns on the corner-sampled one ("cell"); the
    training step passes fresh words each step. ``u`` (L, N) gives "cell"
    its corner uniforms instead of drawing them from ``key``. "packed"
    takes no key (its table gradient is exact), as in the JAX package."""
    impl = cfg.encoding_impl
    if impl == "triad":
        return triad_encode_t(table, pos_t, cfg._triad_for(enc), key, cfg.encoding_slot_period)
    if impl == "fused":
        return fused_hash_encode_t(table, pos_t, fused_config_from(cfg, enc), key)
    if impl == "cell":
        bwd = "level1" if cfg.encoding_bwd in ("level1", "strided") else "exact"
        return cell_hash_encode_t(table, pos_t, cell_config_from(enc, bwd), key, u)
    if impl == "packed":
        return hash_encode_packed_t(table, pos_t, enc, None)
    return hash_encode_t(table, pos_t, enc)


def query_sigma_t(params: dict, pts_cube_t: torch.Tensor, cfg: NeRFConfig,
                  key: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pts_cube_t (3, N) in [-1, 1] -> sigma logits (N,)."""
    pos = (pts_cube_t + 1.0) / 2.0
    h = _encode_t(cfg, params["sigma"]["table"], pos, cfg.pos_encoding_sigma, key, u)
    sigma = mlp_apply_t(params["sigma"]["mlp"], h, cfg.sigma_mlp_config())  # (1, N)
    return _sanitize_sigma(sigma[0])


def query_nerf_t(params: dict, pts_cube_t: torch.Tensor, viewdirs_t: Optional[torch.Tensor], cfg: NeRFConfig,
                 sigma_only: bool = False, detach_sigma: bool = True, key: Optional[torch.Tensor] = None,
                 key_intensity: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None,
                 u_intensity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transposed query: (1, N) sigma when ``sigma_only``, else
    (num_colors + 1, N) rows [colors..., sigma]. ``key`` draws the sigma
    encoder's stochastic table gradient and ``key_intensity`` the intensity
    encoder's (the JAX package folds the latter from the former,
    ``fold_in(key, 1)``; the port takes it as its own draw); ``u`` and
    ``u_intensity`` are the "cell" encoders' corner uniforms. With
    ``detach_sigma`` the sigma branch runs without gradients."""
    if sigma_only:
        return query_sigma_t(params, pts_cube_t, cfg, key, u)[None, :]
    if detach_sigma:
        with torch.no_grad():
            sigma = query_sigma_t(params, pts_cube_t, cfg, key, u)
    else:
        sigma = query_sigma_t(params, pts_cube_t, cfg, key, u)
    with span("loner.field.intensity"):
        pos = (pts_cube_t + 1.0) / 2.0
        h_x = _encode_t(cfg, params["intensity"]["table"], pos, cfg.pos_encoding_intensity, key_intensity,
                        u_intensity)
        if cfg.enable_view_dependence:
            h_x = torch.cat([h_x, sh_encode_t(viewdirs_t.T, cfg.sh_degree)], dim=0)
        color = torch.sigmoid(mlp_apply_t(params["intensity"]["mlp"], h_x, cfg.intensity_mlp_config()))  # (C, N)
    return torch.cat([color, sigma[None, :]], dim=0)


def query_nerf(params: dict, pts_cube: torch.Tensor, viewdirs: Optional[torch.Tensor], cfg: NeRFConfig,
               sigma_only: bool = False, detach_sigma: bool = True, key: Optional[torch.Tensor] = None,
               key_intensity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 3) [+ directions (N, 3)] -> (N, 1) or (N, num_colors + 1)."""
    vt = None if viewdirs is None else viewdirs.T
    return query_nerf_t(params, pts_cube.T, vt, cfg, sigma_only, detach_sigma, key, key_intensity).T
