"""LONER's decoupled field: the sigma hash grid of ``fused`` and an
intensity branch of its own (a hash grid, spherical harmonics of the view
direction, a deeper MLP and a sigmoid), both grids as the port's FusedHash
with the exact table gradient."""
from __future__ import annotations

from benchmark.fields import fused

INTENSITY_KEYS = frozenset({"intensity_levels", "intensity_features", "intensity_log2_entries", "intensity_log2_cells",
                            "intensity_base_resolution", "intensity_per_level_scale", "sh_degree",
                            "intensity_hidden_dim", "intensity_hidden_layers", "num_colors", "point_chunks"})
KEYS = fused.KEYS | INTENSITY_KEYS


def check(field: dict) -> None:
    fused.check(field)
    for key in ("levels", "features"):
        if field[f"intensity_{key}"] != field[f"hash_{key}"]:
            raise ValueError(f"intensity_{key} {field[f'intensity_{key}']} against hash_{key} {field[f'hash_{key}']}:"
                             f" B4's kernel module counts both grids' launches with one shape")
    cells = max(field["intensity_log2_entries"] - 2, 8)
    if field["intensity_log2_cells"] != cells:
        raise ValueError(f"intensity_log2_cells {field['intensity_log2_cells']}: FusedHash lays "
                         f"2^{field['intensity_log2_entries']} entries out as 2^{cells} cells")
    if not 1 <= field["sh_degree"] <= 4:
        raise ValueError(f"sh_degree {field['sh_degree']}: the port's SH encoding has degrees 1 to 4")


def nerf_config(field: dict):
    from loner_tpu_torch.models.hash_encoding import HashEncodingConfig

    enc = HashEncodingConfig(n_levels=field["intensity_levels"], n_features_per_level=field["intensity_features"],
                             log2_hashmap_size=field["intensity_log2_entries"],
                             base_resolution=field["intensity_base_resolution"],
                             per_level_scale=field["intensity_per_level_scale"])
    return fused.nerf_config(field)._replace(
        pos_encoding_intensity=enc, sh_degree=field["sh_degree"],
        intensity_hidden_dim=field["intensity_hidden_dim"], intensity_hidden_layers=field["intensity_hidden_layers"],
        num_colors=field["num_colors"], point_chunks=field["point_chunks"])


def tiny(config: dict) -> None:
    fused.tiny(config)
    config["field"].update(intensity_levels=4, intensity_log2_entries=13, intensity_log2_cells=11,
                           intensity_hidden_dim=16, point_chunks=2)
