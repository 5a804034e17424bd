"""The multi-resolution hash grid as the port's FusedHash
(``encoding_impl="fused"``), with the exact table gradient: the reference
encoder knows no other."""
from __future__ import annotations

KEYS = frozenset({"hash_levels", "hash_features", "hash_log2_entries", "hash_log2_cells", "hash_base_resolution",
                  "hash_per_level_scale", "table_gradient"})


def check(field: dict) -> None:
    if field["table_gradient"] != "exact":
        raise ValueError(f"table_gradient {field['table_gradient']!r}: the reference sums the exact one only")
    cells = max(field["hash_log2_entries"] - 2, 8)
    if field["hash_log2_cells"] != cells:
        raise ValueError(f"hash_log2_cells {field['hash_log2_cells']}: FusedHash lays 2^{field['hash_log2_entries']}"
                         f" entries out as 2^{cells} cells")


def nerf_config(field: dict):
    from loner_tpu_torch.models.hash_encoding import HashEncodingConfig
    from loner_tpu_torch.models.nerf import NeRFConfig

    enc = HashEncodingConfig(n_levels=field["hash_levels"], n_features_per_level=field["hash_features"],
                             log2_hashmap_size=field["hash_log2_entries"],
                             base_resolution=field["hash_base_resolution"],
                             per_level_scale=field["hash_per_level_scale"])
    return NeRFConfig(encoding_impl="fused", encoding_bwd=field["table_gradient"], pos_encoding_sigma=enc,
                      sigma_hidden_dim=field["sigma_hidden_dim"], sigma_hidden_layers=field["sigma_hidden_layers"],
                      compute_dtype=field["compute_dtype"])


def tiny(config: dict) -> None:
    config["field"].update(hash_levels=4, hash_log2_entries=12, hash_log2_cells=10)
