"""TriadField's CP lines and Fourier features (``encoding_impl="triad"``),
with its hash level off: the reference encoder knows no other."""
from __future__ import annotations

KEYS = frozenset({"cp_resolutions", "cp_features", "fourier_freqs", "hash_levels"})


def check(field: dict) -> None:
    if field.get("hash_levels", 0) != 0:
        raise ValueError(f"hash_levels {field['hash_levels']}: the triad reference has no hash level (0 only)")


def nerf_config(field: dict):
    from loner_tpu_torch.models.nerf import NeRFConfig
    from loner_tpu_torch.ops.triad_field import TriadConfig

    return NeRFConfig(encoding_impl="triad", sigma_hidden_dim=field["sigma_hidden_dim"],
                      sigma_hidden_layers=field["sigma_hidden_layers"], compute_dtype=field["compute_dtype"],
                      triad=TriadConfig(cp_resolutions=tuple(field["cp_resolutions"]),
                                        cp_features=field["cp_features"], fourier_freqs=field["fourier_freqs"],
                                        hash_levels=0))


def tiny(config: dict) -> None:
    """The CP lines are small at every size: nothing to cut."""
