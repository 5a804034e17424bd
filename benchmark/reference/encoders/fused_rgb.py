"""The decoupled field's two hash grids in plain PyTorch: the sigma grid is
``fused``'s as it stands (its functions here serve ``reference/field.py``),
and the intensity grid is the same encoder at the intensity branch's sizes
(:func:`intensity_grid`)."""
from __future__ import annotations

from benchmark.reference.encoders.fused import encode, encoding_dim, flops, init  # noqa: F401

_GRID_KEYS = ("levels", "features", "log2_entries", "log2_cells", "base_resolution", "per_level_scale")


def intensity_grid(field: dict) -> dict:
    """The intensity grid as a ``fused`` field block (the ``hash_*`` keys
    from the ``intensity_*`` ones)."""
    return {f"hash_{k}": field[f"intensity_{k}"] for k in _GRID_KEYS}
