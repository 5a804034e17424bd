"""The reference's encoders, one module a configuration's ``encoder``.

``encoders/<encoder>.py`` holds, for a ``field`` block that names it:

* ``init(gen, field, device)``: the encoder's parameters from the generator,
  drawn before the sigma MLP's;
* ``encoding_dim(field)``: the width of its features;
* ``encode(table, pts, field, lower)``: (D, N) features of points (3, N) in
  [0, 1], with its own backward; ``lower`` the control's rounding;
* ``flops(n, field, backward)``: the operations the step or render counts for
  ``n`` points (``roofline/counts.py``).
"""
from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import Set

HERE = Path(__file__).resolve().parent


def modules(folder: Path) -> Set[str]:
    """The names of the modules in ``folder``, its package's ``__init__`` aside."""
    return {p.stem for p in folder.glob("*.py")} - {"__init__"}


def load(field: dict) -> ModuleType:
    """The module of ``field["encoder"]``; LookupError naming its file where
    there is none."""
    enc = field.get("encoder")
    if not isinstance(enc, str) or enc not in modules(HERE):
        raise LookupError(f"encoder {enc!r}: no module benchmark/reference/encoders/{enc}.py")
    return importlib.import_module(f"{__name__}.{enc}")
