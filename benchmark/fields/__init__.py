"""The field a configuration names, found by its ``field`` block's ``encoder``.

The encoder names two modules: ``fields/<encoder>.py``, which builds the
port's field from the block, and ``reference/encoders/<encoder>.py``, the
plain reference's encoder. A module here holds:

* ``KEYS``: the keys of the block it reads, beside :data:`COMMON`;
* ``check(field)``: raises ValueError for a value it cannot build as the
  block states it;
* ``nerf_config(field)``: the port's whole ``NeRFConfig``;
* ``tiny(config)``: cuts the configuration's field block, in place, to a
  size the CPU runs in seconds (``tests/tiny.py``).

:func:`load` refuses, naming the configuration, a block that the modules
cannot build, so that no cell measures another field under its name.
"""
from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType

from benchmark.reference import encoders

HERE = Path(__file__).resolve().parent
COMMON = frozenset({"encoder", "sigma_hidden_dim", "sigma_hidden_layers", "compute_dtype"})


class FieldError(ValueError):
    """A configuration's field that the benchmark cannot build."""


def load(config: dict) -> ModuleType:
    """The program's module of the configuration's field, once both modules
    are there and the module reads the whole block and can build it."""
    field, name = config["field"], config.get("name")
    enc = field.get("encoder")
    if not isinstance(enc, str) or enc not in encoders.modules(HERE):
        raise FieldError(f"configuration {name!r}: encoder {enc!r}: no module benchmark/fields/{enc}.py")
    try:
        encoders.load(field)
    except LookupError as e:
        raise FieldError(f"configuration {name!r}: {e}") from None
    mod = importlib.import_module(f"{__name__}.{enc}")
    unread = sorted(set(field) - COMMON - mod.KEYS)
    if unread:
        raise FieldError(f"configuration {name!r}: benchmark/fields/{enc}.py reads no {unread}")
    try:
        mod.check(field)
    except ValueError as e:
        raise FieldError(f"configuration {name!r}: benchmark/fields/{enc}.py: {e}") from None
    return mod
