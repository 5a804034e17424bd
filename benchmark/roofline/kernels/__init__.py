"""The program's kernels, one module a kernel: ``kernels/<kernel>.py``.

A kernel's module holds:

* ``TRACE_NAME``: its name in a device trace (a ``__global__`` function of
  ``loner_tpu_torch/csrc/``; a trace's name holds it);
* ``COUNTER``: ``"<module>:<attribute>"``, the port's function whose
  ``launches`` counts its launches;
* ``shape(field)``: what it runs at under the configuration's ``field``
  block, and ``counts(n, *shape)``: (bytes, FLOPs) of one launch over ``n``
  points. Bytes count each input read once and each output written once,
  whatever the kernel reads again; FLOPs the arithmetic the algorithm needs.

A kernel whose module has no ``counts`` is counted but has no roofline.
"""
from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


def names() -> List[str]:
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")


def load(kernel: str) -> ModuleType:
    if kernel not in names():
        raise LookupError(f"kernel {kernel!r}: no module benchmark/roofline/kernels/{kernel}.py")
    return importlib.import_module(f"{__name__}.{kernel}")


def counters() -> Dict[str, object]:
    """Each kernel's launch counter in the program, by kernel name."""
    out = {}
    for kernel in names():
        module, attr = load(kernel).COUNTER.split(":")
        out[kernel] = getattr(importlib.import_module(module), attr)
    return out
