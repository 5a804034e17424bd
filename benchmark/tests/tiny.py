"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds, by the
cuts of the modules it runs: its driver's ``tiny(cell)`` (the mix and the
training keys) and its field module's ``tiny(config)`` (the field block)."""
from __future__ import annotations

import copy
from pathlib import Path
from types import ModuleType
from typing import Callable

from benchmark import fields
from benchmark.harness import load_cell, load_driver

CHECKOUT = Path(__file__).resolve().parents[2]


def cut_of(module: ModuleType) -> Callable:
    """The module's ``tiny``; LookupError naming its file where it brings none."""
    cut = getattr(module, "tiny", None)
    if not callable(cut):
        raise LookupError(f"{Path(module.__file__).relative_to(CHECKOUT)} brings no CPU cut (tiny)")
    return cut


def tiny_cell(name: str):
    cell = load_cell(CHECKOUT, name)
    cell.config = copy.deepcopy(cell.config)
    cell.mix = copy.deepcopy(cell.mix)
    cut_of(load_driver(cell.mix))(cell)
    cut_of(fields.load(cell.config))(cell.config)
    return cell
