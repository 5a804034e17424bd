"""The device a constructor or entry point of the port puts its tensors on."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no fallback),
    and ``cuda:<i>`` needs more than ``i`` cards."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"device {device!r} requested but CUDA has {torch.cuda.device_count()} device(s)")
    return dev


def indexed_device(base: torch.device, index: int) -> torch.device:
    """Device ``index`` of ``base``'s type: ``cuda:<index>`` when ``base`` is
    a card, the CPU for every index when it is the CPU."""
    return resolve_device(f"cuda:{index}") if base.type == "cuda" else base
