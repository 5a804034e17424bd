"""The device a constructor or entry point of the port puts its tensors on."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
