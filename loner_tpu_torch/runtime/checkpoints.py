"""Checkpoints of the mapper state with ``torch.save`` / ``torch.load``.

The port of ``loner_tpu/runtime/checkpoints.py`` (which writes orbax
directories): a checkpoint is the directory ``<directory>/ckpt_<step>``
holding ``state.pt``. Named tuples are stored as plain dicts and lists of
tensors, so the file loads with ``weights_only=True``; ``load_checkpoint``
rebuilds the structure of a template.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def _plain(tree):
    """Named tuples -> dicts, numpy arrays -> tensors, recursively."""
    if hasattr(tree, "_fields"):
        return {k: _plain(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    return tree


def _restore(template, plain):
    """``plain`` in the structure of ``template``, each tensor on its
    template tensor's device."""
    if hasattr(template, "_fields"):
        return type(template)(**{k: _restore(getattr(template, k), plain[k]) for k in template._fields})
    if isinstance(template, dict):
        return {k: _restore(template[k], plain[k]) for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_restore(t, p) for t, p in zip(template, plain))
    if isinstance(template, torch.Tensor):
        return plain.to(template.device)
    return plain


def save_checkpoint(directory: str, step: int, state: Any, extras: Optional[dict] = None) -> str:
    """Save a mapper state (and host-side extras) as
    ``<directory>/ckpt_<step>/state.pt``; returns the checkpoint's path."""
    path = os.path.abspath(os.path.join(directory, f"ckpt_{step}"))
    os.makedirs(path, exist_ok=True)
    payload = {"state": _plain(state)}
    if extras:
        payload["extras"] = _plain(extras)
    torch.save(payload, os.path.join(path, STATE_FILE))
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d+)", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, name), int(m.group(1))
    return best


def load_checkpoint(path: str, template: Any) -> dict:
    """``{"state": ..., "extras": ...}`` from a checkpoint, the state rebuilt
    in the structure (and on the devices) of ``template``, a matching state
    such as a fresh ``init_mapper_state``."""
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    payload["state"] = _restore(template, payload["state"])
    return payload
