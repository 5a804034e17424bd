"""Carry a JAX mapper state across to the port.

``state_from_jax`` takes the JAX package's ``MapperState`` whose leaves are
numpy arrays (``jax.tree.map(np.asarray, state)``) and returns the port's
:class:`~loner_tpu_torch.mapping.optimizer.MapperState`. Nothing of JAX or of
the JAX package is imported: the optax chains are read by structure. Each
group's chain holds one Adam state (a named tuple with ``count``, ``mu`` and
``nu``); its identity, decayed-weight and learning-rate entries hold no
arrays and map to nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.mapping.optimizer import AdamState, MapperState


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, copy=True)).to(device)


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, device) for v in x]
    return _tensor(x, device)


def _find_adam(opt):
    if all(hasattr(opt, f) for f in ("count", "mu", "nu")):
        return opt
    if isinstance(opt, (list, tuple)):
        for sub in opt:
            found = _find_adam(sub)
            if found is not None:
                return found
    return None


def _adam(opt, device) -> AdamState:
    found = _find_adam(opt)
    if found is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer chain")
    return AdamState(
        count=_tensor(found.count, device).to(torch.int32),
        mu=_tree(found.mu, device),
        nu=_tree(found.nu, device),
    )


def state_from_jax(np_state, device="cuda") -> MapperState:
    """The port's state from a JAX ``MapperState`` with numpy leaves."""
    dev = resolve_device(device)
    return MapperState(
        params=_tree(np_state.params, dev),
        poses=_tensor(np_state.poses, dev),
        opt_sigma=_adam(np_state.opt_sigma, dev),
        opt_intensity=_adam(np_state.opt_intensity, dev),
        opt_poses=_adam(np_state.opt_poses, dev),
        occ_grid=_tensor(np_state.occ_grid, dev),
        opt_occ=_adam(np_state.opt_occ, dev),
        global_step=_tensor(np_state.global_step, dev).to(torch.int32),
        skipped_steps=_tensor(np_state.skipped_steps, dev).to(torch.int32),
    )
