"""Hash-table tensor parallelism: the hash tables split along their cell
axis over a "model" mesh axis while the window's keyframes stay
data-parallel over "data".

The port of ``loner_tpu/parallel/tp.py``. A mesh of shape (data, model):
data row i computes its block of the window on ``devices[i, 0]``; the state
lives on the first data row, slab m of each table leaf (and of its Adam
moments) on ``devices[0, m]``, everything else on ``devices[0, 0]``. In a
step, data row i hands slab m to ``devices[i, m]``; each slab gathers the
corner rows it owns (zeros elsewhere), the partial rows are summed on the
row's compute device, where the features are blended (B4 for the triad and
FusedHash), and each slab's gradient scatters only its own rows, on its own
device. No device holds a whole split table or its gradient.

Usage::

    mesh = make_dp_tp_mesh(8, tp=2)            # 4-way data x 2-way model
    step = make_tp_train_step(cfg, cube, mesh)
    state = shard_mapper_state(state, mesh)    # tables + their Adam moments

Every encoder runs under TP, and the tables split as the JAX package splits
them, by the size of their second-to-last axis: the triad's hash level
(1, T, 8F), FusedHash (L, T, 8F) and CellHash (L, T, 16) go into slabs
along T (gathered and scattered per slab by ``ops/fused_encoder.py`` and
``ops/cell_hash.py``); the "exact" and "packed" masters (L, 2, T)
hold 2 there and stay whole on the first device, as JAX replicates them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from loner_tpu_torch.mapping.optimizer import make_mesh_train_step
from loner_tpu_torch.ops.fused_encoder import TableSlabs
from loner_tpu_torch.parallel.sharding import Mesh, make_mesh, shard_window as _shard_window

_MIN_CELLS = 4096  # smaller tables (CP lines, tiny hash levels) stay whole


@dataclass(frozen=True)
class SlabPlacement:
    """A leaf split along its cell axis (-2) into one slab per device of
    ``devices``."""

    devices: tuple


def make_dp_tp_mesh(n_devices: Optional[int] = None, tp: int = 2, device="cuda") -> Mesh:
    """A (n / tp, tp) mesh with axes ("data", "model") of :func:`make_mesh`'s
    devices."""
    devs = make_mesh(n_devices, device=device).devices
    if len(devs) % tp != 0:
        raise ValueError(f"n_devices={len(devs)} not divisible by tp={tp}")
    return Mesh(devs.reshape(len(devs) // tp, tp), ("data", "model"))


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a state tree; path holds the dict keys and
    named-tuple fields on the way down."""
    if isinstance(tree, TableSlabs):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        out = [_map_with_path(fn, t, path + ((fields[i] if fields else i),)) for i, t in enumerate(tree)]
        return type(tree)(*out) if fields else out
    return fn(path, tree)


def _placement(mesh: Mesh):
    """``placement(path, leaf)`` of :func:`mapper_state_shardings`."""
    slabs = tuple(mesh.devices[0, :]) if "model" in mesh.axis_names else (mesh.first_device,)

    def placement(path, leaf):
        if isinstance(leaf, TableSlabs):
            cells = sum(t.shape[-2] for t in leaf)
        else:
            cells = leaf.shape[-2] if leaf.dim() >= 2 else 0
        if "table" in path and cells >= _MIN_CELLS:
            if cells % len(slabs):
                raise ValueError(f"table leaf {path}: {cells} cells not divisible by the {len(slabs)} model devices")
            return SlabPlacement(slabs)
        return mesh.first_device

    return placement


def mapper_state_shardings(state, mesh: Mesh):
    """Per-leaf placements: a :class:`SlabPlacement` over the "model" axis
    for a hash-table leaf (under a "table" key, two or more axes, at least
    4096 cells on its second-to-last axis) and for its Adam moments, which
    mirror the parameter tree under the same key; the mesh's first device
    for everything else (MLPs, CP lines, poses, the occupancy grid). A table
    that the model axis does not divide raises ``ValueError``."""
    return _map_with_path(_placement(mesh), state)


def _place_leaf(leaf, where):
    """``leaf`` (a tensor or its slabs) placed as ``where`` says."""
    if isinstance(leaf, TableSlabs):
        if isinstance(where, SlabPlacement) and len(leaf) == len(where.devices):
            return TableSlabs(t.to(d) for t, d in zip(leaf, where.devices))
        leaf = torch.cat([t.to(leaf[0].device) for t in leaf], dim=-2)
    if isinstance(where, SlabPlacement):
        parts = leaf.chunk(len(where.devices), dim=-2)
        return TableSlabs(t.to(d).contiguous() for t, d in zip(parts, where.devices))
    return leaf.to(where)


def shard_mapper_state(state, mesh: Mesh):
    """``state`` with its table leaves as :class:`TableSlabs` on the model
    devices and the rest on the mesh's first device. The caller's state is
    not changed; a leaf already placed is itself."""
    placement = _placement(mesh)
    return _map_with_path(lambda path, leaf: _place_leaf(leaf, placement(path, leaf)), state)


def gather_mapper_state(state, device=None):
    """``state`` with every :class:`TableSlabs` leaf joined into one tensor
    on ``device`` (its first slab's when None); other leaves as they are."""
    def join(_, leaf):
        if isinstance(leaf, TableSlabs):
            d = leaf[0].device if device is None else torch.device(device)
            return torch.cat([t.to(d) for t in leaf], dim=-2)
        return leaf

    return _map_with_path(join, state)


def shard_window(window, mesh: Mesh) -> list:
    """The keyframe axis over "data" (each block on its row's compute
    device)."""
    return _shard_window(window, mesh, "data")


def make_tp_train_step(cfg, cube, mesh: Mesh, generator: Optional[torch.Generator] = None):
    """The DP x TP train step ``step(state, window, flags, pose_mask,
    iteration, draws=None) -> (new_state, aux)``: the state placed by
    :func:`shard_mapper_state` (a no-op once placed; the new state stays
    placed), the window's keyframes over "data", for every encoder: the
    tables :func:`mapper_state_shardings` splits go in slabs, the others
    stay whole."""
    rows = [tuple(r) for r in mesh.devices.reshape(mesh.devices.shape[0], -1)]
    step = make_mesh_train_step(cfg, cube, rows, generator)

    def tp_step(state, window, flags, pose_mask, iteration, draws=None):
        return step(shard_mapper_state(state, mesh), window, flags, pose_mask, iteration, draws)

    tp_step.generator = step.generator
    return tp_step
