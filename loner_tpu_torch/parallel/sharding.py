"""Data parallelism over the window's keyframes, driven by one process.

The port of ``loner_tpu/parallel/sharding.py``. As in the JAX package, one
controller drives a mesh of devices: a :class:`Mesh` is an ndarray of
``torch.device`` with named axes, in the shape of ``jax.sharding.Mesh``, and
a device may appear in it more than once (``["cpu"] * 8`` in the tests,
``["cuda:0"] * 4`` on one card), which no process group allows.

The state lives once, on the mesh's first device. Each step splits the
window's keyframe axis into contiguous blocks, one a device, and hands the
parameters to each device inside the autograd graph, so that the gradients
of every block arrive summed at the state and Adam runs once
(``mapping/optimizer.py::make_mesh_train_step``). A reduction across devices
is a copy to the first device and a sum in mesh order: deterministic on the
CPU and on one card.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.mapping.optimizer import make_mesh_train_step, split_window, tree_map


class Mesh:
    """An ndarray of devices with one name per axis. ``devices`` may be any
    nested list of devices or device strings; repeats are allowed."""

    def __init__(self, devices, axis_names: Sequence[str]):
        names = np.asarray(devices, dtype=object)
        flat = [resolve_device(d) for d in names.ravel()]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(names.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a mesh of shape {self.devices.shape}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first_device(self) -> torch.device:
        """Where the state lives and the loss and Adam run."""
        return self.devices.flat[0]

    def along(self, axis: str) -> list:
        """The devices along ``axis``, each the first of its slice of the
        other axes."""
        arr = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(arr.reshape(arr.shape[0], -1)[:, 0])


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", device="cuda") -> Mesh:
    """A 1-D mesh of the first ``n_devices`` cards (all of them when None);
    raises when fewer exist. With ``device="cpu"`` the mesh is the CPU
    ``n_devices`` times (once when None)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh([dev] * (n_devices or 1), (axis,))
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count:
        raise RuntimeError(f"make_mesh({n_devices}): only {count} CUDA device(s)")
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis,))


def replicate_to_mesh(tree, mesh: Mesh):
    """``tree`` for the mesh: its leaves on the mesh's first device, where a
    step hands them to the other devices (a leaf already there is itself)."""
    return tree_map(lambda t: t.to(mesh.first_device), tree)


def shard_window(window, mesh: Mesh, axis: str = "data") -> list:
    """A window's keyframe axis in contiguous blocks, one per device along
    ``axis``, each on its device. The window size must be divisible by the
    axis's size (the split of ``mapping/optimizer.py::split_window``, which
    the sharded step uses)."""
    return [block for _, _, block in split_window(window, mesh.along(axis))]


def make_sharded_train_step(cfg, cube, mesh: Mesh, axis: str = "data", apply_updates: bool = True,
                            generator: Optional[torch.Generator] = None):
    """The DP train step ``step(state, window, flags, pose_mask, iteration,
    draws=None) -> (new_state, aux)``: the state on the mesh's first device,
    the window's keyframe axis split over ``axis``. A window that the axis
    does not divide runs whole on the first device. Without ``draws`` the
    step draws from ``generator`` (one seeded with 0 on the first device
    when None). The caller's state is never changed in place."""
    step = make_mesh_train_step(cfg, cube, [(d,) for d in mesh.along(axis)], generator, apply_updates)

    def sharded_step(state, window, flags, pose_mask, iteration, draws=None):
        return step(replicate_to_mesh(state, mesh), window, flags, pose_mask, iteration, draws)

    sharded_step.generator = step.generator
    return sharded_step
