"""Submap-parallel training: S independent submap models train at once.

The port of ``loner_tpu/parallel/submaps_parallel.py``. States and windows
stack on a leading submap axis, as in the JAX package; where JAX vmaps the
train step over that axis and shards it over the mesh, here the submaps
split over the mesh's devices in contiguous blocks of S / N, and each device
runs its submaps' steps in turn (the kernels are ctypes launches, which have
no batching rule). The steps are enqueued without host syncs, so distinct
cards overlap. The stacked state lives on the mesh's first device; each
step hands a device its submaps' slices and stacks the new states there
again. No reduction crosses submaps. Poses stay frozen (offline submaps
train against ground truth).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.mapping.optimizer import (
    MapperConfig,
    MapperState,
    StepDraws,
    TrainStepFlags,
    draw_step,
    init_mapper_state,
    make_train_step,
    tree_map,
)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack([x.to(xs[0].device) for x in xs]), trees[0], *trees[1:])


def stack_states(states: Sequence[MapperState]) -> MapperState:
    """S per-submap states -> one state with a leading submap axis (on the
    first state's device)."""
    return _stack(list(states))


def unstack_states(stacked: MapperState, s: int) -> List[MapperState]:
    return [tree_map(lambda x: x[i], stacked) for i in range(s)]


def stack_windows(windows: Sequence):
    """S KeyFrameWindows (same shapes) -> one with a leading submap axis."""
    return _stack(list(windows))


def init_stacked_states(generator: Optional[torch.Generator], cfg: MapperConfig, n_submaps: int,
                        device="cuda") -> MapperState:
    """``n_submaps`` fresh states drawn in turn from ``generator`` (one
    seeded with 0 when None), stacked on ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return stack_states([init_mapper_state(generator, cfg, dev) for _ in range(n_submaps)])


def make_submap_parallel_step(cfg: MapperConfig, cube, mesh=None, axis: str = "data", device="cuda",
                              generator: Optional[torch.Generator] = None):
    """One step over S stacked submaps: ``step(stacked_state,
    stacked_window, flags, pose_mask, iteration, draws=None) ->
    (stacked_state, aux)``, ``draws`` a list of S :class:`StepDraws` (drawn
    in submap order from ``generator``, on the first device, when None) and
    ``aux`` each scalar entry stacked over the submaps. With ``mesh``, the
    submaps split over the devices along ``axis`` (S must be divisible by
    their number); without, they run on ``device``. Poses are frozen."""
    devs = mesh.along(axis) if mesh is not None else [resolve_device(device)]
    dev0 = devs[0]
    if generator is None:
        generator = torch.Generator(device=dev0).manual_seed(0)
    steps = {d: make_train_step(cfg, cube, d) for d in dict.fromkeys(devs)}

    def step(state: MapperState, window, flags: TrainStepFlags, pose_mask: torch.Tensor, iteration,
             draws: Optional[List[StepDraws]] = None):
        s = state.poses.shape[0]
        if s % len(devs):
            raise ValueError(f"n_submaps={s} must be divisible by the mesh's {len(devs)} devices")
        per = s // len(devs)
        flags = flags._replace(freeze_poses=True)
        states, auxes = [], []
        for i in range(s):
            d = devs[i // per]
            w_i = tree_map(lambda x: x[i].to(d), window)
            d_i = draws[i] if draws is not None else draw_step(cfg, w_i, generator, dev0)
            new, aux = steps[d](tree_map(lambda x: x[i].to(d), state), w_i, flags, pose_mask.to(d), iteration,
                                tree_map(lambda x: x.to(d), d_i))
            states.append(tree_map(lambda x: x.to(dev0), new))
            auxes.append(aux)
        aux = {k: torch.stack([a[k].to(dev0) for a in auxes]) for k, v in auxes[0].items()
               if isinstance(v, torch.Tensor) and v.dim() == 0}
        return _stack(states), aux

    step.generator = generator
    return step


def optimize_submaps_parallel(
    cfg: MapperConfig,
    cube,
    submap_windows: Sequence,  # S KeyFrameWindows (same shapes)
    submap_poses: Sequence[np.ndarray],  # S x (K, 6) ground-truth poses
    n_iterations: int = 512,
    mesh=None,
    seed: int = 0,
    occ_every: Optional[int] = None,
    device="cuda",
) -> List[MapperState]:
    """Synchronized-epoch training of S independent submap models on the
    mesh (on ``device`` without one); returns the per-submap final states.
    Submap i starts from a generator seeded with ``seed + i``; the steps
    draw from one seeded with ``seed``."""
    s = len(submap_windows)
    if s != len(submap_poses):
        raise ValueError(f"{s} submap windows but {len(submap_poses)} pose arrays")
    if mesh is not None and s % mesh.size != 0:
        raise ValueError(f"n_submaps={s} must be divisible by mesh size {mesh.devices.shape}")
    dev = mesh.first_device if mesh is not None else resolve_device(device)
    occ_every = occ_every or cfg.occ.n_iters_acc

    states = []
    for i in range(s):
        st = init_mapper_state(torch.Generator(device=dev).manual_seed(seed + i), cfg, dev)
        p6 = torch.as_tensor(np.asarray(submap_poses[i], np.float32), device=dev)
        poses = st.poses.clone()
        poses[: p6.shape[0]] = p6
        states.append(st._replace(poses=poses))
    state = stack_states(states)
    window = stack_windows([tree_map(lambda x: x.to(dev), w) for w in submap_windows])

    step = make_submap_parallel_step(cfg, cube, mesh, device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(seed))
    flags = TrainStepFlags(freeze_sigma=False, freeze_rgb=True, freeze_poses=True, do_occ_update=False)
    pose_mask = torch.zeros((cfg.max_keyframes,), device=dev)
    for it in range(n_iterations):
        occ = (it % occ_every) == occ_every - 1
        state, _ = step(state, window, flags._replace(do_occ_update=occ), pose_mask, it)
    return unstack_states(state, s)
