"""Run-directory IO: what the downstream tools boot from.

The port of ``loner_tpu/runtime/run_io.py``: a run directory holds
``full_config.pkl`` (the resolved settings), ``world_cube.yaml`` and
``checkpoints/ckpt_<step>/state.pt``. The pickled settings name this
package's ``Settings`` class, so each package reads its own run directories.
"""
from __future__ import annotations

import os

import torch
import yaml

from loner_tpu_torch.config.settings import Settings
from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.geometry.world_cube import WorldCube
from loner_tpu_torch.runtime.checkpoints import latest_checkpoint, load_checkpoint


def load_run(run_dir: str, device="cuda"):
    """(cfg, cube, state) of the run directory's latest checkpoint, on
    ``device``."""
    from loner_tpu_torch.config.build import build_mapper_config
    from loner_tpu_torch.mapping.optimizer import init_mapper_state

    dev = resolve_device(device)
    settings = Settings.load_pickle(os.path.join(run_dir, "full_config.pkl"))
    with open(os.path.join(run_dir, "world_cube.yaml")) as f:
        cube = WorldCube.from_dict(yaml.safe_load(f), dev)
    cfg = build_mapper_config(settings, cube.scale_factor)
    ckpt = latest_checkpoint(os.path.join(run_dir, "checkpoints"))
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {run_dir}/checkpoints")
    template = init_mapper_state(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    state = load_checkpoint(ckpt, template)["state"]
    return cfg, cube, state
