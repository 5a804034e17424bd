"""Every random number a train step uses, drawn from the run's seed.

Step ``i`` of a run draws from a generator on the device seeded with
``(seed, i)``, in a fixed order, so that the reference draws the same
numbers again without anyone keeping them. Shapes are the port's
(``StepDraws``): lidar and sky indices per keyframe of the window, the
stratified and inverse-CDF uniforms per ray (half the samples each), the
occupancy update's corner uniforms per sample, and the hash encoder's two
key words.
"""
from __future__ import annotations

from typing import Dict

import torch

_MASK = (1 << 63) - 1


def sub_seed(seed: int, tag: int, index: int = 0) -> int:
    """A 63-bit seed for stream ``tag`` and item ``index`` of ``seed``."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + tag * 0xBF58476D1CE4E5B9 + index * 0x94D049BB133111EB) & _MASK
    x ^= x >> 31
    return (x * 0xD6E8FEB86659FD93) & _MASK


WEIGHTS, STEPS, RENDER, SCANS = 1, 2, 3, 4


def step_draws(seed: int, step: int, window_size: int, n_points: int, n_sky: int, rays_per_kf: int,
               sky_rays_per_kf: int, n_samples: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, STEPS, step))
    n = window_size * (rays_per_kf + sky_rays_per_kf)
    half = n_samples // 2
    return {
        "ray_idx": torch.randint(0, n_points, (window_size, rays_per_kf), generator=gen, device=device),
        "sky_idx": torch.randint(0, n_sky, (window_size, sky_rays_per_kf), generator=gen, device=device),
        "u_strat": torch.rand((n, half), generator=gen, device=device),
        "u_pdf": torch.rand((n, half), generator=gen, device=device),
        "u_occ": torch.rand((n, n_samples), generator=gen, device=device),
        "enc_key": torch.randint(0, 2**32, (2,), generator=gen, device=device),
    }
