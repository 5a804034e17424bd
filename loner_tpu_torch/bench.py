"""Mapper throughput at the reference operating point: the port of
``bench.py``.

Runs the flagship train step (a window of 8 keyframes x (512 lidar + 64
sky) rays = 4608 rays a step, 512 samples a ray, occupancy-guided sampling)
and reports iterations per second for two variants:

  * joint (poses get gradients through the rays): the reference's steady
    phase, 50 joint steps per keyframe. The headline number.
  * frozen (poses fixed): the first keyframe's burn-in phase.

Each variant runs the occupancy update on every 10th step. Both flag
variants are warmed first; the rate is the median of 3 passes of 40 steps,
each pass between two ``torch.cuda.synchronize()``. The joint step does
strictly more work than the frozen one, so a joint rate over 1.05x the
frozen one is a timing artefact and is measured again (twice at most).
Device-busy ms per joint step (``torch.profiler``, five steps) is printed on
an earlier line: the host clock of a shared machine moves between runs.

The last line is one JSON object: ``metric``, ``value`` (joint it/s),
``unit`` (which carries the frozen rate) and ``vs_baseline`` (joint against
the reference's real-time budget of 50 steps per 3 s keyframe).

    python -m loner_tpu_torch.bench [--device cpu --keyframes 2 ...]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import List, Optional

import torch

from loner_tpu_torch.device import resolve_device

REALTIME_FLOOR_ITS_PER_SEC = 50.0 / 3.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _measure(step, state, window, flags, mask, dev, n_iters: int = 40, n_passes: int = 3):
    """(median it/s over ``n_passes`` passes of ``n_iters`` steps, state,
    steps run), both flag variants warmed first."""
    occ_true = flags._replace(do_occ_update=True)
    for f in (flags, occ_true):
        state, _ = step(state, window, f, mask, 0)
    _sync(dev)
    rates = []
    for _ in range(n_passes):
        t0 = time.perf_counter()
        for i in range(n_iters):
            state, _ = step(state, window, occ_true if i % 10 == 9 else flags, mask, i)
        _sync(dev)
        rates.append(n_iters / (time.perf_counter() - t0))
    return statistics.median(rates), state, 2 + n_passes * n_iters


def _device_busy_ms(step, state, window, flags, mask, n_steps: int = 5) -> float:
    """Device time per joint step (``torch.profiler``, after one unrecorded
    step): the sum of the device's kernel time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n_steps), acc_events=True) as prof:
        for i in range(n_steps + 1):
            state, _ = step(state, window, flags, mask, i)
            torch.cuda.synchronize()
            prof.step()
    # each kernel's time is the self device time of the host operator that
    # launched it, so the host operators' sum is the busy time
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CPU) / 1e3 / n_steps


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m loner_tpu_torch.bench")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    # the flagship's sizes (__graft_entry__._flagship), cut only by tests
    ap.add_argument("--keyframes", type=int, default=8)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--azimuth", type=int, default=512)
    ap.add_argument("--pad-to", type=int, default=16384)
    ap.add_argument("--sky", type=int, default=1024)
    ap.add_argument("--rays-per-kf", type=int, default=512)
    ap.add_argument("--sky-rays-per-kf", type=int, default=64)
    ap.add_argument("--samples", type=int, default=512)
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    """Measure, print, and return the rates (it/s), the device-busy ms per
    joint step (None off the card) and the number of train steps run."""
    args = _parser().parse_args(argv)
    from loner_tpu_torch.flagship import flagship
    from loner_tpu_torch.mapping.optimizer import MapperConfig, TrainStepFlags, make_train_step

    dev = resolve_device(args.device)
    base = MapperConfig(window_size=args.keyframes, rays_per_kf=args.rays_per_kf,
                        sky_rays_per_kf=args.sky_rays_per_kf, n_samples_train=args.samples)
    cfg, cube, state, window = flagship(dev, cfg=base, n_keyframes=args.keyframes, n_channels=args.channels,
                                        n_azimuth=args.azimuth, pad_to=args.pad_to, n_sky=args.sky)
    step = make_train_step(cfg, cube, dev, torch.Generator(device=dev).manual_seed(0))
    frozen_flags = TrainStepFlags(freeze_sigma=False, freeze_rgb=True, freeze_poses=True, do_occ_update=False)
    joint_flags = frozen_flags._replace(freeze_poses=False)
    no_mask = torch.zeros((cfg.max_keyframes,), device=dev)
    all_mask = torch.ones((cfg.max_keyframes,), device=dev)
    all_mask[0] = 0.0  # the first keyframe is anchored

    frozen_rate, state, n_frozen = _measure(step, state, window, frozen_flags, no_mask, dev)
    joint_rate, state, n_joint = _measure(step, state, window, joint_flags, all_mask, dev)
    steps = n_frozen + n_joint
    for _ in range(2):
        if joint_rate <= frozen_rate * 1.05:
            break
        joint_rate, state, n = _measure(step, state, window, joint_flags, all_mask, dev)
        steps += n

    busy_ms = None
    if dev.type == "cuda":
        busy_ms = _device_busy_ms(step, state, window, joint_flags, all_mask)
        steps += 6
        print(f"[bench] device busy {busy_ms:.3f} ms per joint step (torch.profiler, 5 steps) on "
              f"{torch.cuda.get_device_name(dev)}; joint {1e3 / joint_rate:.3f} ms, frozen "
              f"{1e3 / frozen_rate:.3f} ms per step (host clock)")
    else:
        print("[bench] device busy: not measured (no card: a CPU run times PyTorch's CPU kernels)")

    rays = args.keyframes * (args.rays_per_kf + args.sky_rays_per_kf)
    print(json.dumps({
        "metric": "mapper_iterations_per_sec_joint",
        "value": round(joint_rate, 2),
        "unit": (f"it/s ({rays} rays x {args.samples} samples, pose grads ON; "
                 f"pose-frozen variant: {round(frozen_rate, 2)} it/s)"),
        "vs_baseline": round(joint_rate / REALTIME_FLOOR_ITS_PER_SEC, 2),
    }))
    return {"joint_its_per_s": joint_rate, "frozen_its_per_s": frozen_rate, "device_busy_ms": busy_ms,
            "train_steps": steps, "device": str(dev)}


if __name__ == "__main__":
    main()
