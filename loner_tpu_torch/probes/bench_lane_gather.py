"""Two designs of the CP forward: the port of
``scripts/bench_lane_gather.py`` (P5).

Times kernel B1 (``cp_fwd``, the CP forward of the train step) against
``cp_fwd_gather`` (the script's lane-gather forward: direct lookups in the
whole padded lines) at the flagship's 2.36M points and CP lines, each over K
chained iterations (the next points move by the last features), once to warm
up and once timed; then prints their largest difference on 2048 other points.

    python -m loner_tpu_torch.probes.bench_lane_gather [--device cuda]
"""
from __future__ import annotations

import argparse

import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.ops import cp_kernel
from loner_tpu_torch.probes.timing import chained_ms, counts, device_name, launches, record

SEED = 0  # the seed of every input
K = 8
F = 16
RESOLUTIONS = (16, 32, 64, 128)
N_CHECK = 2048
WRAPPERS = (cp_kernel.cp_fwd, cp_kernel.cp_fwd_gather)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2_359_296, help="points")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    before = counts(WRAPPERS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lines = cp_kernel.init_cp_lines(gen, RESOLUTIONS, F, device=dev)
    pts0 = torch.rand((3, args.n), generator=gen, device=dev)
    print(f"{device_name(dev)}: N={args.n}, lines {tuple(lines.shape)}, K={K}")
    legs = {}

    for name, fwd in (("cp_fwd (B1, chained)", cp_kernel.cp_fwd), ("cp_fwd_gather (chained)", cp_kernel.cp_fwd_gather)):
        def chain(fwd=fwd):
            p = pts0
            for _ in range(K):
                out = fwd(lines, p, RESOLUTIONS, F)
                p = torch.clamp(p + out[:3] * 1e-9, 0.0, 1.0)
            return p

        record(legs, name, ms_per_iter=chained_ms(chain, dev, K)[0])

    pts_s = torch.rand((3, N_CHECK), generator=torch.Generator(device=dev).manual_seed(SEED + 1), device=dev)
    a = cp_kernel.cp_fwd(lines, pts_s, RESOLUTIONS, F)
    b = cp_kernel.cp_fwd_gather(lines, pts_s, RESOLUTIONS, F)
    record(legs, "max |cp_fwd - cp_fwd_gather|", max_abs_err=float((a - b).abs().max()))
    return {"device": device_name(dev), "legs": legs, "launches": launches(WRAPPERS, before)}


if __name__ == "__main__":
    main()
