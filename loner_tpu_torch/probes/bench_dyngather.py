"""Table lookups in a (rows, 128) slab: the port of
``scripts/bench_dyngather.py`` (P4).

For each slab size the script's two Pallas gathers, ``sublane_gather``
(``out[i, j] = tab[idx[i, j], j]``) and ``lane_gather``
(``out[i, j] = tab[i, idx[i, j]]``); then one flagship level's volume as 36
chunks of the two-stage lookup ``two_stage_gather`` over a (4096, 128) slab,
and the plain row gather of the same useful bytes. Each kernel leg is held
against its plain version and must equal it; each leg is timed over ITERS
calls after one warm-up call (a kernel leg's warm-up is its checked call).

The script draws the lane leg's indices in [0, rows), past the 128 columns
once rows > 128; here the lane leg takes those indices mod 128, as the
two-stage lookup's second stage does, so that every index is in range.

    python -m loner_tpu_torch.probes.bench_dyngather [--device cuda]
"""
from __future__ import annotations

import argparse

import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.ops import gather_scatter as gs
from loner_tpu_torch.probes.timing import counts, device_name, launches, record, time_ms

SEED = 0  # the seed of every input
ITERS = 20
ROWS = (8, 512, 4096)
R = 4096  # slab rows of the two-stage leg (T = 65,536 cells / 16 per row)
CHUNKS = 36  # (R x 128)-point chunks: one flagship level, 2.36M points
LANES = 128
WRAPPERS = (gs.sublane_gather, gs.lane_gather, gs.two_stage_gather)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, nargs="+", default=list(ROWS), help="slab sizes of the first legs")
    ap.add_argument("--r", type=int, default=R, help="slab rows of the two-stage leg")
    ap.add_argument("--chunks", type=int, default=CHUNKS)
    ap.add_argument("--n", type=int, default=2_359_296, help="points of the plain row gather")
    ap.add_argument("--t", type=int, default=65536, help="table rows of the plain row gather")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    before = counts(WRAPPERS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    print(f"{device_name(dev)}: slabs {args.rows} x {LANES}; two-stage {args.chunks} x ({args.r}, {LANES})")
    legs = {}

    def kernel_leg(name, fn, ref):
        out = fn()
        record(legs, name, max_abs_err=float((out - ref).abs().max()), equal=bool(torch.equal(out, ref)),
               ms=time_ms(fn, dev, iters=ITERS, warmup=0))

    for rows in args.rows:
        tab = torch.randn((rows, LANES), generator=gen, device=dev)
        idx = torch.randint(0, rows, (rows, LANES), generator=gen, device=dev, dtype=torch.int32)
        lane_idx = idx % LANES
        kernel_leg(f"sublane_gather rows={rows}", lambda: gs.sublane_gather(tab, idx), gs.sublane_gather_ref(tab, idx))
        kernel_leg(f"lane_gather rows={rows}", lambda: gs.lane_gather(tab, lane_idx),
                   gs.lane_gather_ref(tab, lane_idx))

    tab = torch.randn((args.r, LANES), generator=gen, device=dev)
    idxs = torch.randint(0, args.r, (args.chunks, args.r, LANES), generator=gen, device=dev, dtype=torch.int32)
    kernel_leg(f"two_stage_gather ({args.chunks} chunks, one flagship level)", lambda: gs.two_stage_gather(tab, idxs),
               gs.two_stage_gather_ref(tab, idxs))

    table_rows = torch.randn((args.t, 8), generator=gen, device=dev)
    ridx = torch.randint(0, args.t, (args.n,), generator=gen, device=dev)
    record(legs, f"plain row gather {args.n / 1e6:.2f}M x 8 f32", ms=time_ms(lambda: table_rows[ridx], dev, iters=ITERS))
    return {"device": device_name(dev), "legs": legs, "launches": launches(WRAPPERS, before)}


if __name__ == "__main__":
    main()
