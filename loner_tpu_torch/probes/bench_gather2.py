"""Chained gathers and scatter-adds: the port of ``scripts/bench_gather2.py``
(P6).

Each leg runs K dependent iterations (the next indices come from the last
output), once to warm up and once timed; it reports ms per iteration. The
plain PyTorch legs are the script's XLA legs (row gather, column gather of
the transposed table, ``index_add_``); the kernel leg is its Pallas lane
gather at one flagship level's volume, ``lane_gather`` on an (N/128, 128)
table, held against the same chain run with the plain ``torch.gather``.

    python -m loner_tpu_torch.probes.bench_gather2 [--device cuda]
"""
from __future__ import annotations

import argparse

import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.ops import gather_scatter as gs
from loner_tpu_torch.probes.timing import chained_ms, counts, device_name, launches, record

SEED = 0  # the seed of every input
K = 8  # chained iterations
N = 2_359_296
T = 65536  # a power of two: indices wrap with & (T - 1)
LANES = 128


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N, help="lookups per iteration (a multiple of 128)")
    ap.add_argument("--t", type=int, default=T, help="table rows (a power of two)")
    args = ap.parse_args(argv)
    n, t = args.n, args.t
    dev = resolve_device(args.device)
    before = counts([gs.lane_gather])

    gen = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.randn((t, 8), generator=gen, device=dev)
    idx0 = torch.randint(0, t, (n,), generator=gen, device=dev)
    table_t = table.T.contiguous()
    upd = torch.randn((n, 16), generator=gen, device=dev)
    rows = n // LANES
    tabl = torch.randn((rows, LANES), generator=gen, device=dev)
    li0 = torch.randint(0, LANES, (rows, LANES), generator=gen, device=dev, dtype=torch.int32)
    print(f"{device_name(dev)}: N={n} T={t} K={K}")
    legs = {}

    def chain_gather():
        idx, acc = idx0, torch.zeros((n, 8), device=dev)
        for _ in range(K):
            r = table[idx]
            acc = acc + r
            idx = (idx + r[:, 0].to(torch.int64)) & (t - 1)
        return acc

    def chain_gather_t():
        idx, acc = idx0, torch.zeros((8, n), device=dev)
        for _ in range(K):
            r = table_t[:, idx]
            acc = acc + r
            idx = (idx + r[0].to(torch.int64)) & (t - 1)
        return acc

    def chain_scatter():
        idx, acc = idx0, torch.zeros((t, 16), device=dev)
        for _ in range(K):
            acc = acc.index_add(0, idx, upd)
            idx = (idx + acc[0, 0].to(torch.int64)) & (t - 1)
        return acc

    def chain_lane(gather):
        def chain():
            idx, acc = li0, torch.zeros((rows, LANES), device=dev)
            for _ in range(K):
                g = gather(tabl, idx)
                acc = acc + g
                idx = (idx + g.to(torch.int32)) % LANES
            return acc
        return chain

    for name, chain in (
        (f"row-gather {n / 1e6:.2f}M x 8 f32 (chained)", chain_gather),
        ("col-gather (8, T)[:, idx] (chained)", chain_gather_t),
        (f"scatter-add index_add {n / 1e6:.2f}M x 16 f32 (chained)", chain_scatter),
    ):
        ms, _ = chained_ms(chain, dev, K)
        record(legs, name, ms_per_iter=ms)
    ms, acc = chained_ms(chain_lane(gs.lane_gather), dev, K)
    ref = chain_lane(gs.lane_gather_ref)()
    record(legs, f"lane_gather {n / 1e6:.2f}M elems (chained)", ms_per_iter=ms,
           max_abs_err=float((acc - ref).abs().max()), equal=bool(torch.equal(acc, ref)))
    return {"device": device_name(dev), "legs": legs, "launches": launches([gs.lane_gather], before)}


if __name__ == "__main__":
    main()
