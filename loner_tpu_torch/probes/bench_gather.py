"""Random row gathers and scatter-adds at the hash encoder's shapes: the port
of ``scripts/bench_gather.py`` (P2).

The plain PyTorch legs are the script's XLA legs (indexing, the loop over
levels, the flat take, the transposed gather, ``index_add_``, sorted
indices); the kernel legs are its three Pallas legs: ``row_gather`` (the
script's ``take_along_axis`` on axis 0 and ``jnp.take``, one function) and
``col_gather`` (``take_along_axis`` along the lanes of the transposed
table). Each kernel leg is held against ``table[idx]`` (or ``table_t[:, idx]``)
and must equal it. Each leg is timed over ITERS calls after one warm-up call
(a kernel leg's warm-up is its checked call).

    python -m loner_tpu_torch.probes.bench_gather [--device cuda] [--n N] [--t T] [--w W] [--levels L]
"""
from __future__ import annotations

import argparse

import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.ops import gather_scatter as gs
from loner_tpu_torch.probes.timing import counts, device_name, launches, record, time_ms

SEED = 0  # the seed of every input
ITERS = 10
WRAPPERS = (gs.row_gather, gs.col_gather)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2_359_296)  # 4608 rays x 512 samples
    ap.add_argument("--t", type=int, default=65536)
    ap.add_argument("--w", type=int, default=8)
    ap.add_argument("--levels", type=int, default=16)
    args = ap.parse_args(argv)
    n, t, w, n_levels = args.n, args.t, args.w, args.levels
    dev = resolve_device(args.device)
    before = counts(WRAPPERS)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.randn((t, w), generator=gen, device=dev)
    tables = torch.randn((n_levels, t, w), generator=gen, device=dev)
    idx = torch.randint(0, t, (n,), generator=gen, device=dev, dtype=torch.int32)
    idxs = torch.randint(0, t, (n_levels, n), generator=gen, device=dev)
    rows = torch.randn((n, w), generator=gen, device=dev)
    table_t = table.T.contiguous()
    idx64 = idx.long()
    idx_sorted = torch.sort(idx64).values
    cols = torch.arange(w, device=dev)

    print(f"{device_name(dev)}: n={n} t={t} w={w} L={n_levels}; one-level gather out={n * w * 4 / 1e6:.0f} MB")
    legs = {}

    def plain(name, fn):
        record(legs, name, ms=time_ms(fn, dev, iters=ITERS))

    def loop_levels():
        acc = torch.zeros((n, w), device=dev)
        for lvl in range(n_levels):
            acc = acc + tables[lvl][idxs[lvl]]
        return acc

    plain("rows table[idx] (1 level)", lambda: table[idx64])
    plain("rows x L (loop, acc)", loop_levels)
    plain("take flat (1 level)", lambda: table.reshape(-1)[idx64[:, None] * w + cols[None, :]])
    plain("cols transposed table_t[:, idx] (1 level)", lambda: table_t[:, idx64])
    plain("scatter rows index_add_ (1 level)", lambda: torch.zeros((t, w), device=dev).index_add_(0, idx64, rows))
    plain("rows sorted idx", lambda: table[idx_sorted])
    plain("scatter rows sorted idx", lambda: torch.zeros((t, w), device=dev).index_add_(0, idx_sorted, rows))
    plain("take 1-wide (1 level)", lambda: table.reshape(-1)[idx64 * w])

    ref_rows, ref_cols = table[idx64], table_t[:, idx64]
    for name, fn, ref in (
        ("row_gather (take_along_axis ax0)", lambda: gs.row_gather(table, idx), ref_rows),
        ("col_gather (take_along lanes)", lambda: gs.col_gather(table_t, idx), ref_cols),
        ("row_gather (jnp.take rows)", lambda: gs.row_gather(table, idx), ref_rows),
    ):
        out = fn()
        err = float((out - ref).abs().max())
        record(legs, name, max_abs_err=err, equal=bool(torch.equal(out, ref)),
               ms=time_ms(fn, dev, iters=ITERS, warmup=0))
    return {"device": device_name(dev), "legs": legs, "launches": launches(WRAPPERS, before)}


if __name__ == "__main__":
    main()
