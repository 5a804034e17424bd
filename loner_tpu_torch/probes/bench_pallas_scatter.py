"""Row scatter-add throughput: the port of ``scripts/bench_pallas_scatter.py``
(P1).

Scatter-adds N rows of 16 f32 into a (T, 16) table: by ``index_add_`` in f32
(the script's XLA reference) and by the ``row_scatter_add`` kernel with 1 or
2 f32 shadow copies or 4 or 8 bf16 ones. Prints each variant's error against
the reference (max abs difference over the reference's largest entry) and
its time per call. A variant is timed over ITERS chained calls after its
first (checked) call: each call's updates depend on the last call's output,
as in the script.

    python -m loner_tpu_torch.probes.bench_pallas_scatter [--device cuda]
"""
from __future__ import annotations

import argparse

import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.ops import gather_scatter as gs
from loner_tpu_torch.probes.timing import counts, device_name, launches, record, time_ms

SEED = 0  # the seed of every input
T = 65536
N = 262144
W = 16
ITERS = 6
VARIANTS = (  # (shadow copies, accumulator type, label)
    (1, torch.float32, "row_scatter_add 1-shadow f32"),
    (2, torch.float32, "row_scatter_add 2-shadow f32"),
    (4, torch.bfloat16, "row_scatter_add 4-shadow bf16"),
    (8, torch.bfloat16, "row_scatter_add 8-shadow bf16"),
)


def _chained_ms(f, upd, first_out, dev) -> float:
    """ms per call over ITERS calls, each on updates nudged by the last
    call's first output entry."""
    state = {"out": first_out}

    def call():
        state["out"] = f(upd + state["out"].reshape(-1)[0] * 1e-12)

    return time_ms(call, dev, iters=ITERS, warmup=0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N, help="rows scattered")
    ap.add_argument("--t", type=int, default=T, help="table rows")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    before = counts([gs.row_scatter_add])

    gen = torch.Generator(device=dev).manual_seed(SEED)
    idx = torch.randint(0, args.t, (args.n,), generator=gen, device=dev, dtype=torch.int32)
    upd = torch.randn((args.n, W), generator=gen, device=dev)
    idx64 = idx.long()

    def index_add(u):
        return torch.zeros((args.t, W), device=dev).index_add_(0, idx64, u)

    print(f"{device_name(dev)}: N={args.n} rows of {W} f32 into T={args.t}")
    legs = {}
    ref = index_add(upd)
    scale = float(ref.abs().max())
    ms = _chained_ms(index_add, upd, ref, dev)
    record(legs, "index_add_ f32", ms=ms, ns_per_row=ms * 1e6 / args.n)
    for nshadow, acc, label in VARIANTS:
        def run(u, nshadow=nshadow, acc=acc):
            return gs.row_scatter_add(idx, u, args.t, nshadow, acc)

        out = run(upd)
        err = float((out - ref).abs().max()) / scale
        ms = _chained_ms(run, upd, out, dev)
        record(legs, label, rel_err=err, ms=ms, ns_per_row=ms * 1e6 / args.n)
    return {"device": device_name(dev), "legs": legs, "launches": launches([gs.row_scatter_add], before)}


if __name__ == "__main__":
    main()
