"""Timing and reporting for the probes: CUDA events on the card, the host
clock on the CPU; one printed line and one dict entry per leg; launch counts."""
from __future__ import annotations

import time
from typing import Callable

import torch

from loner_tpu_torch.ops import kernels


def time_ms(fn: Callable[[], object], device: torch.device, iters: int = 1, warmup: int = 1) -> float:
    """ms per call of ``fn``: ``warmup`` calls, then ``iters`` calls timed
    together. On a CUDA device two CUDA events bracket the timed calls and
    the device is synchronised before they are read; on the CPU the host
    clock times them. A chained leg passes one call that runs K dependent
    iterations and divides by K."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def chained_ms(chain: Callable[[], object], device: torch.device, k: int):
    """(ms per iteration, the timed run's result) of ``chain``, a run of
    ``k`` dependent iterations: one warm-up run, then one timed run."""
    out = {}

    def run():
        out["result"] = chain()

    return time_ms(run, device, iters=1, warmup=1) / k, out["result"]


def graph_ms(fn: Callable[[], object], calls: int = 20, replays: int = 10) -> float:
    """Device ms per call with no host time in the way: ``calls`` calls of
    ``fn`` captured in one CUDA graph (after a warm-up call), replayed
    ``replays`` times between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def empty_grid(blocks: int, device: torch.device) -> None:
    """Launch an empty kernel of ``blocks`` blocks of 256 threads on
    ``device``'s current stream: what a graph node of that grid costs when
    its kernel does nothing."""
    with torch.cuda.device(device):
        kernels.check(kernels.load().loner_empty_grid(blocks, torch.cuda.current_stream(device).cuda_stream),
                      "empty_grid")


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu"."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def record(legs: dict, name: str, **values) -> None:
    """Store one leg's values under ``name`` and print them on one line."""
    legs[name] = values
    print(f"{name:48s} " + "  ".join(
        f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}" for k, v in values.items()), flush=True)


def launches(wrappers, before: dict) -> dict:
    """Each wrapper's launches since ``before`` ({name: count})."""
    return {w.__name__: w.launches - before[w.__name__] for w in wrappers}


def counts(wrappers) -> dict:
    """Each wrapper's launch count now ({name: count})."""
    return {w.__name__: w.launches for w in wrappers}
