"""The traced run: ``torch.profiler`` traces of a stretch of the cell's work,
reduced to what the per-layer readers and the breakdown read.

Each trace is written as a Chrome trace under the checkout's
``build/benchmark/``, read back and deleted. A device trace (CUDA activity
alone, so that the host runs at its untraced pace) gives the busy time as
the union of the device's intervals (kernels, copies, fills) over the
stretch, whose length is the host clock's around it, and each kernel's
summed time and launches. A host trace (CPU and CUDA activity) names each
idle gap between device intervals by the innermost host event running at
the gap's middle ("python" where none was; gaps under 20 us are counted
together as launch latency); the host's own profiling widens those gaps.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.traced_window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_SHORT_GAP_US = 20.0  # shorter gaps are launch latency, counted together


@dataclass
class TraceSummary:
    window_s: float  # the traced window's length
    busy_s: float  # union of device intervals inside it
    kernel_s: Dict[str, float] = field(default_factory=dict)  # device seconds by kernel name
    kernel_count: Dict[str, int] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)  # idle seconds by what the host ran

    def time_of(self, substring: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds ``substring``."""
        names = [k for k in self.kernel_s if substring in k]
        return sum(self.kernel_s[k] for k in names), sum(self.kernel_count[k] for k in names)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v] for k, v in ops], "idle_gaps": [[k[:160], v] for k, v in gaps]}


@contextlib.contextmanager
def traced(out_dir: Path, use_cuda: bool, host: bool):
    """Profile the block (with ``host``, the CPU's activity too); yields a
    list that holds the :class:`TraceSummary` afterwards."""
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    acts = ([ProfilerActivity.CPU] if host or not use_cuda else []) + ([ProfilerActivity.CUDA] if use_cuda else [])
    holder: List[TraceSummary] = []
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW_SPAN):
            yield holder
        window_s = time.perf_counter() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"trace.{os.getpid()}.json"  # read and removed at once; one a process
    prof.export_chrome_trace(str(path))
    holder.append(summarise(json.loads(path.read_text()), window_s))
    path.unlink()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarise(trace: dict, window_s: float) -> TraceSummary:
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    win: Optional[Tuple[float, float]] = None
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0.0))
        if e.get("name") == WINDOW_SPAN and cat == "user_annotation":
            win = (ts, ts + dur)
        elif cat in _DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", "")))
        elif cat in _HOST_CATS:
            host.append((ts, ts + dur, e.get("name", "")))
    if win is not None:
        dev = [(max(a, win[0]), min(b, win[1]), n) for a, b, n in dev if b > win[0] and a < win[1]]
    kernel_s: Dict[str, float] = defaultdict(float)
    kernel_count: Dict[str, int] = defaultdict(int)
    for a, b, n in dev:
        kernel_s[n] += (b - a) * 1e-6
        kernel_count[n] += 1
    merged = _union([(a, b) for a, b, _ in dev])
    busy = sum(b - a for a, b in merged)
    idle: Dict[str, float] = defaultdict(float)
    if win is not None and host:
        host.sort()
        starts = [h[0] for h in host]
        edges = [win[0]] + [x for ab in merged for x in ab] + [win[1]]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            if b - a < _SHORT_GAP_US:
                idle[f"gaps under {_SHORT_GAP_US:.0f} us"] += (b - a) * 1e-6
                continue
            mid = 0.5 * (a + b)
            best = None
            end = bisect.bisect_right(starts, mid)
            for h in host[max(0, end - 400):end]:
                if h[0] <= mid <= h[1] and (best is None or h[1] - h[0] < best[1] - best[0]):
                    best = h
            idle[best[2] if best else "python"] += (b - a) * 1e-6
    return TraceSummary(window_s, busy * 1e-6, dict(kernel_s), dict(kernel_count), dict(idle))
