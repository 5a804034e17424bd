"""Profiling hooks: device traces and wall-clock CSVs.

The port of ``loner_tpu/runtime/profiling.py``: ``maybe_trace`` wraps a
region in a ``torch.profiler`` trace (a Chrome trace under
``<log_dir>/profile``), and ``WindowTimer`` keeps the per-window
``timing.csv`` rows (seconds, iterations, its/s).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str], enabled: bool = True) -> Iterator[None]:
    """Trace the region with ``torch.profiler`` (CPU, and CUDA when a card is
    present) into ``<log_dir>/profile/trace.json``; a no-op when disabled or
    when ``log_dir`` is None."""
    if not enabled or log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    trace_dir = os.path.join(log_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class WindowTimer:
    """Per-optimization-window wall-clock log (``timing.csv`` rows)."""

    def __init__(self) -> None:
        self.rows: List[tuple] = []  # (seconds, n_iterations)
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.time()

    def stop(self, n_iterations: int) -> float:
        assert self._t0 is not None, "stop() without start()"
        dt = time.time() - self._t0
        self._t0 = None
        self.rows.append((dt, n_iterations))
        return dt

    def write_csv(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write("window_seconds,num_iterations,its_per_sec\n")
            for dt, n in self.rows:
                f.write(f"{dt:.6f},{n},{(n / dt if dt > 0 else 0.0):.3f}\n")
