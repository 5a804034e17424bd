"""Profiling hooks: spans, device traces and wall-clock CSVs.

The port of ``loner_tpu/runtime/profiling.py``: ``maybe_trace`` wraps a
region in a ``torch.profiler`` trace (a Chrome trace under
``<log_dir>/profile``), and ``WindowTimer`` keeps the per-window
``timing.csv`` rows (seconds, iterations, its/s).

``span(name)`` marks a stage of the program's host work. Every span, on
exit, appends one :class:`SpanRecord` to :data:`SPANS`, a ring of the last
:data:`SPAN_CAPACITY` records (the oldest dropped first): its name, its id,
the id of the span open around it on its thread (-1 for none), its start
and end on ``time.perf_counter_ns()``, and whether a ``torch.profiler`` was
active when it began. Only then does it also enter
``torch.profiler.record_function(name)``, so that the span shows in the
profiler's trace, on the device's clock, as a ``user_annotation``; with no
profiler a span costs two clock reads, one check and one append.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Deque, Iterator, List, NamedTuple, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SPAN_CAPACITY = 1 << 16


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: int  # the id of the span open around it on its thread; -1 for none
    t0_ns: int  # time.perf_counter_ns() at entry
    t1_ns: int  # ... at exit
    profiled: bool  # a torch.profiler was active at entry


# plain tuples in SpanRecord's field order (a named tuple costs more to make)
SPANS: Deque[tuple] = collections.deque(maxlen=SPAN_CAPACITY)
_ids = itertools.count()
_profiler_enabled = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns


class _OpenSpans(threading.local):
    def __init__(self) -> None:
        self.ids: List[int] = []


_open = _OpenSpans()


class span:
    """``with span(name):`` records the block as one :class:`SpanRecord`;
    after the block, ``t0_ns`` and ``t1_ns`` hold its readings."""

    __slots__ = ("name", "id", "parent", "t0_ns", "t1_ns", "_annotation")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "span":
        stack = _open.ids
        self.parent = stack[-1] if stack else -1
        self.id = next(_ids)
        stack.append(self.id)
        self._annotation = None
        if _profiler_enabled():
            self._annotation = record_function(self.name)
            self._annotation.__enter__()
        self.t0_ns = _clock()
        return self

    def __exit__(self, *exc) -> None:
        self.t1_ns = _clock()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        _open.ids.pop()
        SPANS.append((self.name, self.id, self.parent, self.t0_ns, self.t1_ns, self._annotation is not None))


def records() -> List[SpanRecord]:
    """The spans the ring holds, in the order they ended."""
    return [SpanRecord._make(r) for r in SPANS]


def reset() -> None:
    """Empty the ring."""
    SPANS.clear()


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str], enabled: bool = True) -> Iterator[None]:
    """Trace the region with ``torch.profiler`` (CPU, and CUDA when a card is
    present) into ``<log_dir>/profile/trace.json``; a no-op when disabled or
    when ``log_dir`` is None."""
    if not enabled or log_dir is None:
        yield
        return
    trace_dir = os.path.join(log_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class WindowTimer:
    """Per-optimization-window host-clock log (``timing.csv`` rows), on
    ``time.perf_counter``."""

    def __init__(self) -> None:
        self.rows: List[tuple] = []  # (seconds, n_iterations)
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_iterations: int) -> float:
        assert self._t0 is not None, "stop() without start()"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.rows.append((dt, n_iterations))
        return dt

    def write_csv(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write("window_seconds,num_iterations,its_per_sec\n")
            for dt, n in self.rows:
                f.write(f"{dt:.6f},{n},{(n / dt if dt > 0 else 0.0):.3f}\n")
