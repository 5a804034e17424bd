"""The measured window read from the program's own span record
(``loner_tpu_torch.runtime.profiling``): the step span (``ctx.step_span``,
``loner.step`` unless the driver names another) around each step with its
stages inside (``<step span>.forward`` and so on), and the keyframe's or
epoch's upload and synchronize beside the steps (children of the steps'
parent whose names end in ``.stack_window`` and ``.sync``).

The window's steps are the last ``len(ctx.host_step_s)`` step spans begun
with no profiler active (the traced stretches after the window all run
under one), each inside the benchmark's own time of its call; its
keyframes or epochs are those steps' parents. Every span takes an id as it
begins and is recorded as it ends, and the ring drops the oldest record
first, so the window is whole when the ring holds every id from its first
keyframe's on. Where the program records no spans (a build before them),
or the ring no longer holds the whole window, the readers return None.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, NamedTuple, Optional, Tuple

UPLOAD = ".stack_window"
SYNC = ".sync"


class Window(NamedTuple):
    steps: int
    by_step: Dict[Tuple[int, str], int]  # (step id, span name) -> ns summed over the step's descendants
    by_parent: Dict[str, int]  # span name -> ns summed over the children of the window's keyframes or epochs
    has_parents: bool


def window(ctx) -> Optional[Window]:
    try:
        from loner_tpu_torch.runtime import profiling
    except ImportError:
        return None
    read_records = getattr(profiling, "records", None)
    n = len(ctx.host_step_s)
    if read_records is None or n == 0:
        return None
    recs = read_records()
    steps = [r for r in recs if r.name == ctx.step_span and not r.profiled][-n:]
    if len(steps) < n:
        return None
    # each step span lies inside the benchmark's time of its call (1 us of rounding)
    if any(r.t1_ns - r.t0_ns > s * 1e9 + 1e3 for r, s in zip(steps, ctx.host_step_s)):
        return None
    has_parents = all(r.parent >= 0 for r in steps)
    first = steps[0].parent if has_parents else steps[0].id
    ids = {r.id for r in recs if r.id >= first}
    if len(ids) != max(ids) - first + 1:
        return None
    parents = {r.parent for r in steps} if has_parents else set()
    step_ids = {r.id for r in steps}
    step_of: Dict[int, int] = {}
    by_step: Dict[Tuple[int, str], int] = defaultdict(int)
    by_parent: Dict[str, int] = defaultdict(int)
    for r in sorted((r for r in recs if r.id >= first), key=lambda r: r.id):
        owner = r.id if r.id in step_ids else step_of.get(r.parent)
        if owner is not None:
            step_of[r.id] = owner
            by_step[owner, r.name] += r.t1_ns - r.t0_ns
        if r.parent in parents:
            by_parent[r.name] += r.t1_ns - r.t0_ns
    return Window(n, dict(by_step), dict(by_parent), has_parents)


def spans_ms(ctx, name: str) -> Optional[float]:
    """Mean host ms a window step spends in the spans ``name`` inside it."""
    w = window(ctx)
    if w is None:
        return None
    return 1e-6 * sum(ns for (_, n), ns in w.by_step.items() if n == name) / w.steps


def stage_ms(ctx, stage: str) -> Optional[float]:
    """Mean host ms a window step spends in its stage ``<step span>.<stage>``."""
    return spans_ms(ctx, f"{ctx.step_span}.{stage}")


def beside_ms(ctx, suffix: str) -> Optional[float]:
    """Host ms the window's keyframes or epochs spend in their child spans
    whose names end in ``suffix``, over the window's steps."""
    w = window(ctx)
    if w is None or not w.has_parents:
        return None
    return 1e-6 * sum(ns for n, ns in w.by_parent.items() if n.endswith(suffix)) / w.steps
