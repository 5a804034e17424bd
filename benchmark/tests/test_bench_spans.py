"""The readers of the program's spans (``metrics/program_spans.py``) in the
tiny traced run of each mapper cell: every stage metric present, finite and
not negative, the stages adding up to the step, and nothing read where the
ring has lost part of the window."""
import math
import time

import pytest

from benchmark import harness
from benchmark.tests.tiny import CHECKOUT, tiny_cell

SPAN_METRICS = ("fwd_host_ms.map", "field_host_ms.map", "bwd_host_ms.map", "update_host_ms.map",
                "upload_host_ms.map", "sync_wait_ms.map")
CELLS = [w["name"] for w in harness.load_bench(CHECKOUT)["workloads"]
         if w["name"] in next(m for m in harness.load_bench(CHECKOUT)["per_layer"]
                              if m["name"] == SPAN_METRICS[0])["workloads"]]
SEED = 3_000_000_019


def _read(ctx, names):
    return {n: harness.load_reader(n)(ctx) for n in names}


@pytest.mark.parametrize("name", CELLS)
def test_span_metrics_of_the_traced_run(name):
    from loner_tpu_torch.runtime import profiling

    cell = tiny_cell(name)
    assert set(SPAN_METRICS) <= {m["name"] for m in cell.per_layer}
    profiling.reset()
    out = harness.load_driver(cell.mix).run(cell, seed=SEED, seconds=0.5, trace=True, device="cpu",
                                            t_start=time.time(), work_dir=CHECKOUT / "build" / "benchmark")
    ctx = out.layer
    m = _read(ctx, SPAN_METRICS + ("host_ms_per_step.map",))
    assert all(v is not None and math.isfinite(v) and v >= 0 for v in m.values()), m
    stages = m["fwd_host_ms.map"] + m["bwd_host_ms.map"] + m["update_host_ms.map"]
    assert 0.9 * m["host_ms_per_step.map"] <= stages <= m["host_ms_per_step.map"], m
    assert m["field_host_ms.map"] <= m["fwd_host_ms.map"]
    window_ms = 1e3 * ctx.window_s / ctx.window_steps
    assert m["host_ms_per_step.map"] + m["upload_host_ms.map"] + m["sync_wait_ms.map"] <= window_ms, (m, window_ms)
    assert m["upload_host_ms.map"] > 0

    # the ring loses the window's oldest records: nothing is read
    recs = list(profiling.SPANS)
    first = [i for i, r in enumerate(profiling.records()) if r.name == "loner.step" and not r.profiled][
        -len(ctx.host_step_s)]
    for kept in (recs[first:], recs[first + 1:]):  # the first window step's stages lost; that step lost too
        profiling.SPANS.clear()
        profiling.SPANS.extend(kept)
        assert _read(ctx, SPAN_METRICS) == dict.fromkeys(SPAN_METRICS)


def test_no_spans_read_nothing(monkeypatch):
    """An empty ring, a run with no window steps, or a build of the program
    with no span record gives no reading."""
    from loner_tpu_torch.runtime import profiling

    ctx = harness.LayerContext(config={}, mix={}, host_step_s=[0.01, 0.01])
    profiling.reset()
    assert _read(ctx, SPAN_METRICS) == dict.fromkeys(SPAN_METRICS)
    ctx.host_step_s = []
    assert _read(ctx, SPAN_METRICS) == dict.fromkeys(SPAN_METRICS)
    monkeypatch.delattr(profiling, "records")
    ctx.host_step_s = [0.01]
    assert _read(ctx, SPAN_METRICS) == dict.fromkeys(SPAN_METRICS)
