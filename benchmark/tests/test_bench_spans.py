"""The readers of the program's spans (``metrics/program_spans.py``) in the
tiny traced run of each mapper cell: every stage metric present, finite and
not negative, the stages adding up to the step, and nothing read where the
ring has lost part of the window; and on a ring whose step span has
another name, read under that name."""
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
    m = _read(ctx, SPAN_METRICS)
    assert all(v is not None and math.isfinite(v) and v >= 0 for v in m.values()), m
    host_ms = 1e3 * sum(ctx.host_step_s) / len(ctx.host_step_s)  # the benchmark's own time of a step call
    stages = m["fwd_host_ms.map"] + m["bwd_host_ms.map"] + m["update_host_ms.map"]
    assert 0.9 * host_ms <= stages <= host_ms, (m, host_ms)
    assert m["field_host_ms.map"] <= m["fwd_host_ms.map"]
    window_ms = 1e3 * ctx.window_s / ctx.window_steps
    assert host_ms + m["upload_host_ms.map"] + m["sync_wait_ms.map"] <= window_ms, (m, host_ms, window_ms)
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


def _camera_ring(profiling, n_steps: int):
    """A window as a camera step would record it: one ``loner.camera.window``
    holding its upload, ``n_steps`` steps of ``loner.camera.step`` (forward
    4 ms with 1 ms of field inside, backward 3, update 2, 10 ms in all) and
    its sync; the records in the order the spans end."""
    ms = 1_000_000
    ids = iter(range(1000, 2000))
    parent = next(ids)
    recs = [("loner.camera.stack_window", next(ids), parent, 0, 2 * ms)]
    t = 2 * ms
    for _ in range(n_steps):
        step, fwd, fld, bwd, upd = (next(ids) for _ in range(5))
        recs += [("loner.field", fld, fwd, t + ms, t + 2 * ms), ("loner.camera.step.forward", fwd, step, t, t + 4 * ms),
                 ("loner.camera.step.backward", bwd, step, t + 4 * ms, t + 7 * ms),
                 ("loner.camera.step.update", upd, step, t + 7 * ms, t + 9 * ms),
                 ("loner.camera.step", step, parent, t, t + 10 * ms)]
        t += 10 * ms
    recs += [("loner.camera.sync", next(ids), parent, t, t + ms), ("loner.camera.window", parent, -1, 0, t + ms)]
    profiling.reset()
    profiling.SPANS.extend((*r, False) for r in recs)


def test_a_step_span_of_another_name():
    """The same readers, under a split of their own, read a camera step's
    spans once the context names its step span; under ``loner.step`` that
    ring holds no step."""
    from loner_tpu_torch.runtime import profiling

    names = tuple(n.replace(".map", ".rgb") for n in SPAN_METRICS)
    _camera_ring(profiling, 4)
    try:
        ctx = harness.LayerContext(config={}, mix={}, host_step_s=[0.011] * 4, step_span="loner.camera.step")
        m = _read(ctx, names)
        want = {"fwd_host_ms.rgb": 4.0, "field_host_ms.rgb": 1.0, "bwd_host_ms.rgb": 3.0, "update_host_ms.rgb": 2.0,
                "upload_host_ms.rgb": 0.5, "sync_wait_ms.rgb": 0.25}
        assert m == pytest.approx(want, rel=1e-12), m
        ctx.step_span = "loner.step"
        assert _read(ctx, names) == dict.fromkeys(names)
    finally:
        profiling.reset()
