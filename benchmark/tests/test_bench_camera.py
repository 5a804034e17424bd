"""The camera cell (``hash_rgb.hpk_camera``) at a tiny size on the CPU: its
traced run correct with the camera step's span metrics read, each planted
fault caught, the decoupled field's refusals, and the
counts of the intensity table's gradient and of a camera step at the cell's
shapes."""
import json
import math
import time

import pytest

from benchmark import check, fields, harness
from benchmark.roofline import counts, kernels
from benchmark.roofline.camera import camera_step_flops
from benchmark.tests.tiny import CHECKOUT, tiny_cell

CELL = "hash_rgb.hpk_camera"
SEED = 3_000_000_019
SPAN_METRICS = ("fwd_host_ms.camera", "field_host_ms.camera", "bwd_host_ms.camera", "update_host_ms.camera",
                "intensity_host_ms.camera")


def _run(cell, trace=False, fault=None):
    from benchmark.drivers import camera_phase

    return camera_phase.run(cell, seed=SEED, seconds=0.3, trace=trace, device="cpu", t_start=time.time(),
                            work_dir=CHECKOUT / "build" / "benchmark", fault=fault)


def test_traced_run_is_correct_and_reads_the_camera_spans():
    from loner_tpu_torch.runtime import profiling

    cell = tiny_cell(CELL)
    profiling.reset()
    out = _run(cell, trace=True)
    assert check.verdict(out.numbers, cell.limits) and out.failed == 0, out.numbers
    assert out.numbers["frozen_moved"] == 0
    ctx = out.layer
    assert ctx.step_span == "loner.camera.step" and ctx.window_steps == len(ctx.host_step_s) > 0
    m = {n: harness.load_reader(n)(ctx) for n in SPAN_METRICS}
    assert all(v is not None and math.isfinite(v) and v > 0 for v in m.values()), m
    host_ms = 1e3 * sum(ctx.host_step_s) / len(ctx.host_step_s)
    stages = m["fwd_host_ms.camera"] + m["bwd_host_ms.camera"] + m["update_host_ms.camera"]
    assert 0.8 * host_ms <= stages <= host_ms, (m, host_ms)
    assert m["intensity_host_ms.camera"] < m["field_host_ms.camera"] <= m["fwd_host_ms.camera"]
    # the traced stretch's launches at the point chunk's size (the CPU's plain
    # versions launch nothing; on a card B4 twice and the table gradient once
    # a chunk)
    chunks = cell.config["field"]["point_chunks"]
    n = cell.config["rgb_phase"]["rgb_rays"] * cell.config["train"]["n_samples_train"] // chunks
    assert ctx.traced_steps == cell.mix["camera"]["trace_steps"]
    assert all(sizes == [(n, 0)] for sizes in ctx.launches.values()), ctx.launches


@pytest.mark.parametrize("traced,lost", [
    ({"fused_dtable_kernel": 80, "fused_fwd_kernel": 160}, {}),
    ({"fused_dtable_kernel": 77, "fused_fwd_kernel": 160}, {"hash_dtable": (80, 77), "rgb_dtable": (80, 77)}),
    ({"fused_dtable_kernel": 80, "fused_fwd_kernel": 151}, {"hash_fwd": (160, 151)}),
    ({"fused_dtable_kernel": 81, "fused_fwd_kernel": 160}, {}),
])
def test_a_device_trace_that_lost_records_is_named(traced, lost):
    """The kernels whose traced launches fall short of their counters (the
    profiler dropped records: that stretch is traced again); a trace that
    holds more is a miscount, left for ``roofline_share`` to refuse."""
    from benchmark.drivers import camera_phase
    from benchmark.trace import TraceSummary

    summary = TraceSummary(window_s=1.0, busy_s=0.5, kernel_s={k: 0.01 for k in traced}, kernel_count=traced)
    counted = {"hash_dtable": 80, "rgb_dtable": 80, "hash_fwd": 160, "cp_fwd": 0}
    assert camera_phase.lost_records(summary, counted) == lost


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "sigma_trained"])
def test_planted_faults_are_not_correct(fault):
    cell = tiny_cell(CELL)
    numbers = _run(cell, fault=fault).numbers
    assert not check.verdict(numbers, cell.limits), numbers
    if fault == "sigma_trained":
        assert numbers["frozen_moved"] > 0


@pytest.mark.parametrize("change,message", [
    ({"intensity_levels": 8}, "intensity_levels 8 against hash_levels 4"),
    ({"intensity_features": 4}, "intensity_features 4 against hash_features 2"),
    ({"intensity_log2_cells": 12}, "intensity_log2_cells 12"),
    ({"table_gradient": "strided"}, "table_gradient 'strided'"),
    ({"sh_degree": 5}, "sh_degree 5"),
    ({"intensity_width": 64}, "reads no ['intensity_width']"),
])
def test_a_decoupled_field_it_cannot_build_is_refused(change, message):
    cell = tiny_cell(CELL)
    cell.config["field"].update(change)
    with pytest.raises(fields.FieldError) as e:
        fields.load(cell.config)
    assert "configuration 'loner_hash_rgb'" in str(e.value) and message in str(e.value), str(e.value)


def _field():
    return json.loads((CHECKOUT / "benchmark" / "configs" / "loner_hash_rgb.json").read_text())["field"]


def test_intensity_table_gradient_counts():
    """At the cell's shape, 4096 rays x 512 samples in 4 point chunks of
    524,288 points: a launch reads the points and the features' gradient
    (12N + 4LFN bytes) and writes the (16, 2^17, 16) f32 gradient (32FLT),
    207,618,048 bytes, 0.0620 ms at 3.35 TB/s; four a step, 0.2479 ms. The
    hash cell's module reads the sigma grid's 2^16 rows."""
    field = _field()
    k = kernels.load("rgb_dtable")
    assert k.shape(field) == (16, 2, 1 << 17)
    assert kernels.load("hash_dtable").shape(field) == (16, 2, 1 << 16)
    assert k.TRACE_NAME == kernels.load("hash_dtable").TRACE_NAME and k.COUNTER == kernels.load("hash_dtable").COUNTER
    n = 4096 * 512 // 4
    b, f = k.counts(n, *k.shape(field))
    assert b == 12 * n + 4 * 16 * 2 * n + 32 * 2 * 16 * (1 << 17) == 207_618_048
    assert f == (19 + 16) * 16 * n
    assert round(counts.least_time(b, f) * 1e3, 4) == 0.0620
    assert round(4 * counts.least_time(b, f) * 1e3, 4) == 0.2479


def test_camera_step_flops():
    """The colour MLP 48 -> 64 -> 64 -> 64 -> 64 -> 3, three times its
    forward, dominates: 15,552 multiply-adds a point."""
    n = 4096 * 512
    field = _field()
    mlp = 2 * n * (48 * 64 + 3 * 64 * 64 + 64 * 3)
    total = camera_step_flops(n, field)
    assert total > 3 * mlp
    assert round(total / 1e9, 2) == 209.23
