"""The port's memory probes (loner_tpu_torch/probes/) run end to end on the
CPU at small sizes: every leg is returned with finite numbers, each kernel
leg matches its plain counterpart, and no kernel launches (CPU tensors take
the plain versions)."""
import math

import pytest

from loner_tpu_torch.probes import (
    bench_dyngather,
    bench_gather,
    bench_gather2,
    bench_honest,
    bench_lane_gather,
    bench_pallas_scatter,
)

SMALL_FLAGSHIP = ["--keyframes", "2", "--channels", "8", "--azimuth", "64", "--pad-to", "256", "--sky", "32",
                  "--rays-per-kf", "32", "--sky-rays-per-kf", "8", "--samples", "32"]
RUNS = {
    "bench_pallas_scatter": (bench_pallas_scatter, ["--n", "1024", "--t", "128"]),
    "bench_gather": (bench_gather, ["--n", "1000", "--t", "256", "--levels", "2"]),
    "bench_gather2": (bench_gather2, ["--n", "1024", "--t", "256"]),
    "bench_dyngather": (bench_dyngather, ["--rows", "8", "16", "--r", "64", "--chunks", "2", "--n", "1000",
                                          "--t", "256"]),
    "bench_lane_gather": (bench_lane_gather, ["--n", "512"]),
    "bench_honest": (bench_honest, ["--n", "1024", "--t", "256"] + SMALL_FLAGSHIP),
}
N_LEGS = {"bench_pallas_scatter": 5, "bench_gather": 11, "bench_gather2": 4, "bench_dyngather": 6,
          "bench_lane_gather": 3, "bench_honest": 10}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_probe_runs_on_the_cpu(name):
    module, argv = RUNS[name]
    result = module.main(argv + ["--device", "cpu"])
    assert result["device"] == "cpu"
    legs = result["legs"]
    assert len(legs) == N_LEGS[name], sorted(legs)
    for leg, values in legs.items():
        assert values, leg
        for key, v in values.items():
            assert isinstance(v, bool) or math.isfinite(v), (leg, key, v)
            if key in ("max_abs_err", "abs_err"):
                assert v == 0.0, (leg, v)  # exact lookups, or the same function in the same order
            if key == "equal":
                assert v, leg
            if key == "rel_err":
                assert v <= (1e-6 if "f32" in leg else 1e-2), (leg, v)
        assert any(k.startswith("ms") for k in values) or "err" in " ".join(values), leg
    assert result["launches"] and not any(result["launches"].values())
