"""The kernels' and the step's operations and bytes against hand counts, and
at the flagship shape against the bounds of PERF.md's kernel table."""
import pytest

from benchmark.roofline import counts, kernels

FLAGSHIP_N = 8 * (512 + 64) * 512  # 2,359,296 points a step


def test_hand_counts_small():
    # 10 points, 1 level of 2 features
    b, f = kernels.load("cp_fwd").counts(10, 1, 2)
    assert b == 10 * 12 + 3 * 2 * 128 * 4 + 10 * 2 * 4 and f == 11 * 2 * 10
    b, f = kernels.load("cp_bwd").counts(10, 1, 2)
    assert b == 2 * 10 * 12 + 2 * 3 * 2 * 128 * 4 + 10 * 2 * 4 and f == 33 * 2 * 10
    b, f = kernels.load("hash_fwd").counts(10, 2, 2)
    assert b == 10 * 12 + 10 * 2 * 16 * 2 + 10 * 4 * 4 and f == (16 * 2 + 19) * 2 * 10
    # 10 points, 2 levels of 2 features, 4 rows a level: points and g read,
    # the (2, 4, 16) f32 table gradient written; 19 + 8F FLOPs a point and level
    b, f = kernels.load("hash_dtable").counts(10, 2, 2, 4)
    assert b == 10 * 12 + 10 * 4 * 4 + 2 * 4 * 16 * 4 and f == (19 + 16) * 2 * 10
    field = {"encoder": "triad", "cp_resolutions": [16], "cp_features": 2, "fourier_freqs": 1,
             "sigma_hidden_dim": 4, "sigma_hidden_layers": 1}
    assert counts.mlp_forward_flops(10, field) == 2 * 10 * (8 * 4 + 4 * 1)


@pytest.mark.parametrize("kernel,shape,bound_ms", [
    ("cp_fwd", (4, 16), 0.1888), ("cp_bwd", (4, 16), 0.1973), ("hash_fwd", (16, 2), 0.4592),
    ("hash_dtable", (16, 2, 1 << 16), 0.1186)])
def test_flagship_bounds(kernel, shape, bound_ms):
    b, f = kernels.load(kernel).counts(FLAGSHIP_N, *shape)
    assert round(counts.least_time(b, f) * 1e3, 4) == bound_ms


def test_kernel_modules():
    """Every kernel module names its trace name and its counter; a module
    that counts bytes takes its shape from a field block."""
    for name in kernels.names():
        k = kernels.load(name)
        assert k.TRACE_NAME.endswith("_kernel") and ":" in k.COUNTER
        assert hasattr(k, "counts") == hasattr(k, "shape"), name
    with pytest.raises(LookupError, match="roofline/kernels/nonesuch.py"):
        kernels.load("nonesuch")


def test_train_step_flops():
    field = {"encoder": "triad", "cp_resolutions": [16, 32, 64, 128], "cp_features": 16, "fourier_freqs": 6,
             "sigma_hidden_dim": 64, "sigma_hidden_layers": 1}
    mlp = counts.mlp_forward_flops(FLAGSHIP_N, field)
    assert mlp == 2 * FLAGSHIP_N * (100 * 64 + 64)
    assert 3 * mlp / 1e9 == pytest.approx(91.5, abs=0.1)  # the three GEMMs of 100 -> 64
    assert counts.train_step_flops(FLAGSHIP_N, field) > 3 * mlp
