"""B1: points (3, N) f32 and lines (3L, F, 128) f32 in, features (LF, N)
f32 out. Per point and level: three lerps of F features (3 FLOPs each) and
the product of the three axes (2F)."""
from typing import Tuple

TRACE_NAME = "cp_fwd_kernel"
COUNTER = "loner_tpu_torch.ops.cp_kernel:cp_fwd"


def shape(field: dict) -> Tuple[int, int]:
    """(levels, features)."""
    return len(field["cp_resolutions"]), field["cp_features"]


def counts(n: int, levels: int, features: int) -> Tuple[float, float]:
    lines = 3 * levels * features * 128 * 4
    return 12.0 * n + lines + 4.0 * levels * features * n, 11.0 * levels * features * n
