"""B4: points (3, N) f32 and the gathered corner rows (L, 8F, N) bf16 in,
features (LF, N) f32 out. Per point and level: the 8 trilinear weights (19
FLOPs) and F sums of 8 weighted corners (16F)."""
from typing import Tuple

TRACE_NAME = "fused_fwd_kernel"
COUNTER = "loner_tpu_torch.ops.fused_encoder:interp_fwd"


def shape(field: dict) -> Tuple[int, int]:
    """(levels, features)."""
    return field["hash_levels"], field["hash_features"]


def counts(n: int, levels: int, features: int) -> Tuple[float, float]:
    return 12.0 * n + 2.0 * levels * 8 * features * n + 4.0 * levels * features * n, (16.0 * features + 19) * levels * n
