"""FusedHash's exact table gradient (``_bwd_dtable_exact``): points (3, N)
f32 and the features' gradient (LF, N) f32 in, the table's gradient
(L, T, 8F) f32 out. Per point and level: the 8 trilinear weights (19 FLOPs)
and the 8F products of a weight and a feature's gradient, added into the
table by atomics."""
from typing import Tuple

TRACE_NAME = "fused_dtable_kernel"
COUNTER = "loner_tpu_torch.ops.fused_encoder:_bwd_dtable_exact"


def shape(field: dict) -> Tuple[int, int, int]:
    """(levels, features, rows a level)."""
    return field["hash_levels"], field["hash_features"], 1 << field["hash_log2_cells"]


def counts(n: int, levels: int, features: int, rows: int) -> Tuple[float, float]:
    return 12.0 * n + 4.0 * levels * features * n + 32.0 * features * levels * rows, (19.0 + 8 * features) * levels * n
