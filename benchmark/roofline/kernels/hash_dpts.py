"""B5: points, corner rows and the features' gradient in, (3, N) out."""
from typing import Tuple

from benchmark.roofline.kernels.hash_fwd import shape  # noqa: F401

TRACE_NAME = "fused_dpts_kernel"
COUNTER = "loner_tpu_torch.ops.fused_encoder:interp_dpts"


def counts(n: int, levels: int, features: int) -> Tuple[float, float]:
    return (12.0 * n + 2.0 * levels * 8 * features * n + 4.0 * levels * features * n + 12.0 * n,
            (16.0 * features + 19 + 48) * levels * n)
