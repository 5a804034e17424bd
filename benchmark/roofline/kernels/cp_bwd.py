"""B2: points, lines and the features' gradient in; the lines' gradient and
the points' gradient out. Per point and level: the forward's lerps again
(9F) and, per axis, the other axes' product with the gradient (2F), its dot
with the line's slope (2F) and the two hat-weighted adds (4F)."""
from typing import Tuple

from benchmark.roofline.kernels.cp_fwd import shape  # noqa: F401

TRACE_NAME = "cp_bwd_kernel"
COUNTER = "loner_tpu_torch.ops.cp_kernel:cp_bwd"


def counts(n: int, levels: int, features: int) -> Tuple[float, float]:
    lines = 3 * levels * features * 128 * 4
    return 12.0 * n + lines + 4.0 * levels * features * n + lines + 12.0 * n, 33.0 * levels * features * n
