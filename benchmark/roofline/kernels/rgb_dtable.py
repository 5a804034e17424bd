"""FusedHash's exact table gradient (``_bwd_dtable_exact``) on the intensity
branch's grid: the kernel and counts of ``hash_dtable``, at the intensity
table's rows. In the camera step the sigma branch runs without gradients,
so every launch is the intensity table's."""
from typing import Tuple

from benchmark.roofline.kernels.hash_dtable import COUNTER, TRACE_NAME, counts  # noqa: F401


def shape(field: dict) -> Tuple[int, int, int]:
    """(levels, features, rows a level) of the intensity grid."""
    return field["intensity_levels"], field["intensity_features"], 1 << field["intensity_log2_cells"]
