"""Percent of its roofline that FusedHash's exact table gradient reaches on
the intensity grid (``fused_dtable_kernel`` at the intensity table's rows)
in the camera steps' traced stretch."""
from benchmark.roofline.counts import roofline_share


def read(ctx):
    return roofline_share(ctx, "rgb_dtable")
