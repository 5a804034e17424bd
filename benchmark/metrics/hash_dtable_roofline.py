"""Percent of its roofline that FusedHash's exact table gradient
(``fused_dtable_kernel``) reaches in the train steps' traced stretch."""
from benchmark.roofline.counts import roofline_share


def read(ctx):
    return roofline_share(ctx, "hash_dtable")
