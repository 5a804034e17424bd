"""Percent of its roofline that kernel B2 (``cp_bwd_kernel``) reaches in the
train steps' traced stretch."""
from benchmark.roofline.counts import roofline_share


def read(ctx):
    return roofline_share(ctx, "cp_bwd")
