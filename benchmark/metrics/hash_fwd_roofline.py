"""Percent of its roofline that kernel B4 (``fused_fwd_kernel``) reaches in
the train steps' traced stretch."""
from benchmark.roofline.counts import roofline_share


def read(ctx):
    return roofline_share(ctx, "hash_fwd")
