"""Percent of its roofline that kernel B1 (``cp_fwd_kernel``) reaches in the
traced stretch of train steps or virtual scans."""
from benchmark.roofline.counts import roofline_share


def read(ctx):
    return roofline_share(ctx, "cp_fwd")
