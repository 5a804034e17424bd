"""Percent of the card's dense peak for the configuration's compute dtype
that the measured window's train steps reach: the FLOPs the steps require
(``roofline/counts.py``: the MLP's GEMMs forward and both backward
products, and the encoder's interpolation), over the window's time."""


def read(ctx):
    if ctx.window_steps == 0 or ctx.window_s <= 0:
        return None
    peak = ctx.config["peak_flops_per_s"]
    return 100.0 * ctx.flops_per_step * ctx.window_steps / (ctx.window_s * peak)
