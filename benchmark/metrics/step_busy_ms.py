"""Device milliseconds a train step keeps the card busy: the union of the
device's intervals in the traced stretch, over its steps."""


def read(ctx):
    if ctx.trace is None or ctx.traced_steps == 0 or ctx.trace.busy_s <= 0:
        return None
    return 1e3 * ctx.trace.busy_s / ctx.traced_steps
