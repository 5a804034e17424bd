"""Percent of the measured window in which no operation ran on the card:
one less the device's busy time a unit of work in the traced stretch
(the union of its device intervals over its train steps or virtual
scans) times the window's units over the window's time. Profiling slows the host that launches the
work, so the traced stretch's own idle share reads high where the host
paces the work; the untraced window's time does not."""


def read(ctx):
    if ctx.trace is None or ctx.traced_steps == 0 or ctx.trace.busy_s <= 0 or ctx.window_s <= 0:
        return None
    busy = ctx.trace.busy_s / ctx.traced_steps * ctx.window_steps
    return 100.0 * (1.0 - busy / ctx.window_s)
