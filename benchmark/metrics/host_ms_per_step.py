"""Host milliseconds inside each call of the mapper's train step over the
measured window: the time the host takes to enqueue a step (the benchmark's
own span around ``OnlineMapper._train_step``)."""


def read(ctx):
    if not ctx.host_step_s:
        return None
    return 1e3 * sum(ctx.host_step_s) / len(ctx.host_step_s)
