"""GiB of device memory allocated at the peak of the measured window of
train steps or virtual scans (``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(ctx):
    if ctx.peak_window_bytes <= 0:
        return None
    return ctx.peak_window_bytes / 2**30
