"""Host milliseconds a step of the measured window spends inside its
``.forward`` stage (``loner.step.forward``: the rays, the sampler, the
field, compositing and the loss, as the host builds them;
``program_spans.py``)."""
from benchmark.metrics.program_spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "forward")
