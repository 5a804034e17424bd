"""Host milliseconds a step of the measured window spends inside its
``.backward`` stage (``loner.step.backward``: ``torch.autograd.grad``;
``program_spans.py``)."""
from benchmark.metrics.program_spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "backward")
