"""Host milliseconds a train step of the measured window spends inside
``loner.step.backward``: ``torch.autograd.grad`` (``program_spans.py``)."""
from benchmark.metrics.program_spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "loner.step.backward")
