"""Host milliseconds a train step of the measured window spends in its
``loner.field`` spans, one a point chunk: the encoder and the MLP
(``program_spans.py``)."""
from benchmark.metrics.program_spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "loner.field")
