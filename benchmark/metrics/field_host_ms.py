"""Host milliseconds a step of the measured window spends in its
``loner.field`` spans, one a point chunk: the encoder and the MLP
(``program_spans.py``)."""
from benchmark.metrics.program_spans import spans_ms


def read(ctx):
    return spans_ms(ctx, "loner.field")
