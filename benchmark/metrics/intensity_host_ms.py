"""Host milliseconds a step of the measured window spends in its
``loner.field.intensity`` spans, one inside each point chunk's
``loner.field``: the intensity encoder, the SH encoding, the colour MLP and
the sigmoid (``program_spans.py``)."""
from benchmark.metrics.program_spans import spans_ms


def read(ctx):
    return spans_ms(ctx, "loner.field.intensity")
