"""Host milliseconds the measured window spends waiting for the card at
the end of each keyframe or epoch (the steps' parent's child ending in
``.sync``: ``loner.mapper.sync``, ``loner.offline.sync``), over the window's
steps: how far the card runs behind the host (``program_spans.py``)."""
from benchmark.metrics.program_spans import SYNC, beside_ms


def read(ctx):
    return beside_ms(ctx, SYNC)
