"""Host milliseconds the measured window spends in ``stack_window``, the
keyframe window's upload to the card (the steps' parent's child ending in
``.stack_window``: ``loner.mapper.stack_window``,
``loner.offline.stack_window``), over the window's steps
(``program_spans.py``)."""
from benchmark.metrics.program_spans import UPLOAD, beside_ms


def read(ctx):
    return beside_ms(ctx, UPLOAD)
