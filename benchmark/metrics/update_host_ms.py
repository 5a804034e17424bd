"""Host milliseconds a step of the measured window spends inside its
``.update`` stage (``loner.step.update``: the finite check, the Adam groups
and the occupancy update; ``program_spans.py``)."""
from benchmark.metrics.program_spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "update")
