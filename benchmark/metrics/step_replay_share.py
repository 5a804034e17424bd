"""Percent of the measured window's train steps that replayed a CUDA graph:
the window's step spans (``program_spans.py``) that hold a
``loner.step.replay`` (``loner_tpu_torch/mapping/step_graph.py``). None
where the program records no spans or has no graphs of its step."""
from benchmark.metrics.program_spans import window


def read(ctx):
    try:
        from loner_tpu_torch.mapping.step_graph import REPLAY_SPAN
    except ImportError:
        return None
    w = window(ctx)
    if w is None:
        return None
    replayed = {step for step, name in w.by_step if name == REPLAY_SPAN}
    return 100.0 * len(replayed) / w.steps
