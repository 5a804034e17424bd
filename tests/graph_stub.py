"""A stand-in for CUDA graph capture on the CPU, for the tests of
``loner_tpu_torch/mapping/step_graph.py`` where no card exists.

:func:`install` makes ``make_train_step`` build its graphs on any device and
records each "graph" as the captured function itself: the capture runs it
once and puts back the input buffers it wrote, as a real capture runs
nothing; a replay runs it again and writes what it returns into the
outputs the capture gave, as a graph's replay rewrites its static outputs;
the spans it records on the way are dropped, as a replay runs no Python.
"""
from loner_tpu_torch.mapping import optimizer, step_graph
from loner_tpu_torch.runtime import profiling


class RerunGraph:
    def __init__(self, run, out):
        self.run = run
        self.plan = out[1]

    def replay(self):
        n = len(profiling.SPANS)
        _, plan = self.run()
        while len(profiling.SPANS) > n:
            profiling.SPANS.pop()
        for (kind, old), (_, new) in zip(self.plan, plan):
            if kind == step_graph._OUT:
                old.copy_(new)


def record(graphs, run):
    saved = [[b.clone() for b in s.bufs] for s in graphs.slots.values()]
    out = run()
    for s, bufs in zip(graphs.slots.values(), saved):
        for b, c in zip(s.bufs, bufs):
            b.copy_(c)
    return RerunGraph(run, out), out


def install(monkeypatch) -> None:
    """Graphs on every single-device step, captured by :func:`record`."""
    monkeypatch.setattr(optimizer, "_graphed", lambda rows: len(rows) == 1 and len(rows[0]) == 1)
    monkeypatch.setattr(step_graph.StepGraphs, "_record", record)
