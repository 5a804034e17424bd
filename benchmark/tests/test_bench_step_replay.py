"""``metrics/step_replay_share.py`` on hand-made span rings: a keyframe of
steps as the mapper records them, each step either eager (its stages) or a
replay of its CUDA graph (one ``loner.step.replay``), read as the percent of
the window's steps that replayed."""
import pytest

from benchmark import harness

ms = 1_000_000


def _ring(profiling, replayed):
    """One ``loner.mapper.keyframe`` holding its upload, a draws and a
    ``loner.step`` per entry of ``replayed`` (a 1 ms replay, or a 4 ms
    forward, 3 ms backward and 2 ms update) and its sync; the records in
    the order the spans end."""
    ids = iter(range(5000, 6000))
    parent = next(ids)
    recs = [("loner.mapper.stack_window", next(ids), parent, 0, 2 * ms)]
    t = 2 * ms
    for graph in replayed:
        recs.append(("loner.mapper.draws", next(ids), parent, t, t + ms))
        t += ms
        step = next(ids)
        if graph:
            recs.append(("loner.step.replay", next(ids), step, t, t + ms))
        else:
            fwd, bwd, upd = next(ids), next(ids), next(ids)
            recs += [("loner.step.forward", fwd, step, t, t + 4 * ms),
                     ("loner.step.backward", bwd, step, t + 4 * ms, t + 7 * ms),
                     ("loner.step.update", upd, step, t + 7 * ms, t + 9 * ms)]
        recs.append(("loner.step", step, parent, t, t + 10 * ms))
        t += 10 * ms
    recs += [("loner.mapper.sync", next(ids), parent, t, t + ms), ("loner.mapper.keyframe", parent, -1, 0, t + ms)]
    profiling.reset()
    profiling.SPANS.extend((*r, False) for r in recs)


@pytest.mark.parametrize("replayed, share", [
    ([False] * 5, 0.0),
    ([True] * 5, 100.0),
    ([False, False, True, True, True, True, True, True], 75.0),
])
def test_step_replay_share(replayed, share):
    from loner_tpu_torch.runtime import profiling

    read = harness.load_reader("step_replay_share.map")
    _ring(profiling, replayed)
    try:
        ctx = harness.LayerContext(config={}, mix={}, host_step_s=[0.011] * len(replayed))
        assert read(ctx) == pytest.approx(share, abs=1e-12)
        # the window is the last steps: the keyframe's last four replayed
        ctx.host_step_s = ctx.host_step_s[:4]
        assert read(ctx) == (100.0 if replayed[-1] else 0.0)
        profiling.SPANS.popleft()  # the ring lost the keyframe's first record: nothing is read
        ctx.host_step_s = [0.011] * len(replayed)
        assert read(ctx) is None
    finally:
        profiling.reset()


def test_a_program_without_graphs_reads_nothing(monkeypatch):
    """A build of the program with no ``step_graph`` module gives no reading."""
    import sys

    from loner_tpu_torch.runtime import profiling

    _ring(profiling, [False] * 3)
    try:
        monkeypatch.setitem(sys.modules, "loner_tpu_torch.mapping.step_graph", None)
        ctx = harness.LayerContext(config={}, mix={}, host_step_s=[0.011] * 3)
        assert harness.load_reader("step_replay_share.map")(ctx) is None
    finally:
        profiling.reset()


def test_graph_mem_gib_reads_the_graphs_held_memory(monkeypatch):
    """``metrics/graph_mem_gib.py``: the most a step's graphs held, in GiB;
    nothing where no graph was captured or the program has none."""
    import sys

    from loner_tpu_torch.mapping import step_graph

    read = harness.load_reader("graph_mem_gib.map")
    ctx = harness.LayerContext(config={}, mix={})
    monkeypatch.setattr(step_graph, "peak_held_bytes", 0)
    assert read(ctx) is None
    monkeypatch.setattr(step_graph, "peak_held_bytes", 3 * 2**29)
    assert read(ctx) == 1.5
    monkeypatch.setitem(sys.modules, "loner_tpu_torch.mapping.step_graph", None)
    assert read(ctx) is None
