"""The train step replayed as CUDA graphs.

On one CUDA device ``make_train_step``'s step runs as CUDA graphs, one for
each key of what the captured work depends on: the step's
:class:`TrainStepFlags` and the tree, shapes and dtypes of its tensor
inputs (the state, the window, the pose mask and the draws). A key's first
call runs eagerly (the warm-up: lazy initialisations and the kernels' first
launches run outside a capture), its second captures the step into a graph
and replays it, and every later call replays it. A step's graphs share one
memory pool: they never run at once.

A replay copies each tensor input into the graph's static buffer, unless
the buffer holds it already: the tensor passed is the one last copied in,
or last returned, for that slot, and is unmodified since (its ``_version``).
So the window, passed unchanged for all of a keyframe's steps, and the state
the previous step returned are not copied again. ``iteration`` goes in as a
device scalar, refilled where its value changes. The graph ends by writing
the new state into the state's buffers; the step returns copies of them, and
of the loss, its terms and the gradients, so that no tensor it returned
changes when a later step runs. A leaf the step leaves as it was (a frozen
group's parameters and moments, the grid between occupancy updates) comes
back as the tensor that was passed, as the eager step returns it.

A capture records how many launches of each hand-written kernel
(``ops/kernels.py``'s ``COUNTED``) its graph holds, and adds none for
itself, since nothing ran; each replay adds them. The step function's
``graph_captures`` and ``graph_replays`` count captures and replays (the
call that captures replays once). A capture runs inside the span
``loner.step.capture`` and a replay inside ``loner.step.replay``; a replay
runs none of the step's Python, so it records no stage spans
(``loner.step.forward`` and the rest). A step that cannot be captured (one
that reads a device value on the host) warns once and stays eager for its
key.

A replay allocates only its outputs' copies: the step's activations live in
the graphs' pool, kept from capture to capture, and the inputs in the static
buffers. ``peak_held_bytes`` is the most that one step's graphs have held,
pool and buffers, on any device of the process.
"""
from __future__ import annotations

import warnings
import weakref
from typing import Callable, Dict, List, NamedTuple

import torch

from loner_tpu_torch.ops import kernels
from loner_tpu_torch.runtime.profiling import span

CAPTURE_SPAN = "loner.step.capture"
REPLAY_SPAN = "loner.step.replay"
peak_held_bytes = 0  # the most one step's graph pool and input buffers have held


class _Tensor(NamedTuple):
    """A tensor leaf's place in a tree's spec."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device


_CONST = "const"  # a non-tensor leaf, kept as it is


def flatten(tree, out: List[torch.Tensor]):
    """Append ``tree``'s tensor leaves to ``out`` (dicts, lists, tuples and
    named tuples in order; None is empty); return a hashable spec of its
    structure and leaves that :func:`unflatten` rebuilds it from."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return _Tensor(tuple(tree.shape), tree.dtype, tree.device)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return dict, tuple((k, flatten(v, out)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree), tuple(flatten(t, out) for t in tree)
    return _CONST, tree


def unflatten(spec, leaves):
    """The tree of ``spec`` with its tensor leaves taken in order from the
    iterator ``leaves``."""
    if spec is None:
        return None
    if isinstance(spec, _Tensor):
        return next(leaves)
    kind, body = spec
    if kind is _CONST:
        return body
    if kind is dict:
        return {k: unflatten(v, leaves) for k, v in body}
    items = [unflatten(s, leaves) for s in body]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


class _Slots:
    """The static input buffers of one input spec, shared by its keys'
    graphs, and what each holds."""

    def __init__(self, leaves: List[torch.Tensor], device: torch.device):
        self.bufs = [torch.empty_like(t) for t in leaves]
        self.held = [None] * len(leaves)  # (weak reference, _version) of the tensor each buffer holds
        self.iteration = torch.zeros((), dtype=torch.int64, device=device)
        self._it = None

    def load(self, leaves: List[torch.Tensor], iteration) -> None:
        for i, t in enumerate(leaves):
            held = self.held[i]
            if held is not None and held[0]() is t and held[1] == t._version:
                continue
            self.bufs[i].copy_(t)
            self.hold(i, t)
        if isinstance(iteration, torch.Tensor):
            self.iteration.copy_(iteration)
            self._it = None
        elif int(iteration) != self._it:
            self._it = int(iteration)
            self.iteration.fill_(self._it)

    def hold(self, i: int, t: torch.Tensor) -> None:
        self.held[i] = (weakref.ref(t), t._version)


_IN, _STATE, _OUT = 0, 1, 2  # an output passes an input through, is a state buffer, or a graph output


class _Graph:
    """One captured step: its graph, its input slots, where each output
    comes from, and the kernel launches it holds."""

    def __init__(self, graph, slots: _Slots, out_spec, plan: list, launches: list):
        self.graph = graph
        self.slots = slots
        self.out_spec = out_spec
        self.plan = plan  # (kind, slot index or graph output) per output leaf
        self.launches = launches  # (counted wrapper, launches) with launches > 0

    def replay(self, leaves: List[torch.Tensor], iteration):
        slots = self.slots
        slots.load(leaves, iteration)
        self.graph.replay()
        for wrapper, n in self.launches:
            wrapper.launches += n
        outs = []
        for kind, x in self.plan:
            if kind == _IN:
                outs.append(leaves[x])
            elif kind == _STATE:
                t = slots.bufs[x].clone()
                slots.hold(x, t)
                outs.append(t)
            else:
                outs.append(x.clone())
        return unflatten(self.out_spec, iter(outs))


_WARM, _EAGER = "warm", "eager"  # a key after its warm-up call; a key that cannot be captured
# one side stream a device for every capture, as ``torch.cuda.graph`` keeps
# one: the per-stream state a capture sets up (cuBLAS's workspace) is made once
_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


class StepGraphs:
    """The graphs of one train step. ``body(state, window, flags, pose_mask,
    iteration, draws) -> (new_state, aux)`` is the eager step, with
    ``iteration`` a device scalar; ``owner`` is the step function whose
    ``graph_captures`` and ``graph_replays`` count."""

    def __init__(self, body: Callable, device: torch.device, owner):
        self.body = body
        self.owner = weakref.ref(owner)  # the step function holds this object: no cycle keeps the pool alive
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.keys: Dict[tuple, object] = {}  # key -> _WARM, _EAGER or its _Graph
        self.slots: Dict[tuple, _Slots] = {}  # input spec -> its buffers
        self.pool = None

    def __call__(self, state, window, flags, pose_mask, iteration, draws):
        leaves: List[torch.Tensor] = []
        spec = flatten((state, window, pose_mask, draws), leaves)
        key = (flags, spec)
        graph = self.keys.get(key)
        if isinstance(graph, _Graph):
            with span(REPLAY_SPAN):
                self.owner().graph_replays += 1
                return graph.replay(leaves, iteration)
        if graph is None or graph == _EAGER:
            if graph is None:
                self.keys[key] = _WARM
            it = iteration if isinstance(iteration, torch.Tensor) else torch.full(
                (), int(iteration), dtype=torch.int64, device=self.device)
            return self.body(state, window, flags, pose_mask, it, draws)
        try:
            with span(CAPTURE_SPAN):
                graph = self._capture(spec, leaves, flags, iteration)
        except Exception as err:  # noqa: BLE001: the step stays eager for this key
            warnings.warn(f"the train step could not be captured as a CUDA graph and runs eagerly: {err!r}")
            self.keys[key] = _EAGER
            # a failed capture can leave its pool marked as recording: later captures take a new pool
            self.pool = None
            return self(state, window, flags, pose_mask, iteration, draws)
        self.keys[key] = graph
        self.owner().graph_captures += 1
        with span(REPLAY_SPAN):
            self.owner().graph_replays += 1
            return graph.replay(leaves, iteration)

    def _capture(self, spec, leaves: List[torch.Tensor], flags, iteration) -> _Graph:
        if any(t.device != self.device for t in leaves):
            raise ValueError(f"an input lies off the step's device {self.device}")
        slots = self.slots.get(spec)
        if slots is None:
            slots = self.slots[spec] = _Slots(leaves, self.device)
        slots.load(leaves, iteration)
        state, window, pose_mask, draws = unflatten(spec, iter(slots.bufs))

        def run():
            new_state, aux = self.body(state, window, flags, pose_mask, slots.iteration, draws)
            return _write_back(slots, state, new_state, aux)

        before = [w.launches for w in kernels.COUNTED]
        try:
            graph, (out_spec, plan) = self._record(run)
        finally:
            launches = [(w, w.launches - b) for w, b in zip(kernels.COUNTED, before) if w.launches != b]
            for w, b in zip(kernels.COUNTED, before):
                w.launches = b
        return _Graph(graph, slots, out_spec, plan, launches)

    def _record(self, run: Callable):
        """``run()`` captured into a CUDA graph on a side stream, into the
        step's pool: (the graph, what ``run`` returned while captured)."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        stream = _CAPTURE_STREAMS.get(self.device)
        if stream is None:
            stream = _CAPTURE_STREAMS[self.device] = torch.cuda.Stream(self.device)
        # the pools of steps that are gone (the offline loop builds a step a
        # call) go back to the device only when the allocator releases its
        # cached blocks, which it never does while a capture is under way:
        # where less than a quarter of the card is free, release them first
        free, total = torch.cuda.mem_get_info(self.device)
        if free < total // 4:
            torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            # thread-local: another thread's synchronizing call (the tracker's
            # ICP beside a threaded mapper) neither fails nor breaks the capture
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                out = run()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was invalidated; the first error is the one to raise
                raise
            graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        global peak_held_bytes
        held = _pool_bytes(self.device, self.pool) + sum(
            b.numel() * b.element_size() for slots in self.slots.values() for b in slots.bufs)
        peak_held_bytes = max(peak_held_bytes, held)
        return graph, out


def _pool_bytes(device: torch.device, pool) -> int:
    """Bytes the caching allocator has reserved on ``device`` for the graph
    pool ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == device.index and tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def _write_back(slots: _Slots, state, new_state, aux):
    """(spec of (new_state, aux), plan): each leaf of the new state that is
    not its input is written into the input's buffer (the new state has the
    state's tree); an output that is an input buffer is that input, passed
    through; every other output is the graph's."""
    outs: List[torch.Tensor] = []
    out_spec = flatten((new_state, aux), outs)
    state_leaves: List[torch.Tensor] = []
    n_state = len(state_leaves) if flatten(new_state, []) == flatten(state, state_leaves) else 0
    slot_of = {id(b): i for i, b in enumerate(slots.bufs)}
    storages = {b.untyped_storage().data_ptr() for b in slots.bufs if b.numel()}
    plan = []
    for k, t in enumerate(outs):
        i = slot_of.get(id(t))
        if i is not None:
            plan.append((_IN, i))
        elif t.numel() and t.untyped_storage().data_ptr() in storages:
            raise ValueError("a step output is a view of an input")
        elif k < n_state:
            slots.bufs[k].copy_(t)
            plan.append((_STATE, k))
        else:
            plan.append((_OUT, t))
    return out_spec, plan
