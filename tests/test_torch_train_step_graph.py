"""The train step replayed as CUDA graphs (``loner_tpu_torch/mapping/step_graph.py``).

Twelve steps cross the occupancy update of every fourth step and a
``freeze_poses`` change, with a new ``iteration`` each: four keys, three of
them captured. On the card, for the CP field and the FusedHash field with
the exact table gradient: each step against the eager step (a fresh step's
first call) from the same state; a state and a loss returned at the third
step (a replay) keep their values after the twelfth; each kernel's ``launches`` counter rises by
exactly the launches a profiler trace of the run holds; one capture a key
and a replay on every later call. On the CPU: the step and a two-row mesh
step run eagerly, and through a stand-in for the capture (``graph_stub.py``)
the same twelve steps give the eager step's numbers bit for bit.
"""
import json
from collections import Counter

import pytest
import torch

import graph_stub
from loner_tpu_torch.flagship import flagship
from loner_tpu_torch.mapping import optimizer as opt
from loner_tpu_torch.mapping.step_graph import CAPTURE_SPAN, REPLAY_SPAN, flatten
from loner_tpu_torch.models.losses import LossConfig
from loner_tpu_torch.models.nerf import NeRFConfig
from loner_tpu_torch.models.occupancy_grid import OccGridConfig
from loner_tpu_torch.ops import cp_kernel, fused_encoder, pdf_kernel
from loner_tpu_torch.ops.triad_field import TriadConfig
from loner_tpu_torch.runtime import profiling

STEPS = 12
SCAN = dict(n_keyframes=2, n_channels=8, n_azimuth=64, pad_to=256, n_sky=32)
SMALL = NeRFConfig(num_colors=1, sigma_hidden_dim=16, intensity_hidden_dim=16, intensity_hidden_layers=1,
                   triad=TriadConfig(cp_resolutions=(4, 8), cp_features=4, fourier_freqs=2))
FIELDS = {
    "cp": NeRFConfig(),  # the shipped TriadField CP field: B1, B2, B3
    "fused_exact": NeRFConfig(encoding_impl="fused", encoding_bwd="exact"),  # B3, B4, B5, fused_dtable_kernel
}
# each counted kernel's name in a device trace
TRACE_NAMES = {cp_kernel.cp_fwd: "cp_fwd_kernel", cp_kernel.cp_bwd: "cp_bwd_kernel",
               pdf_kernel.pdf_sample: "pdf_sample_kernel", fused_encoder.interp_fwd: "fused_fwd_kernel",
               fused_encoder.interp_dpts: "fused_dpts_kernel",
               fused_encoder._bwd_dtable_exact: "fused_dtable_kernel"}
# tests/test_torch_train_step.py's bf16 bounds: gradients and moments
# normwise, parameters within a fifth of the learning rate
TOL_BF16 = 1e-3


def _flags(i: int) -> opt.TrainStepFlags:
    return opt.TrainStepFlags(freeze_sigma=False, freeze_rgb=True, freeze_poses=i >= 6, do_occ_update=i % 4 == 3)


def _iteration(i: int) -> int:
    return 7 * i + 1


KEYS = {(_flags(i).freeze_poses, _flags(i).do_occ_update) for i in range(STEPS)}
CALLS = Counter((_flags(i).freeze_poses, _flags(i).do_occ_update) for i in range(STEPS))
CAPTURES = sum(n >= 2 for n in CALLS.values())


def _setup(device, nerf: NeRFConfig, **changes):
    cfg = opt.MapperConfig(nerf=nerf, occ=OccGridConfig(voxel_size=16), window_size=2, max_keyframes=4,
                           rays_per_kf=32, sky_rays_per_kf=8, n_samples_train=64, **changes)
    cfg, cube, state, window = flagship(device=device, cfg=cfg, **SCAN)
    gen = torch.Generator(device=torch.device(device)).manual_seed(5)
    draws = [opt.draw_step(cfg, window, gen, device) for _ in range(STEPS)]
    mask = torch.tensor([0.0, 1.0, 0.0, 0.0], device=device)
    return cfg, cube, state, window, draws, mask


def _leaves(tree):
    out = []
    flatten(tree, out)
    return out


def _run_against_eager(device, setup, check):
    """Twelve steps of one step function; before each, a fresh step's first
    (eager) call from the same state; ``check(i, new, aux, ref, ref_aux)``.
    Returns the step function, and the third step's state and aux (its
    key's first replay) beside copies."""
    cfg, cube, state, window, draws, mask = setup
    step = opt.make_train_step(cfg, cube, device)
    kept = None
    for i in range(STEPS):
        args = (window, _flags(i), mask, _iteration(i), draws[i])
        ref, ref_aux = opt.make_train_step(cfg, cube, device)(state, *args)
        new, aux = step(state, *args)
        check(i, new, aux, ref, ref_aux)
        if i == 2:
            kept = ((new, aux), [t.clone() for t in _leaves((new, aux))])
        state = new
    return step, kept


def _assert_kept(kept):
    (tree, copies) = kept
    leaves = _leaves(tree)
    assert len(leaves) == len(copies)
    for t, c in zip(leaves, copies):
        assert torch.equal(t, c)


def _assert_equal(i, new, aux, ref, ref_aux):
    for a, b in zip(_leaves((new, aux)), _leaves((ref, ref_aux)), strict=True):
        assert torch.equal(a, b), f"step {i}"


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------


def test_step_on_cpu_runs_eager():
    """On the CPU the step builds no graph: no capture or replay, no such
    span, and the stages' spans on every step."""
    cfg, cube, state, window, draws, mask = _setup("cpu", SMALL)
    step = opt.make_train_step(cfg, cube, "cpu")
    profiling.reset()
    for i in range(4):
        state, aux = step(state, window, _flags(i), mask, _iteration(i), draws[i])
        assert torch.isfinite(aux["loss"])
    assert (step.graph_captures, step.graph_replays) == (0, 0)
    names = Counter(r.name for r in profiling.records())
    assert names["loner.step"] == names["loner.step.forward"] == 4
    assert names[CAPTURE_SPAN] == names[REPLAY_SPAN] == 0


def test_mesh_step_on_cpu_runs_eager():
    """A mesh of two rows runs eagerly and gives the single step's numbers
    (``tests/test_torch_parallel.py``'s bounds)."""
    cfg, cube, state, window, draws, mask = _setup("cpu", SMALL._replace(compute_dtype="float32"))
    mesh = opt.make_mesh_train_step(cfg, cube, [("cpu",), ("cpu",)])
    single = opt.make_train_step(cfg, cube, "cpu")
    for i in range(3):
        args = (window, _flags(i), mask, _iteration(i), draws[i])
        s2, a2 = mesh(state, *args)
        s1, a1 = single(state, *args)
        assert float(a2["loss"]) == pytest.approx(float(a1["loss"]), rel=1e-6)
        g1, g2 = a1["grads"]["sigma"], a2["grads"]["sigma"]
        for x, y in zip(_leaves(g1), _leaves(g2)):
            assert float(torch.linalg.vector_norm(x - y)) <= 1e-5 * max(float(torch.linalg.vector_norm(x)), 1e-12)
        state = s1
    for s in (mesh, single):
        assert (s.graph_captures, s.graph_replays) == (0, 0)


@pytest.mark.parametrize("case", ["random_js", "fixed_los"])
def test_graphed_steps_match_eager_through_a_stand_in(case, monkeypatch):
    """Through the stand-in capture: the twelve steps bit for bit as the
    eager step's (FIXED's slice and L1_LOS's decayed tolerance both read
    the device ``iteration``), the third step's state and loss unchanged
    after the twelfth, one capture a key and a replay on every later call."""
    graph_stub.install(monkeypatch)
    changes = {} if case == "random_js" else dict(rays_strategy="FIXED", loss=LossConfig(loss_selection="L1_LOS"))
    step, kept = _run_against_eager("cpu", _setup("cpu", SMALL, **changes), _assert_equal)
    _assert_kept(kept)
    assert step.graph_captures == CAPTURES == 3
    assert step.graph_replays == STEPS - len(KEYS) == 8


def test_graph_copies_in_what_changed(monkeypatch):
    """A replay handed a state other than the one the step last returned (an
    older one, or one written in place) computes from that state, as the
    eager step does; leaves the step leaves alone come back as passed."""
    graph_stub.install(monkeypatch)
    cfg, cube, state, window, draws, mask = _setup("cpu", SMALL)
    step = opt.make_train_step(cfg, cube, "cpu")
    states = [state]
    flags = _flags(0)
    for i in range(4):
        states.append(step(states[-1], window, flags, mask, i, draws[i])[0])
    assert step.graph_replays == 3

    def both(s, i):
        ref = opt.make_train_step(cfg, cube, "cpu")(s, window, flags, mask, i, draws[i])
        return step(s, window, flags, mask, i, draws[i]), ref

    (new, aux), (ref, ref_aux) = both(states[2], 4)  # an older state
    _assert_equal(4, new, aux, ref, ref_aux)
    # the frozen intensity group and the grid between updates: passed through
    assert all(a is b for a, b in zip(_leaves(new.params["intensity"]), _leaves(states[2].params["intensity"])))
    assert new.occ_grid is states[2].occ_grid
    new.poses[1] += 0.01  # written in place after the step returned it
    (new2, aux2), (ref2, ref_aux2) = both(new, 5)
    _assert_equal(5, new2, aux2, ref2, ref_aux2)
    assert step.graph_replays == 5


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).double())) / max(float(torch.linalg.vector_norm(b.double())), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_graphed_steps_match_eager_on_card(field):
    """Each step from the same state as a fresh step's eager call: the loss
    bit for bit (the forward has no atomics); the gradients and Adam
    moments within ``tests/test_torch_train_step.py``'s bf16 bounds, the
    parameters and poses within a fifth of their learning rates (B2 and
    the table gradient add with atomics, in another order on each run, the
    eager step's as well)."""
    dev = _card()
    setup = _setup(dev, FIELDS[field])
    cfg = setup[0]
    worst = {}

    def check(i, new, aux, ref, ref_aux):
        assert torch.equal(aux["loss"], ref_aux["loss"]), f"step {i}"
        assert bool(aux["finite"]) and bool(ref_aux["finite"])
        for name, a, b in (("grads", aux["grads"], ref_aux["grads"]), ("mu", new.opt_sigma.mu, ref.opt_sigma.mu),
                           ("nu", new.opt_sigma.nu, ref.opt_sigma.nu), ("occ_grid", new.occ_grid, ref.occ_grid)):
            for x, y in zip(_leaves(a), _leaves(b), strict=True):
                worst[name] = max(worst.get(name, 0.0), _rel(x, y))
                assert _rel(x, y) <= TOL_BF16, (i, name)
        for x, y in zip(_leaves(new.params), _leaves(ref.params), strict=True):
            assert float((x - y).abs().max()) <= 0.2 * cfg.lr_sigma, i
        assert float((new.poses - ref.poses).abs().max()) <= 0.2 * cfg.lr_pose, i

    step, kept = _run_against_eager(dev, setup, check)
    _assert_kept(kept)
    assert step.graph_captures == CAPTURES
    assert step.graph_replays == STEPS - len(KEYS)
    print(field, "largest relative gaps", worst)


@pytest.mark.gpu
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_launch_counters_match_trace_on_card(field, tmp_path):
    """Over a fresh step's twelve calls (warm-ups, captures and replays)
    each kernel's ``launches`` counter rises by the launches the profiler's
    device trace holds: the captures add none, each replay adds its graph's."""
    dev = _card()
    cfg, cube, state, window, draws, mask = _setup(dev, FIELDS[field])
    step = opt.make_train_step(cfg, cube, dev)
    before = {w: w.launches for w in TRACE_NAMES}
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(STEPS):
            state, _ = step(state, window, _flags(i), mask, _iteration(i), draws[i])
        torch.cuda.synchronize()
    counted = {TRACE_NAMES[w]: w.launches - n for w, n in before.items()}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    traced = Counter(name for e in json.loads(path.read_text())["traceEvents"] if e.get("cat") == "kernel"
                     for name in TRACE_NAMES.values() if name in e.get("name", ""))
    assert {k: v for k, v in counted.items() if v} == dict(traced)
    assert counted["pdf_sample_kernel"] == STEPS
    assert step.graph_captures == CAPTURES and step.graph_replays == STEPS - len(KEYS)


@pytest.mark.gpu
def test_dropped_step_frees_its_graphs_on_card():
    """A step function that goes out of scope frees its graphs, and with
    them its pool, by reference counting alone (the offline loop builds a
    step a call): four steps in turn, each captured, then dropped, leave
    the card's allocated memory, and its reserved memory once the cache is
    released, where the first left them."""
    import gc

    dev = _card()
    cfg, cube, state, window, draws, mask = _setup(dev, FIELDS["fused_exact"])
    flags = _flags(0)
    gc.disable()
    try:
        allocated, reserved = [], []
        for _ in range(4):
            step = opt.make_train_step(cfg, cube, dev)
            s = state
            for i in range(3):
                s, _ = step(s, window, flags, mask, i, draws[i])
            assert step.graph_captures == 1
            del step, s
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            allocated.append(torch.cuda.memory_allocated())
            reserved.append(torch.cuda.memory_reserved())
    finally:
        gc.enable()
    assert allocated[-1] == allocated[0], allocated
    assert reserved[-1] == reserved[0], reserved


@pytest.mark.gpu
def test_capture_beside_a_synchronizing_thread_on_card():
    """A capture while another thread makes synchronizing calls on the card
    (the tracker's ICP solves beside the threaded mapper): the capture
    holds, and the other thread's calls raise nothing."""
    import threading

    dev = _card()
    cfg, cube, state, window, draws, mask = _setup(dev, FIELDS["cp"])
    step = opt.make_train_step(cfg, cube, dev)
    stop, errors = threading.Event(), []

    def solver():
        a = torch.eye(6, device=dev) * 2.0
        b = torch.ones(6, 1, device=dev)
        try:
            while not stop.is_set():
                float(torch.linalg.solve(a, b).sum())
        except Exception as err:  # noqa: BLE001: reported by the assertion below
            errors.append(err)

    thread = threading.Thread(target=solver)
    thread.start()
    try:
        for i in range(4):
            state, aux = step(state, window, _flags(0), mask, i, draws[i])
        torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive()
    assert errors == []
    assert (step.graph_captures, step.graph_replays) == (1, 3)
    assert bool(aux["finite"])
