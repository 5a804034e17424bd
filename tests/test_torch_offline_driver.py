"""The port's offline driver (loner_tpu_torch/optimize_implicit_map.py,
``python -m loner_tpu_torch.optimize_implicit_map``) against
examples/optimize_implicit_map.py on the CPU, on one sequence written to
disk: the files each writes, the world cube, the L1 histories, and the
checkpoint that ``load_run`` reads back."""
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from loner_tpu_torch import optimize_implicit_map
from loner_tpu_torch.data import dataset as tdataset
from loner_tpu_torch.runtime.run_io import load_run

import torch_parity as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: parallel test workers each running torch's
    default pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """The first 12 scans of a 36-pose loop of period 7.2 s (ground truth for
    all 36 poses)."""
    root = tmp_path_factory.mktemp("offline") / "seq"
    tdataset.write_synthetic_dataset(str(root), n_poses=36, period=7.2)
    for f in sorted(os.listdir(root / "scans"))[12:]:
        os.remove(root / "scans" / f)
    return root


def _tree(run_dir):
    """(files outside the checkpoints, checkpoint directories) under
    ``run_dir``: the two packages write a checkpoint's insides differently."""
    files, ckpts = set(), set()
    for d, dirs, fs in os.walk(run_dir):
        rel = os.path.relpath(d, run_dir)
        if any(part.startswith("ckpt_") for part in rel.split(os.sep)):
            continue
        ckpts |= {os.path.normpath(os.path.join(rel, n)) for n in dirs if n.startswith("ckpt_")}
        files |= {os.path.normpath(os.path.join(rel, f)) for f in fs}
    return files, ckpts


@pytest.mark.parametrize("submaps", [False, True])
def test_offline_driver_matches_jax(sequence, tmp_path, monkeypatch, submaps):
    """``python -m loner_tpu_torch.optimize_implicit_map`` (``main``) and
    examples/optimize_implicit_map.py on the same 12-scan sequence and cfg,
    cfg/synthetic_tiny.yaml with 64 + 8 rays a keyframe and 32 / 64 samples,
    2 epochs of windows of 4 with 2 steps a window and an L1 threshold that
    neither reaches (with ``--submaps``, one epoch in segments of 4 m, each
    holding every scan by the default 30-pose overlap): the same files
    and checkpoint directories, world_cube.yaml equal, the same number of
    finite L1 entries in each l1_history.json; ``load_run`` reads the port's
    single map back at its last step."""
    seq = sequence
    cfg = tmp_path / "offline.yaml"
    cfg.write_text(yaml.safe_dump({
        "baseline": os.path.join(REPO, "cfg", "synthetic_tiny.yaml"),
        "changes": {"mapper": {"optimizer": {
            "num_samples": {"lidar": 64, "sky": 8},
            "model_config": {"model": {"render": {"N_samples_train": 32, "N_samples_test": 64}}}}}},
    }))
    epochs = 1 if submaps else 2
    args = [str(cfg), "--dataset", str(seq), "--epochs", str(epochs), "--window", "4", "--its-per-window", "2",
            "--l1-threshold", "0.01"] + (["--submaps", "--segment-length", "4"] if submaps else [])
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    monkeypatch.setattr(sys, "argv", ["optimize_implicit_map.py", *args, "--out", str(jdir)])
    tp.load_example("optimize_implicit_map").main()
    res = optimize_implicit_map.main([*args, "--out", str(tdir), "--device", "cpu"])
    (files, ckpts), (jfiles, jckpts) = _tree(tdir), _tree(jdir)
    assert files == jfiles and ckpts == jckpts
    histories = sorted(f for f in files if f.endswith("l1_history.json"))
    assert len(histories) == (len(res[1]) if submaps else 1) and (len(histories) > 1) == submaps
    for f in histories:
        t, j = (yaml.safe_load((d / f).read_text()) for d in (tdir, jdir))
        assert len(t) == len(j) == epochs and np.all(np.isfinite(t)), f
    if submaps:
        return
    assert {"world_cube.yaml", "full_config.pkl"} <= files and ckpts == {f"checkpoints/ckpt_{res.iterations}"}
    assert yaml.safe_load((tdir / "world_cube.yaml").read_text()) == yaml.safe_load((jdir / "world_cube.yaml").read_text())
    assert res.epochs_run == 2 and res.iterations == 2 * 2 * 2
    _, cube, state = load_run(str(tdir), device="cpu")
    assert int(state.global_step) == res.iterations
    assert cube.as_dict() == yaml.safe_load((tdir / "world_cube.yaml").read_text())
