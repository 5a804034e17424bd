"""The quality experiments (loner_tpu_torch/experiments/) against
the JAX package's scripts (scripts/exp_encoder_flagship.py,
scripts/exp_quality_flagship.py) on the CPU: the encoder experiment builds the
keyframes, cube, mapper and offline configs that the script builds from the
same calls (the script's main run with the offline loop replaced by a
recorder), every spec parses as the script's loop parses it, and both
experiments' small CPU forms write their scripts' keys."""
import argparse
import dataclasses
import json
import math

import numpy as np
import pytest

from loner_tpu_torch.experiments import exp_encoder_flagship as enc
from loner_tpu_torch.experiments import exp_quality_flagship as quality

import torch_parity as tp
from torch_parity import two_threads  # noqa: F401 (autouse: two torch threads)

KFS = 8
# the script's docstring and its record's not_run list, and the forms the
# port's runs use
SPECS = ["triad", "fused", "cell", "triad_nohash", "triad:cp=bf16", "triad:cp=bf16,hash=0",
         "triad_nohash:fourier=8", "triad:hlog2=14", "triad:hash=1", "triad:cpf=8", "packed", "exact"]
# the keys of the scripts' records
ENCODER_RECORD = {"l1_history_m", "final_l1_m", "epochs", "iterations", "wall_time_s"}
ENCODER_PAYLOAD = {"experiment", "scene", "ray_range", "platform", "results"}
ONLINE_RECORD = {"n_scans", "wall_time_s", "ate_tracking_only_m", "ate_estimated_m", "ba", "median_its_per_sec"}


class _Specs(str):
    """An ``--encoders`` value whose ``split(",")`` gives ``specs`` whole, so
    that the script's loop meets specs that themselves hold commas."""

    def __new__(cls, specs):
        obj = super().__new__(cls, "unused")
        obj.specs = list(specs)
        return obj

    def split(self, sep=None, maxsplit=-1):
        return list(self.specs)


def _run_script(specs, out) -> list:
    """The script's main at ``--small --kfs 8 --max-epochs 1`` over
    ``specs``, its offline loop replaced by a recorder: the (cfg, cube,
    keyframes, offline) it hands the loop, per spec."""
    from loner_tpu.mapping import offline as joffline

    script = tp.load_script("exp_encoder_flagship")
    calls = []

    def record(cfg, cube, keyframes, offline, log_fn=None):
        calls.append((cfg, cube, keyframes, offline))
        return joffline.OfflineResult(state=None, l1_history=[1.0], epochs_run=1, iterations=0)

    args = argparse.Namespace(cpu=False, trees=80, kfs=KFS, extent=40.0, encoders=_Specs(specs), max_epochs=1,
                              point_chunks=2, small=True, out=str(out))
    saved = joffline.optimize_implicit_map, argparse.ArgumentParser.parse_args
    joffline.optimize_implicit_map = record
    argparse.ArgumentParser.parse_args = lambda self, *a, **k: args
    try:
        script.main()
    finally:
        joffline.optimize_implicit_map, argparse.ArgumentParser.parse_args = saved
    return calls


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """{spec: (cfg, cube, keyframes, offline)} as the script builds them."""
    calls = _run_script(SPECS, tmp_path_factory.mktemp("jax_encoder") / "out.json")
    assert len(calls) == len(SPECS)
    return dict(zip(SPECS, calls))


def _same(t, j, path):
    """The port's config ``t`` equals the JAX package's ``j``, field by field,
    value and type."""
    if dataclasses.is_dataclass(j) or hasattr(j, "_fields"):
        names = [f.name for f in dataclasses.fields(j)] if dataclasses.is_dataclass(j) else list(j._fields)
        for name in names:
            assert hasattr(t, name), f"{path}.{name} is not in the port"
            _same(getattr(t, name), getattr(j, name), f"{path}.{name}")
        return
    if isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _same(a, b, f"{path}[{i}]")
        return
    assert type(t) is type(j) and t == j, f"{path}: {t!r} != {j!r}"


def test_keyframes_and_cube_equal_the_scripts(jax_side):
    _, jcube, jkfs, _ = jax_side["triad"]
    kfs, cube = enc.forest_keyframes(kfs=KFS, small=True)
    assert len(kfs) == len(jkfs) == KFS
    for name in ("scale_factor", "shift"):
        np.testing.assert_allclose(np.asarray(getattr(cube, name)), np.asarray(getattr(jcube, name)), rtol=1e-6)
    for t, j in zip(kfs, jkfs):
        assert (t.timestamp, t.pose_index) == (float(j.timestamp), j.pose_index)
        np.testing.assert_array_equal(t.gt_pose, j.gt_pose)
        np.testing.assert_array_equal(t.tracked_pose, j.tracked_pose)
        for field in j.scan._fields:
            np.testing.assert_array_equal(np.asarray(getattr(t.scan, field)), np.asarray(getattr(j.scan, field)),
                                          err_msg=field)
            np.testing.assert_array_equal(np.asarray(getattr(t.sky, field)), np.asarray(getattr(j.sky, field)),
                                          err_msg=f"sky {field}")
        np.testing.assert_array_equal(t.band_indices, np.asarray(j.band_indices))


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parses_as_the_scripts_loop(jax_side, spec):
    """The mapper config of each spec and the offline protocol equal those
    the script builds."""
    jcfg, jcube, _, joff = jax_side[spec]
    cfg = enc.mapper_config(spec, jcube, KFS, small=True)
    assert cfg.world_scale == float(jcube.scale_factor)
    _same(cfg, jcfg, spec)
    _same(enc.offline_config(1), joff, "offline")


def test_unknown_knob_raises(tmp_path):
    from loner_tpu.geometry.world_cube import compute_world_cube

    with pytest.raises(ValueError, match="unknown triad knob 'bogus'"):  # the script's loop
        _run_script(["triad:bogus=1"], tmp_path / "out.json")

    cube = compute_world_cube(np.eye(4)[None], ray_range=enc.RAY_RANGE, rebase_to_first_pose=False)
    with pytest.raises(ValueError, match="unknown triad knob 'bogus'"):
        enc.mapper_config("triad:bogus=1", cube)
    with pytest.raises(ValueError, match="unknown triad knob"):
        enc.mapper_config("triad_nohash:hash=1,res=3", cube)


def test_encoders_flag_keeps_multi_knob_specs_whole():
    assert enc.split_specs("triad,fused,cell") == ["triad", "fused", "cell"]
    assert enc.split_specs("triad:cp=bf16,hash=0,fused,triad:hash=1") == ["triad:cp=bf16,hash=0", "fused",
                                                                          "triad:hash=1"]


def test_encoder_experiment_small_cpu_writes_the_scripts_keys(tmp_path):
    out = tmp_path / "enc.json"
    payload = enc.main(["--small", "--device", "cpu", "--kfs", str(KFS), "--max-epochs", "1",
                        "--encoders", "triad_nohash", "--out", str(out)])
    assert json.loads(out.read_text()) == payload
    assert ENCODER_PAYLOAD <= set(payload) and payload["platform"] == "cpu"
    rec = payload["results"]["triad_nohash"]
    assert ENCODER_RECORD <= set(rec)
    assert rec["epochs"] == len(rec["l1_history_m"]) == 1 and rec["iterations"] == 32
    assert math.isfinite(rec["final_l1_m"]) and rec["final_l1_m"] == rec["l1_history_m"][-1]
    assert rec["gate_1p05m"] in ("PASS", "FAIL") and rec["train_ms_per_step"] > 0
    assert rec["launches"] == {k: 0 for k in ("cp_fwd", "cp_bwd", "pdf_sample", "interp_fwd", "interp_dpts")}


def test_quality_experiment_online_half_writes_the_scripts_keys(tmp_path):
    """The online half on a 36-scan lap at the small sizes; the offline
    half is the encoder experiment's (tested above)."""
    out = tmp_path / "quality.json"
    payload = quality.main(["--small", "--device", "cpu", "--n-poses", "36", "--skip-offline",
                            "--run-dir", str(tmp_path / "run"), "--out", str(out)])
    assert json.loads(out.read_text()) == payload
    assert {"experiment", "platform", "online"} <= set(payload) and "offline" not in payload
    online = payload["online"]
    assert ONLINE_RECORD <= set(online) and online["n_scans"] == 36
    assert all(math.isfinite(online[k]) for k in ("ate_tracking_only_m", "ate_estimated_m", "median_its_per_sec"))
    assert online["keyframe_spacing_s"] == 1.5
    assert (tmp_path / "run" / "run" / "trajectory" / "tracking_only.txt").exists()


def test_quality_experiment_offline_half_is_the_encoder_triad():
    rec = quality.run_offline("cpu", small=True)
    assert ENCODER_RECORD <= set(rec) and rec["iterations"] == 32 and math.isfinite(rec["final_l1_m"])


class _Stop(Exception):
    pass


def test_quality_experiment_changes_defaults_as_the_script(tmp_path, monkeypatch):
    """The online half's changes to cfg/defaults.yaml equal those the
    script's ``run_online`` hands ``load_settings`` (its sequence directory
    made beforehand, so that it writes none; stopped there)."""
    from loner_tpu.config import settings as jsettings

    from loner_tpu_torch.config.settings import load_settings

    script = tp.load_script("exp_quality_flagship")
    seen = []

    def record(path, overrides=None):
        seen.append((path, overrides))
        raise _Stop

    monkeypatch.setattr(jsettings, "load_settings", record)
    (tmp_path / "seq" / "scans").mkdir(parents=True)
    monkeypatch.syspath_prepend(str(quality.REPO))
    with pytest.raises(_Stop):
        script.run_online(str(tmp_path), 126)
    assert seen == [("cfg/defaults.yaml", quality.ONLINE_OVERRIDES)]
    s = quality.online_settings()
    assert s.to_dict() == load_settings(str(quality.REPO / "cfg" / "defaults.yaml"),
                                        overrides=quality.ONLINE_OVERRIDES).to_dict()
    assert s.mapper.keyframe_manager.keyframe_selection.temporal.time_diff_seconds == 1.5
    over = quality.online_settings(overrides={
        "mapper": {"keyframe_manager": {"keyframe_selection": {"temporal": {"time_diff_seconds": 0.75}}}}})
    assert over.mapper.keyframe_manager.keyframe_selection.temporal.time_diff_seconds == 0.75
    assert over.data.scan_points_budget == 16384 and over.system.loop_closure.enabled
