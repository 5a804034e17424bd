"""The port's map-tool programs against the JAX package's ``examples/`` scripts
on the CPU: ``python -m loner_tpu_torch.render_map`` (lidar, mesh, depth and
video modes), ``compute_metrics`` (traj and map), ``plot_poses`` and
``summarize_results``, each ``main(argv)`` with ``--device cpu`` where it
takes one, over one map saved as a run directory of each package. The map
samples UNIFORM, so that both packages' renders draw nothing and see the
same samples; the OGM draws are held in tests/test_torch_analysis.py."""
import json
import os
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
import yaml

from loner_tpu_torch import compute_metrics, plot_poses, render_map, summarize_results
from loner_tpu_torch.runtime.trajectory_logger import dump_tum

import torch_parity as tp

two_threads = tp.two_threads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(root, JAX run directory, the port's run directory, TUM trajectory
    of 8 poses) of one UNIFORM map."""
    root = tmp_path_factory.mktemp("map_tools_cli")
    jdir, tdir, poses = tp.tiny_run_dirs(str(root), samples="UNIFORM")
    traj = str(root / "traj.txt")
    dump_tum(poses, np.arange(len(poses)) * 0.5, traj)
    return root, jdir, tdir, traj


def _example(name, argv, monkeypatch, capsys=None):
    """Run examples/<name>.py's ``main`` with ``argv``; its printed output."""
    module = tp.load_example(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    if capsys is not None:
        capsys.readouterr()
    module.main()
    return capsys.readouterr().out if capsys is not None else None


def _flat(d, prefix=""):
    """{"a.b": number} of a nested dict of numbers."""
    out = {}
    for k, v in d.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _ply(path):
    """(vertices (V, 3), faces (F, 3)) of an ASCII PLY file."""
    with open(path) as f:
        lines = f.read().splitlines()
    nv = int(next(line for line in lines if line.startswith("element vertex")).split()[-1])
    start = lines.index("end_header") + 1
    verts = np.loadtxt(lines[start:start + nv]).reshape(-1, 3)
    faces = np.loadtxt(lines[start + nv:], dtype=np.int64).reshape(-1, 4)[:, 1:]
    return verts, faces


def test_render_map_defaults_to_the_card(runs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, _, tdir, traj = runs
    with pytest.raises(RuntimeError, match="CUDA"):
        render_map.main(["lidar", "--run", tdir, "--poses", traj, "--out", "unused.pcd"])


def test_render_map_lidar_matches_the_example(runs, monkeypatch):
    """``lidar`` over every 4th pose: the same cloud as
    examples/render_map.py writes, point for point within 1e-4 m (the PCD
    keeps 6 decimals)."""
    root, jdir, tdir, traj = runs
    _example("render_map", ["lidar", "--run", jdir, "--poses", traj, "--out", str(root / "j.pcd")], monkeypatch)
    out = render_map.main(["lidar", "--run", tdir, "--poses", traj, "--out", str(root / "t.pcd"), "--device", "cpu"])
    j, t = compute_metrics.load_cloud(str(root / "j.pcd")), compute_metrics.load_cloud(str(root / "t.pcd"))
    assert out["points"] == len(t) == len(j) > 50
    order = lambda c: c[np.lexsort(np.round(c, 3).T)]  # noqa: E731
    np.testing.assert_allclose(order(t), order(j), rtol=0, atol=1e-4)
    header = lambda p: open(p).read().split("DATA ascii")[0]  # noqa: E731
    assert header(root / "t.pcd") == header(root / "j.pcd")
    render_map.main(["lidar", "--run", tdir, "--poses", traj, "--out", str(root / "t2.npy"), "--device", "cpu"])
    np.testing.assert_allclose(np.load(root / "t2.npy"), t, rtol=0, atol=1e-6)


def test_render_map_mesh_matches_the_example(runs, monkeypatch):
    """``mesh`` at resolution 48: the same faces and the vertices within
    1e-4 m of examples/render_map.py's mesh; the mesher's seconds by part."""
    root, jdir, tdir, traj = runs
    args = ["mesh", "--poses", traj, "--resolution", "48", "--skip-step", "4"]
    _example("render_map", [*args, "--run", jdir, "--out", str(root / "j.ply")], monkeypatch)
    out = render_map.main([*args, "--run", tdir, "--out", str(root / "t.ply"), "--device", "cpu"])
    (jv, jf), (tv, tf) = _ply(root / "j.ply"), _ply(root / "t.ply")
    assert out["vertices"] == len(tv) == len(jv) > 50 and out["faces"] == len(tf)
    assert set(out["timings"]) == {"render_s", "splat_s", "surface_nets_s"}
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["depth", "video"])
def test_render_map_images_match_the_example(runs, monkeypatch, mode):
    """``depth`` (with ``--rgb`` and ``--peak-consistency``) and ``video``
    (an interpolated path with a spin, as a GIF) at 12 x 16: the same files
    as examples/render_map.py writes, their pixels within one level (a depth
    an ulp apart can fall on the other side of a colormap step; counted:
    at most 1% of them)."""
    root, jdir, tdir, traj = runs
    if mode == "depth":
        args = ["depth", "--poses", traj, "--height", "12", "--width", "16", "--rgb", "--peak-consistency",
                "--skip-step", "3"]
        outs = (str(root / "jdepth"), str(root / "tdepth"))
    else:
        args = ["video", "--poses", traj, "--height", "12", "--width", "16", "--velocity", "8", "--fps", "2",
                "--spin-spacing-m", "4", "--spin-duration-s", "1", "--render-strategy", "adjusted"]
        outs = (str(root / "j.gif"), str(root / "t.gif"))
    _example("render_map", [*args, "--run", jdir, "--out", outs[0]], monkeypatch)
    res = render_map.main([*args, "--run", tdir, "--out", outs[1], "--device", "cpu"])
    if mode == "depth":
        files = sorted(os.listdir(outs[1]))
        assert files == sorted(os.listdir(outs[0])) and len(files) == 3 * res["images"] == 9
        pairs = [(os.path.join(outs[1], f), os.path.join(outs[0], f)) for f in files]
    else:
        assert res["frames"] > 4 and res["spins"] >= 1
        pairs = [outs[::-1]]
    for t, j in pairs:
        a, b = np.asarray(imageio.mimread(t), np.int64), np.asarray(imageio.mimread(j), np.int64)
        assert a.shape == b.shape
        diff = np.abs(a - b)
        assert diff.max() <= 1 and np.mean(diff > 0) <= 0.01, (t, diff.max(), np.mean(diff > 0))


def test_compute_metrics_matches_the_example(runs, monkeypatch, capsys):
    """``traj`` on a noisy copy of the trajectory and ``map`` on a shifted
    cloud: the same numbers as examples/compute_metrics.py within 1e-9
    (relative), written as yaml."""
    root, _, _, traj = runs
    from loner_tpu_torch.runtime.trajectory_logger import load_tum

    poses, ts = load_tum(traj)
    noisy = poses.copy()
    noisy[:, :3, 3] += np.random.default_rng(0).normal(0, 0.05, (len(poses), 3))
    dump_tum(noisy, ts, str(root / "est.txt"))
    rng = np.random.default_rng(1)
    np.save(root / "gt_cloud.npy", rng.uniform(-5, 5, (800, 3)))
    np.save(root / "est_cloud.npy", np.load(root / "gt_cloud.npy")[:600] + rng.normal(0, 0.02, (600, 3)))
    for argv in (["traj", "--est", str(root / "est.txt"), "--gt", traj],
                 ["map", "--est", str(root / "est_cloud.npy"), "--gt", str(root / "gt_cloud.npy"), "--no-realign"],
                 ["map", "--est", str(root / "est_cloud.npy"), "--gt", str(root / "gt_cloud.npy")]):
        _example("compute_metrics", [*argv, "--out", str(root / "j.yaml")], monkeypatch, capsys)
        res = compute_metrics.main([*argv, "--out", str(root / "t.yaml")])
        j, t = (yaml.safe_load((root / f"{p}.yaml").read_text()) for p in "jt")
        assert t == yaml.safe_load(yaml.safe_dump(res))
        ft, fj = _flat(t), _flat(j)
        assert ft.keys() == fj.keys()
        for k in fj:
            np.testing.assert_allclose(ft[k], fj[k], rtol=1e-9, atol=1e-12, err_msg=k)


def test_plot_poses_matches_the_example(runs, monkeypatch, capsys):
    """Both panels' plot written, and the same message (keyframes and
    optimized RMSE) as examples/plot_poses.py prints."""
    root, _, _, _ = runs
    run = root / "kf_run"
    os.makedirs(run / "checkpoints", exist_ok=True)
    k = 10
    gt = np.tile(np.eye(4), (k, 1, 1))
    gt[:, 0, 3] = np.linspace(0, 5, k)
    opt = gt.copy()
    opt[:, 1, 3] += 0.05
    np.savez(run / "checkpoints" / "kf_poses.npz", timestamps=np.linspace(0, 9, k), tracked=opt + 0.01, optimized=opt,
             has_gt=np.ones(k, bool), gt=gt)
    for extra in ([], ["--plot-tracked", "--title", "loop"]):
        jout = _example("plot_poses", [str(run), *extra, "--out", str(root / "j.png")], monkeypatch, capsys)
        res = plot_poses.main([str(run), *extra, "--out", str(root / "t.png")])
        tout = capsys.readouterr().out
        assert tout.replace("t.png", "X") == jout.replace("j.png", "X")
        assert res[0]["keyframes"] == k and abs(res[0]["rmse"] - 0.05) < 1e-12
        assert imageio.imread(root / "t.png").shape == imageio.imread(root / "j.png").shape


def test_summarize_results_matches_the_example(runs, monkeypatch, capsys):
    """A tree of two configurations (two trials, and one run with an L1
    history): the same table and CSV as examples/summarize_results.py."""
    root, _, _, _ = runs
    tree = root / "tree"
    rng = np.random.default_rng(2)
    for rel in ("config_0_a/trial_0", "config_0_a/trial_1", "config_1_b"):
        d = tree / rel
        os.makedirs(d, exist_ok=True)
        (d / "ate.yaml").write_text(yaml.safe_dump({"rmse": float(rng.uniform(0.05, 0.3)), "n": 12}))
        (d / "runtime.txt").write_text(f"{rng.uniform(10, 40):.3f}\n")
    (tree / "config_1_b" / "l1_history.json").write_text(json.dumps([2.0, 1.2, 0.9]))
    jout = _example("summarize_results", [str(tree), "--csv", str(root / "j.csv")], monkeypatch, capsys)
    res = summarize_results.main([str(tree), "--csv", str(root / "t.csv")])
    tout = capsys.readouterr().out
    assert tout.replace("t.csv", "X") == jout.replace("j.csv", "X")
    assert (root / "t.csv").read_text() == (root / "j.csv").read_text()
    assert sorted(res) == ["config_0_a", "config_1_b"] and res["config_1_b"]["l1_final"] == (0.9, 0.0)
