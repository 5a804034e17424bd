"""Loop closure of the PyTorch port against the JAX package: the
Gauss-Newton pose-graph solve on the fixed graphs of tests/test_pose_graph.py,
the candidate pairs, the ICP loop factors and the whole refinement on the
drifted loop of tests/test_loop_closure.py, and LonerSLAM.stop's refinement
with ba_info.json. A card test (marked ``gpu``) holds the solve on the card
against the CPU."""
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_pose_graph as jpg_tests
from loner_tpu.data.scan import make_lidar_scan as j_make_lidar_scan
from loner_tpu.geometry import se3 as jse3
from loner_tpu.mapping import keyframe as jkf
from loner_tpu.mapping import loop_closure as jlc
from loner_tpu.parallel import pose_graph as jpg
from loner_tpu.tracking import icp as jicp
from loner_tpu_torch.data import synthetic as tsyn
from loner_tpu_torch.data.scan import make_lidar_scan
from loner_tpu_torch.mapping import keyframe as tkf
from loner_tpu_torch.mapping import loop_closure as tlc
from loner_tpu_torch.parallel import pose_graph as tpg
from loner_tpu_torch.tracking import icp as ticp

from torch_parity import two_threads  # noqa: F401 (autouse: two torch threads)


def _pose6(Ts) -> np.ndarray:
    return np.stack([np.asarray(jse3.matrix_to_pose(jnp.asarray(T, jnp.float32))) for T in Ts])


def _graph(name):
    """(initial poses (K, 6), edges, priors or None, GN iterations) of the
    fixed graphs of tests/test_pose_graph.py, and the drifted chain with
    weak priors as the loop closure builds it."""
    if name == "perfect":
        gt, _ = jpg_tests.make_noisy_chain(8, drift=0.0)
        return _pose6(gt), jpg.odometry_factors_from_tracking(gt), None, 3
    if name == "anchor":
        _, est = jpg_tests.make_noisy_chain(8, drift=0.05)
        return _pose6(est), jpg.odometry_factors_from_tracking(est), None, 5
    gt, est = jpg_tests.make_noisy_chain(16, drift=0.08)
    edges = jpg.odometry_factors_from_tracking(est)
    edges.append((0, 15, np.linalg.inv(gt[0]) @ gt[15], 10.0))
    priors = [(i, est[i], 0.01) for i in range(16)] if name == "loop_priors" else None
    return _pose6(est), edges, priors, 10


@pytest.mark.parametrize("name", ["perfect", "loop", "anchor", "loop_priors"])
def test_solve_pose_graph_matches_jax(name):
    """The same graph through both solvers: refined poses within 1e-5 and
    the final cost within 1e-5 relative, with the factors' se3 vectors
    equal. A graph that its initial poses satisfy (perfect factors; the
    anchor case's odometry of its own poses) ends at a cost of rounding
    noise, under 1e-8 on both sides."""
    p0, edges, priors, iters = _graph(name)
    jf, tf = jpg.make_factors(edges), tpg.make_factors(edges)
    np.testing.assert_array_equal(tf.i.numpy(), np.asarray(jf.i))
    np.testing.assert_array_equal(tf.j.numpy(), np.asarray(jf.j))
    np.testing.assert_allclose(tf.z.numpy(), np.asarray(jf.z), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tf.weight.numpy(), np.asarray(jf.weight))
    jp = None if priors is None else jpg.make_priors(priors)
    tpr = None if priors is None else tpg.make_priors(priors)
    jr, jc = jpg.solve_pose_graph(jnp.asarray(p0), jf, n_iters=iters, priors=jp)
    tr, tc = tpg.solve_pose_graph(torch.as_tensor(p0), tf, n_iters=iters, priors=tpr)
    assert tr.dtype == torch.float32
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-5)
    if name in ("perfect", "anchor"):
        assert float(tc) < 1e-8 and float(jc) < 1e-8
    else:
        np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)


def test_padded_factors_and_the_mesh():
    """Padding (weight 0, indices 0) changes nothing; the sharded solve (the
    24 padded factors over a mesh of the CPU four times) gives the single
    solve within 1e-4, as tests/test_pose_graph.py:81 holds JAX's."""
    from loner_tpu_torch.parallel.sharding import make_mesh

    p0, edges, _, _ = _graph("loop")
    a, _ = tpg.solve_pose_graph(torch.as_tensor(p0), tpg.make_factors(edges), n_iters=5)
    b, cost_b = tpg.solve_pose_graph(torch.as_tensor(p0), tpg.make_factors(edges, n_pad=24), n_iters=5)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    c, cost_c = tpg.solve_pose_graph(torch.as_tensor(p0), tpg.make_factors(edges, n_pad=24), n_iters=5,
                                     mesh=make_mesh(4, device="cpu"))
    np.testing.assert_allclose(c.numpy(), b.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(cost_c), float(cost_b), rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _drifted_loop():
    """The drifted loop of tests/test_loop_closure.py: 24 keyframes on a
    closed circle, the tracked odometry with a per-step yaw and translation
    bias; keyframes of both packages over the same scans."""
    scene = tsyn.Scene.default()
    n = 24
    gt, ts = tsyn.circular_trajectory(n_poses=n, radius=5.0, z=1.5, period=24.0)
    bias = np.eye(4)
    yaw = np.deg2rad(0.5)
    bias[:3, :3] = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    bias[:3, 3] = [0.05, 0.0, 0.005]
    drifted = [gt[0]]
    for i in range(1, n):
        drifted.append(drifted[-1] @ (np.linalg.inv(gt[i - 1]) @ gt[i] @ bias))
    drifted = np.stack(drifted)
    jk, tk = [], []
    for i in range(n):
        dirs, dists, stamps, hit = tsyn.simulate_scan(scene, gt[i], ts[i], n_channels=12, n_azimuth=192,
                                                      max_range=40.0)
        args = (dirs[hit], dists[hit], stamps[hit])
        jk.append(jkf.KeyFrame(scan=j_make_lidar_scan(*args, pad_to=2048), timestamp=ts[i], pose_index=i,
                               tracked_pose=drifted[i], gt_pose=gt[i]))
        tk.append(tkf.KeyFrame(scan=make_lidar_scan(*args, pad_to=2048), timestamp=ts[i], pose_index=i,
                               tracked_pose=drifted[i], gt_pose=gt[i]))
    return jk, tk, gt, drifted


def _ate(poses, gt):
    return float(np.sqrt(np.mean(np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1) ** 2)))


LOOP_CFG = dict(enabled=True, min_index_gap=10, max_candidate_distance_m=5.0, max_candidates=8)


@pytest.mark.parametrize("cfg", [dict(min_index_gap=12), dict(min_index_gap=10, max_candidate_distance_m=5.0,
                                                              max_candidates=8),
                                 dict(min_index_gap=4, suppression_radius=0, max_candidates=40),
                                 dict(max_candidate_distance_m=0.01)])
def test_find_candidates_matches_jax(cfg):
    _, _, gt, drifted = _drifted_loop()
    for poses in (gt, drifted):
        j = jlc.find_candidates(poses[:, :3, 3], jlc.LoopClosureConfig(enabled=True, **cfg))
        t = tlc.find_candidates(poses[:, :3, 3], tlc.LoopClosureConfig(enabled=True, **cfg))
        assert t == j


@functools.lru_cache(maxsize=None)
def _refined():
    jk, tk, gt, drifted = _drifted_loop()
    j = jlc.refine_keyframe_poses(jk, drifted, jlc.LoopClosureConfig(**LOOP_CFG))
    t = tlc.refine_keyframe_poses(tk, drifted, tlc.LoopClosureConfig(**LOOP_CFG), device="cpu")
    return j, t


def test_refine_keyframe_poses_matches_jax():
    """The whole refinement on the drifted loop: the same number of loop
    closures and factors, refined poses within 1e-3 m (the ICP normals of
    collinear neighbourhoods differ between the packages, ROADMAP queue C),
    and the drift reduced as tests/test_loop_closure.py asserts: ATE under
    0.7x, the loop's end under 0.5x its drift."""
    _, _, gt, drifted = _drifted_loop()
    (jr, jinfo), (tr, tinfo) = _refined()
    assert tinfo["n_loop_closures"] == jinfo["n_loop_closures"] >= 1
    assert tinfo["n_factors"] == jinfo["n_factors"] == len(gt) - 1 + jinfo["n_loop_closures"]
    assert tr.dtype == np.float64 and tr.shape == (len(gt), 4, 4)
    np.testing.assert_allclose(tr[:, :3, 3], jr[:, :3, 3], rtol=0, atol=1e-3)
    np.testing.assert_allclose(tr[:, :3, :3], jr[:, :3, :3], rtol=0, atol=1e-3)
    assert np.isfinite(tinfo["final_cost"])
    assert _ate(tr, gt) < 0.7 * _ate(drifted, gt)
    end = float(np.linalg.norm(drifted[-1, :3, 3] - gt[-1, :3, 3]))
    assert float(np.linalg.norm(tr[-1, :3, 3] - gt[-1, :3, 3])) < 0.5 * end


def test_loop_factors_match_jax_with_the_jax_normals():
    """Each candidate pair's ICP: the accept decision of both packages, and,
    handed the JAX package's target normals, the port's Gauss-Newton steps
    give the JAX factor's T_rel within 1e-4. The accepted pairs lie away
    from the gates (fitness 0.35, rmse 0.3), where the normals difference
    cannot flip them."""
    jk, tk, _, drifted = _drifted_loop()
    cfg = jlc.LoopClosureConfig(**LOOP_CFG)
    icp = jicp.make_icp(cfg.icp)
    ic = cfg.icp
    pairs = jlc.find_candidates(drifted[:, :3, 3], cfg)
    tedges = tlc.generate_loop_factors(tk, drifted, tlc.LoopClosureConfig(**LOOP_CFG), device="cpu")
    jedges = jlc.generate_loop_factors(jk, drifted, cfg)
    assert [e[:2] for e in tedges] == [e[:2] for e in jedges]
    np.testing.assert_allclose([e[3] for e in tedges], [e[3] for e in jedges], rtol=1e-2)
    for (i, j), e in zip([e[:2] for e in jedges], jedges):
        src, sv = jlc._kf_cloud(jk[j], cfg.target_points)
        tgt, tv = jlc._kf_cloud(jk[i], cfg.target_points)
        T_init = np.linalg.inv(drifted[i]) @ drifted[j]
        _, rmse, fit = icp(jnp.asarray(src), jnp.asarray(sv), jnp.asarray(tgt), jnp.asarray(tv),
                           jnp.asarray(T_init, jnp.float32))
        assert float(fit) >= cfg.min_fitness + 0.05 and float(rmse) <= cfg.max_rmse - 0.05, (i, j, fit, rmse)
        jn = jicp.estimate_normals(jnp.asarray(tgt), jnp.asarray(tv), ic.stages[0].threshold, ic.normal_neighbors,
                                   ic.n_buckets, ic.bucket_slots)
        Tt = torch.as_tensor(T_init, dtype=torch.float32)
        for st in ic.stages:
            grid = ticp.build_voxel_grid(torch.from_numpy(tgt), torch.from_numpy(tv), st.threshold, ic.n_buckets,
                                         ic.bucket_slots)
            for _ in range(st.max_iterations):
                Tt, _, _ = ticp._gn_step(Tt, torch.from_numpy(src), torch.from_numpy(sv), grid,
                                         torch.from_numpy(np.array(jn)), st.threshold, ic.damping)
        np.testing.assert_allclose(Tt.numpy(), e[2], rtol=0, atol=1e-4)
    assert len(pairs) >= len(jedges) >= 1


def test_no_closures_keeps_the_poses():
    """No pair within the distance gate: no loop factor in either package,
    the same refined poses within 1e-4, near the drifted ones."""
    jk, tk, _, drifted = _drifted_loop()
    kw = dict(enabled=True, min_index_gap=10, max_candidate_distance_m=0.01)
    jr, ji = jlc.refine_keyframe_poses(jk, drifted, jlc.LoopClosureConfig(**kw))
    tr, ti = tlc.refine_keyframe_poses(tk, drifted, tlc.LoopClosureConfig(**kw), device="cpu")
    assert ti["n_loop_closures"] == ji["n_loop_closures"] == 0
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-4)
    assert _ate(tr, drifted) < 0.5


def test_loner_slam_refines_at_stop(tmp_path):
    """A small CPU LonerSLAM with loop closure on (``loop_closure`` is still
    importable from ``loner_tpu_torch.slam`` and built from the cfg):
    ``stop`` writes ba_info.json, and the refined poses reach the mapper's
    state and the keyframe trajectory file."""
    import torch_parity as tp
    from loner_tpu_torch.config import build as tbuild
    from loner_tpu_torch.config.settings import load_settings
    from loner_tpu_torch.runtime.trajectory_logger import load_tum
    from loner_tpu_torch.slam import LonerSLAM, LoopClosureConfig

    assert LoopClosureConfig is tlc.LoopClosureConfig
    settings = load_settings("cfg/defaults.yaml", overrides={"system": {"loop_closure": {"enabled": True,
                                                                                       "min_index_gap": 3}}})
    built = tbuild.build_loop_closure_config(settings)
    assert built == tlc.LoopClosureConfig(enabled=True, min_index_gap=3)

    from loner_tpu_torch.data.scan import LidarScan

    cfg, cube = tp.port_slam_config()
    cfg.loop_closure = built
    slam = LonerSLAM(cfg, cube, device="cpu")
    _, gt, ts, scans, skies = tp.loop_scans(15)
    for scan, sky, t0, g in zip(scans, skies, ts, gt):
        slam.process_scan(LidarScan(*scan), t0, gt_pose=g, sky=LidarScan(*sky))
    kfs = slam.mapper.kf_manager.keyframes
    before = np.stack([slam.mapper.optimized_pose(k) for k in kfs])
    slam.stop(str(tmp_path))
    info = json.loads((tmp_path / "ba_info.json").read_text())
    assert info == slam.ba_info and len(kfs) >= 3
    assert info["n_factors"] == len(kfs) - 1 + info["n_loop_closures"]
    after = np.stack([slam.mapper.optimized_pose(k) for k in kfs])
    assert np.all(np.isfinite(after)) and np.abs(after - before).max() < 0.1
    kf_traj, kf_t = load_tum(str(tmp_path / "trajectory" / "keyframe_trajectory.txt"))
    np.testing.assert_allclose(kf_traj[:, :3, 3], after[:, :3, 3], rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_solve_pose_graph_on_card_matches_cpu():
    """The refinement's solve on the card and on the CPU from the same
    factors and priors: poses within 1e-4 (f32 LAPACK on the host against
    the card's solver at anchor weight 1e6 and damping 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p0, edges, priors, iters = _graph("loop_priors")
    f, pr = tpg.make_factors(edges), tpg.make_priors(priors)
    cpu, c_cpu = tpg.solve_pose_graph(torch.as_tensor(p0), f, n_iters=iters, priors=pr)
    card, c_card = tpg.solve_pose_graph(torch.as_tensor(p0).cuda(), f, n_iters=iters, priors=pr)
    assert card.device.type == "cuda"
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(c_card), float(c_cpu), rtol=1e-4)
