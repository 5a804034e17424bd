"""The port's debug dumps against the JAX package on the CPU: the PCD writer
and reader, the mapper's debug probe (``make_debug_probe``) from the JAX
state with the JAX draws, the window dump's files, and a tiny ``LonerSLAM``
run with every dump flag on, which writes what tests/test_debug_dumps.py
expects (loner_tpu_torch/runtime/debug_dump.py, mapping/optimizer.py,
mapping/mapper.py, tracking/tracker.py)."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loner_tpu.mapping import optimizer as jopt
from loner_tpu.runtime import debug_dump as jdump
from loner_tpu_torch.convert import state_from_jax
from loner_tpu_torch.data import synthetic
from loner_tpu_torch.data.scan import make_lidar_scan
from loner_tpu_torch.flagship import flagship
from loner_tpu_torch.geometry.world_cube import compute_world_cube
from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.mapping.keyframe_manager import KeyFrameManagerConfig
from loner_tpu_torch.mapping.mapper import IterationPhase, OnlineMapperConfig, SchedulePhase
from loner_tpu_torch.models.nerf import NeRFConfig
from loner_tpu_torch.models.occupancy_grid import OccGridConfig
from loner_tpu_torch.ops.triad_field import TriadConfig
from loner_tpu_torch.runtime import debug_dump as tdump
from loner_tpu_torch.slam import LonerSLAM, SlamConfig
from loner_tpu_torch.tracking.icp import IcpConfig, IcpStage
from loner_tpu_torch.tracking.tracker import TrackerConfig

import torch_parity as tp

two_threads = tp.two_threads
KEY = jax.random.PRNGKey(13)
FLAGS = dict(global_enabled=True, draw_icp_clouds=True, draw_rays=True, draw_samples=True,
             draw_loss_distribution=True)


def test_write_pcd_is_byte_equal_to_jax_and_reads_back(tmp_path):
    """The same bytes as the JAX writer with and without intensity, and
    ``read_pcd`` gives the rows back (within the 6 decimals written)."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    inten = np.linspace(0, 1, 100, dtype=np.float32)
    for name, kw in (("xyz", {}), ("xyzi", dict(intensity=inten))):
        jdump.write_pcd(str(tmp_path / "j" / f"{name}.pcd"), pts, **kw)
        tdump.write_pcd(str(tmp_path / "t" / f"{name}.pcd"), pts, **kw)
        assert (tmp_path / "t" / f"{name}.pcd").read_bytes() == (tmp_path / "j" / f"{name}.pcd").read_bytes()
    back = tdump.read_pcd(str(tmp_path / "t" / "xyzi.pcd"))
    assert back.shape == (100, 4)
    np.testing.assert_allclose(back, np.concatenate([pts, inten[:, None]], axis=1), atol=1e-6)
    np.testing.assert_array_equal(back, jdump.read_pcd(str(tmp_path / "j" / "xyzi.pcd")))


def test_debug_flags_match_jax():
    """``on`` and ``mapper_any`` as the JAX package's: everything gated by
    ``global_enabled`` and a dump directory."""
    for kw in ({}, dict(FLAGS), dict(FLAGS, dump_dir="d"), dict(draw_rays=True, dump_dir="d"),
               dict(global_enabled=True, draw_icp_clouds=True, dump_dir="d")):
        j, t = jdump.DebugFlags(**kw), tdump.DebugFlags(**kw)
        assert t.mapper_any == j.mapper_any
        for name in ("draw_icp_clouds", "draw_rays", "draw_samples", "draw_loss_distribution"):
            assert t.on(name) == j.on(name)


@pytest.mark.parametrize("samples", ["OGM", "UNIFORM"])
def test_debug_probe_matches_jax(samples):
    """The probe from the JAX state with the JAX draws (the probe splits its
    key as the train step does): origins, endpoints and sample points within
    1e-6 (the ray bound of tests/test_torch_train_step.py), weights
    normwise within 1e-5 (its f32 bound), the per-ray depth error, JS and
    LOS terms within rtol 1e-4 / atol 1e-6 (its bound on the loss terms),
    the valid mask equal."""
    jcfg, jcube, jstate, jwin = tp.jax_flagship_tiny("float32")
    occ = np.random.default_rng(0).normal(0, 3, jstate.occ_grid.shape).astype(np.float32)
    jstate = jstate._replace(occ_grid=jnp.asarray(occ))
    jcfg = jcfg._replace(samples_strategy=samples)
    _, tcfg = tp.mapper_configs(float(jcube.scale_factor))
    tcfg = tcfg._replace(samples_strategy=samples)
    _, tcube, _, twin = flagship(device="cpu", cfg=tcfg, **tp.SCAN)
    j = tp.np_tree(jopt.make_debug_probe(jcfg, jcube)(jstate, jwin, KEY, 0))
    draws = tp.torch_draws(tp.jax_step_draws(KEY, jcfg, jwin))
    t = topt.make_debug_probe(tcfg, tcube, device="cpu")(state_from_jax(tp.np_tree(jstate), device="cpu"), twin,
                                                        draws, 0)
    assert sorted(t) == sorted(j)
    n, s = tcfg.rays_per_window, tcfg.n_samples_train
    assert t["points"].shape == (n, s, 3) and t["weights"].shape == (n, s) and t["depth_err"].shape == (n,)
    np.testing.assert_array_equal(tp.t2n(t["valid"]), j["valid"])
    for k in ("origins", "endpoints", "points"):
        np.testing.assert_allclose(tp.t2n(t[k]), j[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert tp.rel_err(t["weights"], j["weights"]) <= 1e-5
    v = j["valid"]
    for k in ("depth_err", "js", "los"):
        np.testing.assert_allclose(tp.t2n(t[k])[v], j[k][v], rtol=1e-4, atol=1e-6, err_msg=k)


def test_dump_window_probe_writes_what_jax_writes(tmp_path):
    """The same probe arrays through both packages' window dump: the same
    files, the PCD files byte-equal, the npz arrays equal."""
    rng = np.random.default_rng(1)
    n, s = 40, 8
    probe = {"origins": rng.uniform(-1, 1, (n, 3)), "endpoints": rng.uniform(-1, 1, (n, 3)),
             "points": rng.uniform(-1, 1, (n, s, 3)), "weights": rng.uniform(0, 1, (n, s)),
             "valid": rng.uniform(size=n) > 0.3, "depth_err": rng.normal(size=n), "js": rng.uniform(size=n),
             "los": rng.uniform(size=n)}
    probe = {k: v.astype(np.float32) if v.dtype != bool else v for k, v in probe.items()}
    shift = np.array([0.5, -1.0, 2.0])
    for mod, name in ((jdump, "j"), (tdump, "t")):
        mod.dump_window_probe(mod.DebugFlags(**FLAGS, dump_dir=str(tmp_path / name)), "keyframe_3", probe, 20.0,
                              shift)
    files = sorted(os.listdir(tmp_path / "t" / "keyframe_3"))
    assert files == sorted(os.listdir(tmp_path / "j" / "keyframe_3"))
    assert {"ray_origins.pcd", "ray_endpoints.pcd", "sample_points.pcd", "loss_distribution.npz"} <= set(files)
    for f in files:
        tf, jf = tmp_path / "t" / "keyframe_3" / f, tmp_path / "j" / "keyframe_3" / f
        if f.endswith(".pcd"):
            assert tf.read_bytes() == jf.read_bytes(), f
        elif f.endswith(".npz"):
            zt, zj = np.load(tf), np.load(jf)
            assert sorted(zt.files) == sorted(zj.files)
            for k in zj.files:
                np.testing.assert_array_equal(zt[k], zj[k])


def test_debug_dumps_land_in_run_dir(tmp_path):
    """The run of tests/test_debug_dumps.py (6 poses, 8 x 128 scans, windows
    of 2, 3 pose-frozen steps a keyframe, every dump flag on) through the
    port's LonerSLAM, with the triad field: ICP clouds for each
    registration, ray and sample clouds and the loss distribution for each
    window, shaped as that test asks."""
    poses, ts = synthetic.circular_trajectory(n_poses=6, radius=5.0, z=1.5, period=6.0)
    cube = compute_world_cube(poses, ray_range=(1.0, 40.0), rebase_to_first_pose=True)
    mapper_cfg = topt.MapperConfig(
        nerf=NeRFConfig(num_colors=1, triad=TriadConfig(cp_resolutions=(8, 16), cp_features=4, fourier_freqs=2),
                        sigma_hidden_dim=16, intensity_hidden_dim=16, intensity_hidden_layers=1),
        occ=OccGridConfig(voxel_size=16), ray_range=(1.0, 40.0), world_scale=float(cube.scale_factor),
        window_size=2, max_keyframes=16, rays_per_kf=64, sky_rays_per_kf=8, n_samples_train=32, n_samples_test=32)
    out_dir = str(tmp_path / "run")
    slam = LonerSLAM(SlamConfig(
        tracker=TrackerConfig(icp=IcpConfig(stages=(IcpStage(1.5, 4),), n_buckets=1 << 10), target_points=1024,
                              motion_compensation=False),
        mapper=OnlineMapperConfig(
            mapper=mapper_cfg, keyframe_manager=KeyFrameManagerConfig(time_diff_seconds=1.0, window_size=2),
            schedule=[SchedulePhase(-1, [IterationPhase(3, freeze_poses=True)])], n_sky_pad=64,
            debug=tdump.DebugFlags(**FLAGS)),
        single_threaded=True), cube, out_dir=out_dir, device="cpu")
    scene = synthetic.Scene.default()
    for T, t0 in zip(poses, ts):
        dirs, dists, stamps, hit = synthetic.simulate_scan(scene, T, t0, n_channels=8, n_azimuth=128, max_range=40.0)
        slam.process_scan(make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=1536), t0, gt_pose=T)
    slam.stop(out_dir)

    dbg = os.path.join(out_dir, "debug")
    frames = sorted(glob.glob(os.path.join(dbg, "frame_*")))
    assert [os.path.basename(f) for f in frames] == [f"frame_{i}" for i in range(1, 6)]
    for f in frames:
        assert sorted(os.listdir(f)) == ["icp_aligned.pcd", "icp_input.pcd", "icp_target.pcd"]
    a = tdump.read_pcd(os.path.join(frames[0], "icp_aligned.pcd"))
    assert a.shape[1] == 3 and len(a) > 10
    windows = sorted(glob.glob(os.path.join(dbg, "keyframe_*")))
    assert len(windows) == len(slam.mapper.kf_manager) >= 2
    r = tdump.read_pcd(os.path.join(windows[0], "ray_endpoints.pcd"))
    assert r.shape[1] == 4 and np.linalg.norm(r[:, :3], axis=1).max() < 100.0
    s = tdump.read_pcd(os.path.join(windows[0], "sample_points.pcd"))
    assert s.shape[1] == 4 and len(s) > 100
    z = np.load(os.path.join(windows[0], "loss_distribution.npz"))
    assert {"depth_err_m", "js", "los", "valid"} <= set(z.files)
    assert z["depth_err_m"].shape == (mapper_cfg.rays_per_window,)
    assert np.isfinite(z["depth_err_m"][z["valid"] > 0]).all()
    assert os.path.exists(os.path.join(windows[0], "loss_distribution.png"))
