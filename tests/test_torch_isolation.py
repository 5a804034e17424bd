"""The PyTorch port stands alone: no module of loner_tpu_torch imports JAX or
the JAX package, its entry points and public constructors (the mesh's too)
default to the card and raise without one (no CPU fallback), the encoders
and SLAM options once refused (the alternate encoders, the device split
and the mesh forms) run, and every C entry the kernel loader binds is
defined in the CUDA sources."""
import ast
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import numpy as np

import loner_tpu_torch
from loner_tpu_torch import bench, optimize_implicit_map, run_slam
from loner_tpu_torch.data import synthetic
from loner_tpu_torch.data.scan import make_lidar_scan
from loner_tpu_torch.flagship import flagship
from loner_tpu_torch.geometry.world_cube import compute_world_cube
from loner_tpu_torch.mapping import camera_optimizer as tcam
from loner_tpu_torch.mapping import keyframe as tkf
from loner_tpu_torch.mapping import loop_closure as tlc
from loner_tpu_torch.mapping import mapper as tmapper
from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.models import mlp as tmlp
from loner_tpu_torch.models import nerf as tnerf
from loner_tpu_torch.models import occupancy_grid as tocc
from loner_tpu_torch.ops import cp_kernel as tcp
from loner_tpu_torch.ops import fused_encoder as tfe
from loner_tpu_torch.ops import kernels as tkernels
from loner_tpu_torch.ops import triad_field as ttriad
from loner_tpu_torch.runtime.debug_dump import DebugFlags
from loner_tpu_torch.runtime.run_io import load_run
from loner_tpu_torch.slam import LonerSLAM, LoopClosureConfig, SlamConfig
from loner_tpu_torch.tracking import icp as ticp
from loner_tpu_torch.tracking.tracker import Tracker, TrackerConfig

PKG = Path(loner_tpu_torch.__file__).resolve().parent
MODULES = sorted(
    ".".join(("loner_tpu_torch",) + p.relative_to(PKG).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'loner_tpu', 'optax'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=PKG.parent, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 20
    assert {"loner_tpu_torch.models.hash_encoding", "loner_tpu_torch.ops.hash_encode_fast",
            "loner_tpu_torch.ops.cell_hash", "loner_tpu_torch.data.rosbag_convert",
            "loner_tpu_torch.runtime.native", "loner_tpu_torch.parallel.sharding", "loner_tpu_torch.parallel.tp",
            "loner_tpu_torch.parallel.submaps_parallel", "loner_tpu_torch.multichip"} <= set(MODULES)


def test_sources_never_name_jax_or_the_jax_package():
    for path in [*PKG.rglob("*.py"), PKG.parent / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "optax", "loner_tpu"), f"{path}: imports {name}"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = topt.MapperConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        topt.init_mapper_state(None, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        topt.make_train_step(cfg, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship()
    # the online SLAM loop's entry points
    cube = compute_world_cube(None, (1.0, 40.0), traj_bounding_box=dict(x=[-5, 5], y=[-5, 5], z=[-1, 1]))
    for make in (lambda: LonerSLAM(SlamConfig(), cube), lambda: Tracker(TrackerConfig()),
                 lambda: tmapper.OnlineMapper(tmapper.OnlineMapperConfig(), cube),
                 lambda: ticp.make_icp(ticp.IcpConfig()),
                 lambda: ticp.icp_point_to_plane(torch.zeros((4, 3)), torch.zeros((4, 3)))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # the camera phase and the loop closure
    ones = np.ones((1, 2, 2, 1), np.float32)
    for make in (lambda: tcam.make_camera_train_step(cfg, cube),
                 lambda: tcam.stack_camera_window(ones, ones[..., 0] > 0, np.eye(4)[None], np.eye(3)),
                 lambda: tcam.optimize_intensity(cfg, cube, None, None),
                 lambda: tlc.refine_keyframe_poses([], np.zeros((0, 4, 4)), tlc.LoopClosureConfig()),
                 lambda: tlc.generate_loop_factors([], np.zeros((0, 4, 4)), tlc.LoopClosureConfig())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # the users' drivers, the run loader and the eval render
    for make in (lambda: run_slam.main(["cfg/synthetic_tiny.yaml", "--synthetic"]),
                 lambda: optimize_implicit_map.main(["cfg/synthetic_tiny.yaml", "--synthetic"]),
                 lambda: bench.main([]), lambda: load_run("no_such_run"), lambda: topt.make_render_fn(cfg),
                 lambda: topt.make_debug_probe(cfg, cube),
                 lambda: run_slam.run_trial(None, None, "unused", False)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # the mesh's entry points
    from loner_tpu_torch import multichip
    from loner_tpu_torch.parallel import sharding, submaps_parallel, tp

    for make in (lambda: sharding.make_mesh(), lambda: sharding.make_mesh(2), lambda: tp.make_dp_tp_mesh(),
                 lambda: sharding.Mesh(["cuda:0"] * 2, ("data",)), lambda: multichip.main([]),
                 lambda: multichip.main(["4", "--device", "cuda:0"]),
                 lambda: submaps_parallel.make_submap_parallel_step(cfg, cube),
                 lambda: submaps_parallel.init_stacked_states(None, cfg, 2),
                 lambda: submaps_parallel.optimize_submaps_parallel(cfg, cube, [], [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # the public constructors too
    gen = torch.Generator()
    small = tnerf.NeRFConfig(triad=ttriad.TriadConfig(cp_resolutions=(4,), cp_features=2, hash_levels=1, hash_features=2))
    constructors = [
        lambda: tnerf.init_nerf(gen, small),
        lambda: ttriad.init_triad(gen, small.triad),
        lambda: tmlp.init_mlp(gen, tmlp.MLPConfig(in_dim=3, out_dim=1)),
        lambda: tocc.init_occ_grid(tocc.OccGridConfig(voxel_size=4)),
        lambda: tcp.init_cp_lines(gen, (4,), 2),
        lambda: tfe.init_fused_table(gen, tfe.FusedHashConfig(n_levels=1, log2_cells=8)),
        lambda: tkf.stack_window([]),
    ]
    for make in constructors:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def _slam(**changes):
    """A small LonerSLAM on the CPU with ``changes`` applied to its config:
    {"mapper.camera.enabled": True, ...}."""
    cfg = SlamConfig(mapper=tmapper.OnlineMapperConfig(mapper=topt.MapperConfig(
        nerf=tnerf.NeRFConfig(triad=ttriad.TriadConfig(cp_resolutions=(4,), cp_features=2)), max_keyframes=4,
        occ=tocc.OccGridConfig(voxel_size=4))))
    for path, value in changes.items():
        *parents, leaf = path.split(".")
        node = cfg
        for p in parents:
            node = getattr(node, p)
        if hasattr(node, "_replace"):  # a named tuple: replace it in its parent
            parent = cfg
            for p in parents[:-1]:
                parent = getattr(parent, p)
            setattr(parent, parents[-1], node._replace(**{leaf: value}))
        else:
            setattr(node, leaf, value)
    cube = compute_world_cube(None, (1.0, 40.0), traj_bounding_box=dict(x=[-5, 5], y=[-5, 5], z=[-1, 1]))
    return LonerSLAM(cfg, cube, device="cpu")


# the online camera phase: a 4 x 6 intrinsics of 2 steps of 32 rays a window
CAMERA = tmapper.OnlineCameraConfig(enabled=True, K=np.array([[3.0, 0, 3], [0, 3, 2], [0, 0, 1]]),
                                    iterations_per_window=2, n_rays=32)
# options that raised until the offline slice (rays, samples), the loop
# closure and camera slice (camera, loop_closure), the map tools and debug
# dumps slice (debug_*) and the multi-device slice (device_split,
# mapper_mesh, tracker_device_index) ported them: each now builds and maps
# one keyframe
PORTED_SLAM = {
    "device_split": {"concurrent_device_split": True},
    "mapper_mesh": {"mapper.mesh_device_indices": [1, 2]},
    "tracker_device_index": {"tracker.device_index": 0},
    "rays_mask": {"mapper.mapper.rays_strategy": "MASK"},
    "rays_fixed": {"mapper.mapper.rays_strategy": "FIXED"},
    "samples_uniform": {"mapper.mapper.samples_strategy": "UNIFORM"},
    "camera": {"mapper.camera": CAMERA},
    "loop_closure": {"loop_closure": LoopClosureConfig(enabled=True)},
    "debug_icp_clouds": {"mapper.debug": DebugFlags(global_enabled=True, draw_icp_clouds=True)},
    "debug_rays": {"mapper.debug": DebugFlags(global_enabled=True, draw_rays=True)},
}


def _scan(pose, t):
    dirs, dists, stamps, hit = synthetic.simulate_scan(synthetic.Scene.default(), pose, t, n_channels=8,
                                                       n_azimuth=32, max_range=40.0)
    return make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=128)


@pytest.mark.parametrize("option", sorted(PORTED_SLAM))
def test_ported_options_run(option, tmp_path):
    """A small CPU LonerSLAM with the option maps its first keyframe: finite
    steps, as many as the schedule says (FIXED: one epoch over the padded
    scan, P // R steps). With the camera on, an image attached to that
    keyframe trains in the next pass, whose camera steps count in
    ``global_step`` but not in the mapper's lidar steps; with loop closure
    on, ``stop`` runs (one keyframe: nothing to refine). With a debug flag
    on, its dump lands under the dump directory: the probe's ray clouds of
    the first window, or the ICP clouds of the first registration. The
    device indices resolve to the CPU, where they were asked for: the
    mapper's mesh holds the CPU twice, the tracker runs on it, and the
    device split, with one device, changes nothing."""
    changes = dict(PORTED_SLAM[option])
    if option.startswith("debug"):
        changes["mapper.debug"] = DebugFlags(**{**vars(changes["mapper.debug"]), "dump_dir": str(tmp_path)})
    small = {"mapper.mapper.rays_per_kf": 16, "mapper.mapper.sky_rays_per_kf": 4, "mapper.mapper.n_samples_train": 16,
             "mapper.schedule": [tmapper.SchedulePhase(1, [tmapper.IterationPhase(3, freeze_poses=True)])]}
    slam = _slam(**small, **changes)
    poses, ts = synthetic.circular_trajectory(n_poses=2, radius=3.0)
    assert slam.mapper.process_frame(_scan(poses[0], ts[0]), 0.0, np.eye(4))
    steps = 128 // 16 if option == "rays_fixed" else 3
    assert slam.mapper._host_step == int(slam.mapper.state.global_step) == steps
    assert int(slam.mapper.state.skipped_steps) == 0
    if option == "camera":
        kf = slam.mapper.kf_manager.keyframes[0]
        assert slam.mapper.attach_image(kf.scan, np.full((4, 6, 1), 0.5, np.float32), 0.01)
        assert slam.mapper.process_frame(_scan(poses[1], 3.5), 3.5, np.eye(4))
        assert slam.mapper._host_step == 2 * steps
        assert int(slam.mapper.state.global_step) == 2 * steps + CAMERA.iterations_per_window
        assert int(slam.mapper.state.opt_intensity.count) == CAMERA.iterations_per_window
    if option == "loop_closure":
        slam.stop()
        assert slam.ba_info is None
    cpu = torch.device("cpu")
    assert slam.tracker.device == slam.mapper.device == cpu
    if option == "mapper_mesh":
        assert slam.mapper.mesh.devices.tolist() == [cpu, cpu]
    else:
        assert slam.mapper.mesh is None
    if option == "device_split":
        assert slam.cfg.tracker.device_index is None and slam.cfg.mapper.mesh_device_indices is None
    if option == "debug_rays":
        assert (tmp_path / "keyframe_1" / "ray_endpoints.pcd").exists()
    if option == "debug_icp_clouds":
        for i in range(2):
            slam.tracker.track(_scan(poses[i], ts[i]), float(ts[i]))
        assert {p.name for p in (tmp_path / "frame_1").iterdir()} == {"icp_input.pcd", "icp_aligned.pcd",
                                                                      "icp_target.pcd"}


def test_process_image_runs():
    """``process_image`` in camera mode: the image waits for its scan, is
    matched to it and attached to its keyframe."""
    slam = _slam(**{"mapper.camera": CAMERA, "mapper.mapper.rays_per_kf": 16, "mapper.mapper.sky_rays_per_kf": 4,
                    "mapper.mapper.n_samples_train": 16,
                    "mapper.schedule": [tmapper.SchedulePhase(1, [tmapper.IterationPhase(2, freeze_poses=True)])],
                    "tracker.target_points": 64})
    poses, ts = synthetic.circular_trajectory(n_poses=2, radius=3.0)
    scan = _scan(poses[0], ts[0])
    img = np.full((4, 6, 1), 0.5, np.float32)
    slam.process_image(img, float(np.median(np.asarray(scan.timestamps)[np.asarray(scan.valid)])))
    assert slam.mapper.image_attaches == 0
    slam.process_scan(scan, float(ts[0]))
    kf = slam.mapper.kf_manager.keyframes[0]
    assert (slam.mapper.image_attaches, slam.mapper.image_attach_drops) == (1, 0)
    np.testing.assert_array_equal(kf.image, img)


@pytest.mark.parametrize("impl", ["cell", "packed", "exact"])
def test_unported_paths_raise(impl):
    # the alternate encoders (queue A item 2) raised until they were ported:
    # now init_nerf builds the JAX package's table shapes and the sigma
    # query runs
    enc = tnerf.HashEncodingConfig(n_levels=4, log2_hashmap_size=10, base_resolution=4)
    cfg = tnerf.NeRFConfig(encoding_impl=impl, sigma_hidden_dim=8, intensity_hidden_dim=8,
                           pos_encoding_sigma=enc, pos_encoding_intensity=enc._replace(log2_hashmap_size=11))
    params = tnerf.init_nerf(torch.Generator().manual_seed(0), cfg, device="cpu")
    for branch, log2 in (("sigma", 10), ("intensity", 11)):
        want = (4, 1 << (log2 - 2), 16) if impl == "cell" else (4, 2, 1 << log2)
        assert tuple(params[branch]["table"].shape) == want
        assert params[branch]["mlp"]["w"][0].shape[0] == enc.output_dim + (16 if branch == "intensity" else 0)
    pts = torch.rand((3, 64), generator=torch.Generator().manual_seed(1)) * 2 - 1
    sigma = tnerf.query_sigma_t(params, pts, cfg)
    assert sigma.shape == (64,) and bool(torch.all(torch.isfinite(sigma)))


@pytest.mark.parametrize("probe", ["bench_dyngather", "bench_gather", "bench_gather2", "bench_honest",
                                   "bench_lane_gather", "bench_pallas_scatter"])
def test_probes_default_to_the_card(probe):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    module = importlib.import_module(f"loner_tpu_torch.probes.{probe}")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])


def test_every_bound_c_entry_is_defined_in_the_sources():
    """Each name of the loader's signature table is defined once in
    ``csrc/*.cu`` as an ``extern "C"`` function with as many parameters as
    the table lists (a missing one fails only when the library loads on the
    card)."""
    defined = {}
    for src in sorted((PKG / "csrc").glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (loner_\w+)\(([^)]*)\)', src.read_text()):
            assert name not in defined, name
            defined[name] = len([a for a in params.split(",") if a.strip()])
    for name, argtypes in tkernels._SIGNATURES.items():
        assert defined.get(name) == len(argtypes), (name, defined.get(name), len(argtypes))
