"""Shared set-up for the parity tests of the PyTorch port (tests/test_torch_*.py).

One small mapper configuration is built in both packages from the same
keyword arguments, the synthetic window is built on both sides from the same
scans, and the JAX train step's random draws are rebuilt here by repeating
its key splits, so that the port's step can be handed exactly the numbers
the JAX step drew. Data crosses between the packages as numpy arrays.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.data import synthetic as jsyn
from loner_tpu.data.scan import make_lidar_scan as j_make_lidar_scan, sky_scan as j_sky_scan
from loner_tpu.geometry import se3 as jse3
from loner_tpu.geometry.world_cube import compute_world_cube as j_compute_world_cube
from loner_tpu.mapping import keyframe as jkf
from loner_tpu.mapping import optimizer as jopt
from loner_tpu.models.hash_encoding import HashEncodingConfig as JHashEncodingConfig
from loner_tpu.models.losses import LossConfig as JLossConfig
from loner_tpu.models.nerf import NeRFConfig as JNeRFConfig
from loner_tpu.models.occupancy_grid import OccGridConfig as JOccGridConfig
from loner_tpu.ops.triad_field import TriadConfig as JTriadConfig

from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.models.losses import LossConfig as TLossConfig
from loner_tpu_torch.models.nerf import HashEncodingConfig as THashEncodingConfig
from loner_tpu_torch.models.nerf import NeRFConfig as TNeRFConfig
from loner_tpu_torch.models.occupancy_grid import OccGridConfig as TOccGridConfig
from loner_tpu_torch.ops.triad_field import TriadConfig as TTriadConfig

RAY_RANGE = (1.0, 40.0)
TRIAD = dict(cp_resolutions=(4, 8), cp_features=4, fourier_freqs=2)
NERF = dict(num_colors=1, sigma_hidden_dim=16, intensity_hidden_dim=16, intensity_hidden_layers=1)
MAPPER = dict(window_size=2, max_keyframes=4, rays_per_kf=32, sky_rays_per_kf=8, n_samples_train=32)
SCAN = dict(n_keyframes=2, n_channels=8, n_azimuth=64, pad_to=256, n_sky=32)
OCC_V = 16
# the field's hash term: off (the default gather-free triad), the triad's
# fat-row hash level (L=1, F=4, 2^10 cells), or a 4-level hash encoding of
# 2^12 vertices (F=2) at base resolution 4: the FusedHash and CellHash (2^10
# cells: levels 0-1 dense, 2-3 hashed), the packed and the exact hash grids
# (level 0 dense, 1-3 hashed). CellHash runs its exact table gradient with
# corner sampling: its default "level1" gradient picks each point's level by
# hashing the point's float bits, and the two packages' samples differ in
# their last bits (the OGM CDF is summed in other orders: 647 of this step's
# 2560 points, 539 level choices), so level1 is held on equal points
# (tests/test_torch_hash_encoders.py)
_ENCODER_NERF = {"fused": {}, "cell": dict(encoding_bwd="exact"), "packed": {}, "exact": {}}
HASH = {
    "off": dict(triad={}, enc={}, nerf={}),
    "triad_hash": dict(triad=dict(hash_levels=1, hash_features=4), enc=dict(log2_hashmap_size=12), nerf={}),
    **{impl: dict(triad={}, enc=dict(n_levels=4, log2_hashmap_size=12, base_resolution=4),
                  nerf=dict(encoding_impl=impl, **kw)) for impl, kw in _ENCODER_NERF.items()},
    # tables of 2^13 (triad) and 2^12 (fused, cell) cells: at or over the
    # 4096 cells from which hash-table TP splits a table; the exact and packed
    # masters (4, 2, 2^14) hold 2 on that axis and stay whole
    "triad_hash_tp": dict(triad=dict(hash_levels=1, hash_features=4), enc=dict(log2_hashmap_size=15), nerf={}),
    **{f"{impl}_tp": dict(triad={}, enc=dict(n_levels=4, log2_hashmap_size=14, base_resolution=4),
                          nerf=dict(encoding_impl=impl, **kw)) for impl, kw in _ENCODER_NERF.items()},
    # LONER's decoupled field (default_nerf_hash.yaml) in small: FusedHash in
    # both branches with the exact table gradient, SH of degree 4 and a
    # 4-layer colour MLP
    "fused_rgb": dict(triad={}, enc=dict(n_levels=4, log2_hashmap_size=12, base_resolution=4),
                      nerf=dict(encoding_impl="fused", encoding_bwd="exact", sh_degree=4, intensity_hidden_layers=4)),
}


def nerf_kwargs(hash_term: str, enc_cls, triad_cls, compute_dtype: str = "float32") -> dict:
    """NeRFConfig keyword arguments of the small field with ``hash_term``,
    built from one package's config classes."""
    h = HASH[hash_term]
    kw = dict(NERF, triad=triad_cls(**TRIAD, **h["triad"]), compute_dtype=compute_dtype, **h["nerf"])
    if h["enc"]:
        enc = enc_cls(**h["enc"])
        kw.update(pos_encoding_sigma=enc, pos_encoding_intensity=enc._replace(log2_hashmap_size=enc.log2_hashmap_size + 1))
    return kw


def mapper_configs(world_scale: float, compute_dtype: str = "float32", hash_term: str = "off", **changes):
    """(jax MapperConfig, torch MapperConfig) of the same small mapper;
    ``changes`` replace MapperConfig fields (window_size=8, ...)."""
    sizes = {**MAPPER, **changes}
    j = jopt.MapperConfig(
        nerf=JNeRFConfig(**nerf_kwargs(hash_term, JHashEncodingConfig, JTriadConfig, compute_dtype)),
        loss=JLossConfig(),
        occ=JOccGridConfig(voxel_size=OCC_V),
        ray_range=RAY_RANGE,
        world_scale=world_scale,
        **sizes,
    )
    t = topt.MapperConfig(
        nerf=TNeRFConfig(**nerf_kwargs(hash_term, THashEncodingConfig, TTriadConfig, compute_dtype)),
        loss=TLossConfig(),
        occ=TOccGridConfig(voxel_size=OCC_V),
        ray_range=RAY_RANGE,
        world_scale=world_scale,
        **sizes,
    )
    return j, t


def jax_flagship_tiny(compute_dtype: str = "float32", seed: int = 0, hash_term: str = "off",
                      n_keyframes: int = SCAN["n_keyframes"], **changes):
    """The JAX side of ``loner_tpu_torch.flagship.flagship`` at the small
    sizes above: ``__graft_entry__._flagship`` with its sizes cut, over
    ``n_keyframes`` keyframes (``changes`` as in :func:`mapper_configs`)."""
    scene = jsyn.Scene.default()
    poses, ts = jsyn.circular_trajectory(n_poses=n_keyframes, radius=6.0, z=1.5)
    cube = j_compute_world_cube(poses, ray_range=RAY_RANGE, rebase_to_first_pose=False)
    cfg, _ = mapper_configs(float(cube.scale_factor), compute_dtype, hash_term, **changes)
    kfs = []
    for i, (T, t0) in enumerate(zip(poses, ts)):
        dirs, dists, stamps, hit = jsyn.simulate_scan(
            scene, T, t0, n_channels=SCAN["n_channels"], n_azimuth=SCAN["n_azimuth"], max_range=40.0
        )
        scan = j_make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=SCAN["pad_to"])
        sky = j_sky_scan(dirs[~hit][: SCAN["n_sky"]], RAY_RANGE[1] + 1.0, t0, pad_to=SCAN["n_sky"])
        kfs.append(jkf.KeyFrame(scan=scan, timestamp=t0, pose_index=i, tracked_pose=T, gt_pose=T, sky=sky))
    window = jkf.stack_window(kfs, n_sky_pad=SCAN["n_sky"])
    pose6 = jse3.matrix_to_pose(jnp.asarray(np.stack(poses), jnp.float32))
    state = jopt.init_mapper_state(jax.random.PRNGKey(seed), cfg)
    state = state._replace(poses=state.poses.at[: len(kfs)].set(pose6))
    return cfg, cube, state, window


def jax_step_draws(key, cfg, window, iteration: int = 0) -> dict:
    """The numbers one JAX train step draws from ``key`` (numpy), rebuilt by
    repeating its key splits: ``optimizer.py:256`` (rays, sampler, encoder;
    under FIXED the sampler's and encoder's keys folded with the iteration,
    ``:258-263``), ``:177,180,190,200`` (per-keyframe ray and sky indices;
    under FIXED a permutation per keyframe and the sky key folded with the
    iteration, ``:181-187``), ``sampling.py:151,34`` and ``pdf_kernel.py:90``
    / ``sampling.py:82`` (stratified and pdf uniforms; under UNIFORM one
    stratified draw of S, ``sampling.py:98``), ``optimizer.py:386`` with
    ``occupancy_grid.py:223`` (occupancy-corner uniforms), the encoder's
    key ``k_enc`` as its two words (``fused_encoder.py:454-459``), and under
    "cell" the corner uniforms its backward draws from ``k_enc`` in each
    point chunk (``cell_hash.py:190``)."""
    w = window.dirs.shape[0]
    p = window.dirs.shape[1]
    s = window.sky_dirs.shape[1]
    n = cfg.rays_per_window
    half = cfg.n_samples_train // 2
    fixed = cfg.rays_strategy == "FIXED"
    it32 = jnp.asarray(iteration).astype(jnp.int32)
    k_rays, k_samp, k_enc = jax.random.split(key, 3)
    if fixed:
        k_samp, k_enc = jax.random.fold_in(k_samp, it32), jax.random.fold_in(k_enc, it32)
    ray_idx, sky_idx, perm = [], [], []
    for k in jax.random.split(k_rays, w):
        k1, k2 = jax.random.split(k)
        if fixed:
            perm.append(np.asarray(jax.random.permutation(k1, p)))
            k2 = jax.random.fold_in(k2, it32)
        else:
            ray_idx.append(np.asarray(jax.random.randint(k1, (cfg.rays_per_kf,), 0, p)))
        sky_idx.append(np.asarray(jax.random.randint(k2, (cfg.sky_rays_per_kf,), 0, s)))
    if cfg.samples_strategy == "OGM":
        k_unif, k_pdf = jax.random.split(k_samp)
        u_strat = np.asarray(jax.random.uniform(k_unif, (n, half), dtype=jnp.float32))
        u_pdf = np.asarray(jax.random.uniform(k_pdf, (n, half), dtype=jnp.float32))
    else:
        u_strat = np.asarray(jax.random.uniform(k_samp, (n, cfg.n_samples_train), dtype=jnp.float32))
        u_pdf = None
    return dict(
        ray_idx=None if fixed else np.stack(ray_idx).astype(np.int64),
        sky_idx=np.stack(sky_idx).astype(np.int64),
        u_strat=u_strat,
        u_pdf=u_pdf,
        u_occ=np.asarray(
            jax.random.uniform(jax.random.fold_in(key, 0x0CC), (n, cfg.n_samples_train), dtype=jnp.float32)
        ),
        enc_key=np.asarray(k_enc, np.uint32).astype(np.int64),  # the key's two words
        perm=np.stack(perm).astype(np.int64) if fixed else None,
        u_enc=np.asarray(jax.random.uniform(
            k_enc, (cfg.nerf.pos_encoding_sigma.n_levels, n * cfg.n_samples_train // cfg.train_point_chunks)))
        if cfg.nerf.encoding_impl == "cell" else None,
    )


def replayed_jax_draws(jcfg, seed: int):
    """``step_draws`` for the port's mapper: each call splits the JAX
    mapper's key chain (``PRNGKey(seed + 1)``) as its loop does and returns
    the numbers the JAX step draws from the sub-key."""
    key = [jax.random.PRNGKey(seed + 1)]

    def draws(window):
        key[0], sub = jax.random.split(key[0])
        return torch_draws(jax_step_draws(sub, jcfg, window))

    return draws


def jax_loss_and_grads(cfg, cube, state, window, key, pose_grads, point_chunks=1):
    """The loss and gradients of ``make_train_step_body``'s forward (which
    the JAX step does not return), by the same calls with the same keys,
    the field in ``point_chunks`` chunks (one pass by default)."""
    from loner_tpu.models import losses as jlosses
    from loner_tpu.models import rendering as jrender
    from loner_tpu.models import sampling as jsampling

    k_rays, k_samp, k_enc = jax.random.split(key, 3)

    def fwd(params, poses):
        bundle = jopt.build_window_rays(poses, window, cube, cfg, k_rays, 0)
        z = jsampling.occ_grid_sampler_z_vals(k_samp, bundle, state.occ_grid, cfg.n_samples_train, cfg.perturb)
        render = jrender.render_rays(params, bundle, z, cfg.nerf, sigma_only=True, key=k_enc,
                                     point_chunks=point_chunks)
        loss, _ = jlosses.compute_lidar_loss(
            render, bundle, cfg.world_scale, cfg.loss, state.global_step.astype(jnp.float32), jnp.float32(0.0)
        )
        return loss

    if pose_grads:
        loss, (g_params, g_poses) = jax.value_and_grad(fwd, argnums=(0, 1))(state.params, state.poses)
    else:
        loss, g_params = jax.value_and_grad(fwd)(state.params, jax.lax.stop_gradient(state.poses))
        g_poses = jnp.zeros_like(state.poses)
    return float(loss), np_tree(g_params), np.asarray(g_poses)


def torch_draws(draws: dict, device="cpu") -> topt.StepDraws:
    return topt.StepDraws(**{k: None if v is None else torch.as_tensor(np.array(v)).to(device)
                             for k, v in draws.items()})


def jax_render_u_pdf(key, n_rays: int, n_samples: int) -> np.ndarray:
    """The inverse-CDF uniforms of the JAX package's eval render
    (``make_render_fn``) from ``key``: the OGM sampler's pdf key
    (``sampling.py:151``) drawn by the jnp ``sample_pdf`` (``:82``)."""
    return np.array(jax.random.uniform(jax.random.split(key)[1], (n_rays, n_samples // 2), dtype=jnp.float32))


def np_tree(tree):
    """A JAX pytree (or any pytree) with numpy leaves."""
    return jax.tree.map(np.asarray, tree)


def t2n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def leaves(tree) -> list:
    """numpy leaves of a nested dict/list/tuple tree, dict keys sorted (the
    order jax.tree.leaves uses), from either package."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [t2n(tree) if isinstance(tree, torch.Tensor) else np.asarray(tree)]


def assert_trees_close(a, b, rtol, atol, what=""):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol, err_msg=f"{what} leaf {i}")


def rel_err(a, b) -> float:
    """Normwise relative error ||a - b|| / ||b|| over all leaves."""
    la, lb = leaves(a), leaves(b)
    num = sum(float(np.sum((x.astype(np.float64) - y) ** 2)) for x, y in zip(la, lb))
    den = sum(float(np.sum(y.astype(np.float64) ** 2)) for y in lb)
    return float(np.sqrt(num / max(den, 1e-300)))


def load_example(name: str):
    """The module of ``examples/<name>.py``, loaded from its file (it puts
    the repo root on ``sys.path`` when imported; ``sys.path`` is restored)."""
    import importlib.util
    import sys
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    saved_path = list(sys.path)
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = saved_path
    return module


def load_script(name: str):
    """The module of ``scripts/<name>.py``, loaded from its file. Some of those
    scripts point JAX's persistent compilation cache at a directory
    (``$JAX_CACHE_DIR``, created on import) when imported: the directory is a
    temporary one here, and the cache settings, ``sys.path`` and the
    environment are restored after the import."""
    import importlib.util
    import os
    import sys
    import tempfile
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / f"{name}.py"
    saved = {k: getattr(jax.config, k) for k in
             ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    saved_path, saved_env = list(sys.path), os.environ.get("JAX_CACHE_DIR")
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    module = importlib.util.module_from_spec(spec)
    with tempfile.TemporaryDirectory() as cache_dir:
        os.environ["JAX_CACHE_DIR"] = cache_dir
        try:
            spec.loader.exec_module(module)
        finally:
            for k, v in saved.items():
                jax.config.update(k, v)
            sys.path[:] = saved_path
            if saved_env is None:
                os.environ.pop("JAX_CACHE_DIR", None)
            else:
                os.environ["JAX_CACHE_DIR"] = saved_env
    return module


def loop_scans(n_frames: int, n_channels: int = 16, n_azimuth: int = 256, pad_to: int = 3072, n_sky: int = 256):
    """The synthetic loop of ``tests/test_slam_e2e.py`` (48 poses, radius 5 m,
    period 9.6 s): ground-truth poses re-based to the first frame, timestamps,
    and the first ``n_frames`` scans and sky scans (numpy LidarScans, whose
    fields both packages' LidarScan take)."""
    scene = jsyn.Scene.default()
    poses, ts = jsyn.circular_trajectory(n_poses=48, radius=5.0, z=1.5, period=9.6)
    scans, skies = [], []
    for T, t0 in zip(poses[:n_frames], ts[:n_frames]):
        dirs, dists, stamps, hit = jsyn.simulate_scan(scene, T, t0, n_channels=n_channels, n_azimuth=n_azimuth,
                                                     max_range=RAY_RANGE[1])
        scans.append(j_make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=pad_to))
        skies.append(j_sky_scan(dirs[~hit][:n_sky], RAY_RANGE[1] + 1.0, t0, pad_to=n_sky))
    return poses, np.linalg.inv(poses[0])[None] @ poses, ts, scans, skies


def slam_configs(pkg_mapper, pkg_kfm, pkg_slam, pkg_tracker, pkg_icp, mapper_cfg):
    """One package's small SlamConfig (its modules as arguments, so that a
    card test builds the port's alone): the budgets of
    tests/test_slam_e2e.py::build_slam cut further (window 2, ``mapper_cfg``
    of ``mapper_configs``, a 4 + 2 step schedule), the cfg/defaults.yaml ICP
    schedule on 2048 points without motion compensation, keyframes 0.9 s apart
    (the loop's timestamps, 0.2 s apart, fall an ulp under whole seconds)."""
    schedule = [pkg_mapper.SchedulePhase(1, [pkg_mapper.IterationPhase(4, freeze_poses=True)]),
                pkg_mapper.SchedulePhase(-1, [pkg_mapper.IterationPhase(2, freeze_poses=False)])]
    return pkg_slam.SlamConfig(
        tracker=pkg_tracker.TrackerConfig(icp=pkg_icp.IcpConfig(n_buckets=1 << 12), target_points=2048,
                                          motion_compensation=False),
        mapper=pkg_mapper.OnlineMapperConfig(
            mapper=mapper_cfg._replace(max_keyframes=8), schedule=schedule, n_sky_pad=256,
            keyframe_manager=pkg_kfm.KeyFrameManagerConfig(time_diff_seconds=0.9, window_size=2)))


def port_slam_config():
    """(the port's small SlamConfig, its world cube) on the synthetic loop."""
    from loner_tpu_torch import slam
    from loner_tpu_torch.geometry.world_cube import compute_world_cube
    from loner_tpu_torch.mapping import keyframe_manager, mapper
    from loner_tpu_torch.tracking import icp, tracker

    poses, _ = jsyn.circular_trajectory(n_poses=48, radius=5.0, z=1.5, period=9.6)
    cube = compute_world_cube(poses, ray_range=RAY_RANGE, rebase_to_first_pose=True)
    _, mcfg = mapper_configs(cube.scale_factor)
    return slam_configs(mapper, keyframe_manager, slam, tracker, icp, mcfg), cube


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads while a module that imports this fixture runs:
    the suite's workers share the host's cores, and more threads a worker
    only contend (tests/test_torch_camera_slam.py's run took 205 s with 8
    threads a worker under four workers on 8 cores, 79 s with 2)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def adjusted_tie_rays(z_vals, raw_sigma, rays_d, tol: float = 1e-5) -> np.ndarray:
    """(N,) bool: the rays whose "adjusted" depth (``composite_peak_adjusted``)
    turns on a near-tie that float32 rounding decides, computed in float64
    from one package's z values (N, S), sigmas (N, S) and directions: a
    transmittance within ``tol`` of a threshold at a crossing, two of the
    three smallest normalised rise deltas within ``tol`` (relative) of each
    other (the stable sort's order of exact ties: the stratified samples are
    equally spaced, so crossings on them give equal deltas, which the two
    packages' z values, ulps apart, order either way), or a prominence ratio
    within ``tol`` of its threshold. Elsewhere the two packages must agree."""
    z = np.asarray(z_vals, np.float64)
    n = z.shape[0]
    d_norm = np.linalg.norm(np.asarray(rays_d, np.float64), axis=1)[:, None]
    deltas = np.concatenate([z[:, 1:] - z[:, :-1], np.full((n, 1), 1e10)], axis=1) * d_norm
    alphas = 1 - np.exp(-deltas * np.maximum(np.asarray(raw_sigma, np.float64), 0.0))
    T = np.cumprod(np.concatenate([np.ones((n, 1)), 1 - alphas + 1e-10], axis=1), axis=1)[:, :-1]
    Ts = np.concatenate([np.ones((n, 1)), T[:, :-1]], axis=1)
    near = np.zeros(n, bool)
    d_th = []
    for th in (0.5, 0.9, 0.8, 0.7, 0.6, 0.501):
        near |= np.any((np.abs(T - th) <= tol) | (np.abs(Ts - th) <= tol), axis=1)
        m = ~(T > th) & (Ts > th)
        d_th.append(np.where(m.any(1), z[np.arange(n), np.argmax(m, 1)], 0.0))
    valid = d_th[0] > 0  # the others' depth is 0 whatever their deltas
    d_th = np.stack(d_th[1:])
    rise = (d_th[1:] - d_th[:-1]) / (d_th[-1] + 1e-10)
    s = np.sort(rise, axis=0)
    scale = np.maximum(np.abs(s).max(axis=0), 1e-30)
    tie = np.any(np.abs(s[1:3] - s[0:2]) <= tol * scale, axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        tie |= np.abs(s[0] / np.abs(s[0] + s[1]) - 0.45) <= tol
        tie |= np.abs(s[0] / rise.mean(axis=0) - 0.35) <= tol
    return near | (valid & tie)


def tiny_run_dirs(root, n_samples: int = 16, occ_seed: int = 0, samples: str = "OGM"):
    """(JAX run directory, the port's run directory, trajectory poses (8, 4, 4))
    holding one map: cfg/synthetic_tiny.yaml with ``n_samples`` samples a
    ray in training and evaluation and the ``samples`` strategy, the world
    cube of an 8-pose loop of radius 5 m, and a freshly initialised JAX
    state with a random occupancy grid (``occ_seed``), saved by each
    package's checkpoint writer (``full_config.pkl``, ``world_cube.yaml``,
    ``checkpoints/ckpt_0``), as ``load_run`` reads them."""
    import os

    import yaml

    from loner_tpu.config import settings as jsettings
    from loner_tpu.config.build import build_mapper_config as j_build_mapper_config
    from loner_tpu.runtime.checkpoints import save_checkpoint as j_save_checkpoint
    from loner_tpu_torch.config import settings as tsettings
    from loner_tpu_torch.convert import state_from_jax
    from loner_tpu_torch.runtime.checkpoints import save_checkpoint as t_save_checkpoint

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(root, exist_ok=True)
    cfg_path = os.path.join(root, "tiny_render.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"baseline": os.path.join(repo, "cfg", "synthetic_tiny.yaml"), "changes": {"mapper": {
            "optimizer": {"samples_selection": {"strategy": samples},
                          "model_config": {"model": {"render": {"N_samples_train": n_samples,
                                                                "N_samples_test": n_samples}}}}}}}, f)
    poses, _ = jsyn.circular_trajectory(n_poses=8, radius=5.0, z=1.5, period=8.0)
    cube = j_compute_world_cube(poses, ray_range=RAY_RANGE)
    js = jsettings.load_settings(cfg_path)
    jcfg = j_build_mapper_config(js, float(cube.scale_factor))
    jstate = jopt.init_mapper_state(jax.random.PRNGKey(0), jcfg)
    occ = np.random.default_rng(occ_seed).normal(0, 3, jstate.occ_grid.shape).astype(np.float32)
    jstate = jstate._replace(occ_grid=jnp.asarray(occ))
    dirs = []
    for name, settings, save, state in (
            ("jax_run", js, j_save_checkpoint, jstate),
            ("port_run", tsettings.load_settings(cfg_path), t_save_checkpoint,
             state_from_jax(np_tree(jstate), device="cpu"))):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        settings.dump_pickle(os.path.join(d, "full_config.pkl"))
        with open(os.path.join(d, "world_cube.yaml"), "w") as f:
            yaml.safe_dump(cube.as_dict(), f)
        save(os.path.join(d, "checkpoints"), 0, state)
        dirs.append(d)
    return dirs[0], dirs[1], np.linalg.inv(poses[0])[None] @ poses
