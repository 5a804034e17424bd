"""The camera step of LONER's decoupled field (``default_nerf_hash.yaml``:
a sigma hash grid and an intensity hash grid, degree-4 SH, a 4-layer colour
MLP) under ``encoding_impl="fused"`` with the exact table gradient, at a
tiny size on the CPU: against the plain reference of the benchmark
(``benchmark/reference/camera.py``, which imports nothing of the port), the
frozen values it must leave alone, and the spans it records beside the
lidar paths'. The same field's camera step against the JAX package's is
``tests/test_torch_camera.py::test_decoupled_fused_camera_step_matches_jax``."""
import copy
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

from benchmark.reference import camera as ref_camera
from benchmark.reference import field as ref_field
from benchmark.reference.train import _adam, named_leaves
from loner_tpu_torch.geometry.world_cube import WorldCube
from loner_tpu_torch.mapping import camera_optimizer as cam
from loner_tpu_torch.mapping import optimizer as opt
from loner_tpu_torch.models.hash_encoding import HashEncodingConfig
from loner_tpu_torch.models.nerf import NeRFConfig
from loner_tpu_torch.models.occupancy_grid import OccGridConfig
from loner_tpu_torch.runtime import profiling

SEED = 2_718_281_829
N_RAYS, N_SAMPLES, B, H, W = 48, 32, 3, 12, 16
SCALE, RAY_RANGE = 8.0, (0.5, 12.0)
FIELD = {"hash_levels": 4, "hash_features": 2, "hash_log2_entries": 12, "hash_log2_cells": 10,
         "hash_base_resolution": 4, "hash_per_level_scale": 2.0, "sigma_hidden_dim": 16, "sigma_hidden_layers": 1,
         "intensity_levels": 4, "intensity_features": 2, "intensity_log2_entries": 13, "intensity_log2_cells": 11,
         "intensity_base_resolution": 4, "intensity_per_level_scale": 2.0, "sh_degree": 4, "intensity_hidden_dim": 16,
         "intensity_hidden_layers": 4, "num_colors": 3, "encoder": "fused_rgb"}
TRAIN = {"n_samples_train": N_SAMPLES, "perturb": 1.0, "lr_rgb": 0.01, "rgb_weight_decay": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nerf(point_chunks: int) -> NeRFConfig:
    def grid(prefix):
        return HashEncodingConfig(n_levels=FIELD[f"{prefix}_levels"], n_features_per_level=FIELD[f"{prefix}_features"],
                                  log2_hashmap_size=FIELD[f"{prefix}_log2_entries"],
                                  base_resolution=FIELD[f"{prefix}_base_resolution"],
                                  per_level_scale=FIELD[f"{prefix}_per_level_scale"])

    return NeRFConfig(encoding_impl="fused", encoding_bwd="exact", pos_encoding_sigma=grid("hash"),
                      pos_encoding_intensity=grid("intensity"), sigma_hidden_dim=16, sigma_hidden_layers=1,
                      intensity_hidden_dim=16, intensity_hidden_layers=4, sh_degree=4, num_colors=3,
                      compute_dtype="bfloat16", point_chunks=point_chunks)


def _case(point_chunks: int):
    """(the port's config, cube, state, window, the reference's inputs): the
    reference's seeded weights (the sigma table scaled up, so that the
    weights are not all on the last sample), a random occupancy grid, three
    cameras looking into the cube, random images and masks."""
    cfg = opt.MapperConfig(nerf=_nerf(point_chunks), occ=OccGridConfig(voxel_size=8), ray_range=RAY_RANGE,
                           world_scale=SCALE, max_keyframes=4, n_samples_train=N_SAMPLES)
    shift = np.zeros(3, np.float32)
    cube = WorldCube(SCALE, torch.as_tensor(shift))
    gen = torch.Generator().manual_seed(SEED)
    field = dict(FIELD, point_chunks=point_chunks)
    sigma = ref_field.init_sigma(gen, field, "cpu")
    sigma["table"] = sigma["table"] * 2e4
    intensity = ref_camera.init_intensity(gen, field, "cpu")
    state = opt.init_mapper_state(torch.Generator().manual_seed(0), cfg, "cpu")
    state = state._replace(params={"sigma": sigma, "intensity": intensity},
                           occ_grid=3.0 * torch.randn((8, 8, 8), generator=gen),
                           poses=torch.randn((4, 6), generator=gen))
    rng = np.random.default_rng(7)
    poses = np.tile(np.eye(4), (B, 1, 1))
    for i, yaw in enumerate((0.3, 2.2, 4.1)):
        c, s = np.cos(yaw), np.sin(yaw)
        # camera z (forward) horizontal along yaw, y down
        poses[i, :3, :3] = np.array([[-s, 0.0, c], [c, 0.0, s], [0.0, -1.0, 0.0]])
        poses[i, :3, 3] = (1.5 * np.cos(yaw + 2.0), 1.5 * np.sin(yaw + 2.0), 0.4)
    K = np.array([[14.0, 0.0, W / 2], [0.0, 14.0, H / 2], [0.0, 0.0, 1.0]])
    images = rng.uniform(0.0, 1.0, (B, H, W, 3)).astype(np.float32)
    masks = rng.uniform(size=(B, H, W)) > 0.2
    window = cam.stack_camera_window(images, masks, poses, K, device="cpu")
    ref = ref_camera.CameraInputs(
        seed=SEED, field=field, train=TRAIN, rgb={"rgb_rays": N_RAYS, "cam_lambda": 1.0}, images=window.intensities,
        masks=window.masks, cam_poses=poses, K=K, scale=SCALE, shift=shift, ray_range=RAY_RANGE, first_step=0,
        sigma=sigma, intensity=intensity, mu=state.opt_intensity.mu, nu=state.opt_intensity.nu, count=0,
        occ=state.occ_grid, device="cpu")
    return cfg, cube, state, window, ref


def _draws(step: int, window):
    return cam.CameraDraws(**ref_camera.camera_draws(SEED, step, N_RAYS, B, H, W, N_SAMPLES, "cpu"))


def _reference_step(ref):
    """The reference's first step by leaf: (loss, gradients, updated leaves)."""
    d = ref_camera.camera_draws(SEED, 0, N_RAYS, B, H, W, N_SAMPLES, "cpu")
    rays, target = ref_camera.pixel_rays(ref, d)
    z = ref_camera.ogm_z_vals(rays, ref.occ, N_SAMPLES, TRAIN["perturb"], d["u_strat"], d["u_pdf"])
    names = [n for n, _ in named_leaves(ref.intensity)]
    leaves = [t.detach().clone().requires_grad_(True) for _, t in named_leaves(ref.intensity)]
    tree = {"table": leaves[0], "mlp": {"w": leaves[1:6], "b": leaves[6:]}}
    with torch.enable_grad():
        loss = ref_camera.camera_loss(ref_camera.composite_colour(ref.sigma, tree, rays, z, ref.field), target,
                                      rays.valid, 1.0)
        grads = torch.autograd.grad(loss, leaves)
    new = [p.detach() + _adam(g + TRAIN["rgb_weight_decay"] * p.detach(), p.detach(),
                               {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p), "count": 0}, TRAIN["lr_rgb"])[0]
           for p, g in zip(leaves, grads)]
    return float(loss.detach()), dict(zip(names, grads)), dict(zip(names, new)), int(rays.valid.sum())


@pytest.mark.parametrize("point_chunks", [1, 2])
def test_camera_step_matches_the_reference(point_chunks):
    """One step by element, and three steps by the benchmark's readings.
    Tolerances: the loss's colour sums add in another order (einsum against
    a sum), a few float32 ulps, so 1e-6 relative. Each gradient leaf: 1e-5
    relative plus 1e-5 of the leaf's largest magnitude, as the bf16 roundings
    of the MLP's operands and weight gradients are the same on both sides
    and only f32 summation order differs. Each updated leaf: 1e-5 relative
    plus 1e-6 where the element's gradient is at least 1e-6 of the leaf's
    largest; elsewhere within the learning rate, since Adam's first step
    moves an element by about the learning rate whatever its gradient's size,
    so a rounding of a near-nought gradient can turn its direction. The
    three steps' changes by norm: 1e-4 relative, the same roundings carried
    through three Adam steps."""
    cfg, cube, state, window, ref = _case(point_chunks)
    loss, grads, new, n_valid = _reference_step(ref)
    assert 0 < n_valid < N_RAYS
    step = cam.make_camera_train_step(cfg, cube, N_RAYS, device="cpu")
    out, aux = step(state, window, _draws(0, window))
    assert float(aux["loss"]) == pytest.approx(loss, rel=1e-6)
    port_g = dict(named_leaves(aux["grads"]["intensity"]))
    port_new = dict(named_leaves(out.params["intensity"]))
    for n, g in grads.items():
        assert float(g.abs().max()) > 0, n
        torch.testing.assert_close(port_g[n], g, rtol=1e-5, atol=1e-5 * float(g.abs().max()), msg=n)
        small = g.abs() < 1e-6 * float(g.abs().max())
        torch.testing.assert_close(torch.where(small, new[n], port_new[n]), new[n], rtol=1e-5, atol=1e-6, msg=n)
        assert float((port_new[n] - new[n]).abs().max()) <= TRAIN["lr_rgb"] * 1.001, n

    # three steps, read as the benchmark's check reads them
    readings = ref_camera.follow_camera(ref)
    st, losses, start = state, {}, named_leaves(state.params["intensity"])
    for i in range(3):
        st, aux_i = step(st, window, _draws(i, window))
        losses[i] = float(aux_i["loss"])
    for i, v in readings.losses.items():
        assert losses[i] == pytest.approx(v, rel=1e-6)
    for (n, p), (_, p0) in zip(named_leaves(st.params["intensity"]), start):
        assert float(torch.linalg.vector_norm((p - p0).double())) == pytest.approx(
            readings.changes[f"intensity.{n}"], rel=1e-4)


def test_camera_step_leaves_sigma_and_poses_alone():
    """Sigma's leaves, its Adam moments, the occupancy grid, the keyframe
    poses and the camera poses come out bit for bit as they went in, over
    three steps; the intensity leaves all move."""
    cfg, cube, state, window, _ = _case(2)
    frozen = copy.deepcopy((state.params["sigma"], state.opt_sigma, state.occ_grid, state.poses, window.poses))
    step = cam.make_camera_train_step(cfg, cube, N_RAYS, device="cpu")
    st = state
    for i in range(3):
        st, _ = step(st, window, _draws(i, window))
    after = (st.params["sigma"], st.opt_sigma, st.occ_grid, st.poses, window.poses)
    for (n, a), (_, b) in zip(named_leaves(list(frozen)), named_leaves(list(after))):
        assert torch.equal(a, b), n
    for (n, a), (_, b) in zip(named_leaves(state.params["intensity"]), named_leaves(st.params["intensity"])):
        assert not torch.equal(a, b), n
    assert int(st.global_step) == 3 and int(st.opt_intensity.count) == 3


def _children():
    recs = profiling.records()
    by_id = {r.id: r for r in recs}
    kids = defaultdict(list)
    for r in recs:
        kids[r.parent].append(r.name)
    return recs, by_id, kids


def test_camera_step_spans():
    """One step records ``loner.camera.step`` holding ``.forward``,
    ``.backward`` and ``.update``; the forward holds the rays, the sampler,
    one ``loner.field`` a point chunk, the compositing and the loss; each
    field chunk holds one ``loner.field.intensity``; the update holds the
    finite check and Adam."""
    cfg, cube, state, window, _ = _case(2)
    step = cam.make_camera_train_step(cfg, cube, N_RAYS, device="cpu")
    profiling.reset()
    step(state, window, _draws(0, window))
    recs, by_id, kids = _children()
    steps = [r for r in recs if r.name == "loner.camera.step"]
    assert len(steps) == 1 and steps[0].parent == -1
    assert Counter(kids[steps[0].id]) == Counter(["loner.camera.step.forward", "loner.camera.step.backward",
                                                  "loner.camera.step.update"])
    fwd = next(r for r in recs if r.name == "loner.camera.step.forward")
    assert Counter(kids[fwd.id]) == Counter(["loner.camera.step.rays", "loner.camera.step.sample", "loner.field",
                                             "loner.field", "loner.composite", "loner.camera.step.loss"])
    upd = next(r for r in recs if r.name == "loner.camera.step.update")
    assert Counter(kids[upd.id]) == Counter(["loner.camera.step.finite", "loner.camera.step.adam"])
    fields = [r for r in recs if r.name == "loner.field"]
    intensity = [r for r in recs if r.name == "loner.field.intensity"]
    assert len(intensity) == len(fields) == 2
    assert sorted(r.parent for r in intensity) == sorted(r.id for r in fields)
    for r in intensity:
        parent = by_id[r.parent]
        assert parent.t0_ns <= r.t0_ns <= r.t1_ns <= parent.t1_ns
    profiling.reset()


@pytest.mark.parametrize("path", ["lidar_step", "render_lidar_scan"])
def test_lidar_paths_record_no_intensity_span(path):
    """A lidar train step and a virtual lidar sweep of the same decoupled
    field query the sigma branch alone: their ``loner.field`` spans hold no
    ``loner.field.intensity``."""
    from loner_tpu_torch.analysis.renderer import render_lidar_scan
    from loner_tpu_torch.flagship import flagship

    cfg, cube, state, window = flagship(device="cpu", cfg=opt.MapperConfig(nerf=_nerf(2), n_samples_train=32,
                                                                        rays_per_kf=16, sky_rays_per_kf=4,
                                                                        n_samples_test=32),
                                        n_keyframes=2, n_channels=8, n_azimuth=64, pad_to=256, n_sky=32)
    profiling.reset()
    if path == "lidar_step":
        flags = opt.TrainStepFlags(freeze_sigma=False, freeze_rgb=True, freeze_poses=True, do_occ_update=False)
        opt.make_train_step(cfg, cube, device="cpu")(state, window, flags, torch.zeros(cfg.max_keyframes), 0)
    else:
        render_lidar_scan(cfg, cube, state, np.eye(4), n_channels=4, n_azimuth=16, chunk=64)
    names = Counter(r.name for r in profiling.records())
    assert names["loner.field"] > 0 and names["loner.field.intensity"] == 0, names
    profiling.reset()
