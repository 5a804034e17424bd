"""The plain reference against loner_tpu_torch at tiny sizes on the CPU: one
train step of each field, and one render chunk."""
import numpy as np
import pytest
import torch

from benchmark.draws import WEIGHTS, sub_seed
from benchmark.drivers import online_mapper
from benchmark.reference import field as ref_field
from benchmark.reference.geometry import lidar_rays
from benchmark.reference.render import ogm_z_vals, render
from benchmark.tests.tiny import tiny_cell

SEED = 2_500_000_011


@pytest.mark.parametrize("name", ["triad_cp.nc_quad_online", "hashgrid.nc_quad_online"])
def test_train_steps_agree(name):
    cell = tiny_cell(name)
    out = online_mapper.run(cell, seed=SEED, seconds=0.0, trace=False, device="cpu", t_start=0.0,
                            work_dir=None)
    for k in ("loss_gap", "grad_gap", "change_gap"):
        assert out.numbers[k] < 1e-5, (k, out.numbers)


@pytest.mark.parametrize("name", ["triad_cp.nc_quad_online", "hashgrid.nc_quad_online"])
def test_render_chunk_agrees(name):
    """The port's eval render (make_render_fn) and the reference on one chunk
    of rays, the same weights, grid and inverse-CDF draws."""
    from loner_tpu_torch.geometry.rays import build_lidar_rays
    from loner_tpu_torch.geometry.world_cube import WorldCube
    from loner_tpu_torch.mapping.optimizer import make_render_fn

    cell = tiny_cell(name)
    scans, inputs = online_mapper.prepare(cell, SEED, "cpu")
    mcfg, _, _ = online_mapper.mapper_config(cell.config, cell.mix, inputs.scale)
    gen = torch.Generator().manual_seed(sub_seed(SEED, WEIGHTS))
    sigma = ref_field.init_sigma(gen, cell.config["field"], "cpu")
    occ = torch.randn((16, 16, 16), generator=gen)
    dirs = torch.as_tensor(scans[1]["dirs"][:48])
    pose = torch.as_tensor(scans[1]["pose"], dtype=torch.float32)
    n = mcfg.n_samples_test
    u_pdf = torch.rand((48, n // 2), generator=gen)
    shift = torch.as_tensor(inputs.shift)
    cube = WorldCube(inputs.scale, shift)
    bundle = build_lidar_rays(dirs, torch.zeros(48), pose, cube, mcfg.ray_range)
    port = make_render_fn(mcfg, device="cpu")({"sigma": sigma}, occ, bundle, u_pdf=u_pdf)
    rays = lidar_rays(dirs, torch.zeros(48), pose, inputs.scale, shift, mcfg.ray_range)
    z = ogm_z_vals(rays, occ, n, 0.0, None, u_pdf)
    ref = render(sigma, rays, z, cell.config["field"])
    np.testing.assert_allclose(port.depth.numpy(), ref.depth.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.variance.numpy(), ref.variance.numpy(), rtol=1e-5, atol=1e-8)
