"""The port's map-as-simulator (loner_tpu_torch/sim/synthetic_sensors.py) on
the CPU: the service over a run directory renders what the renderers render,
as the JAX package's service does over its run directory, and the
JSON-lines server answers a client on the loopback."""
import numpy as np
import pytest
import torch

from loner_tpu.sim import synthetic_sensors as jsim
from loner_tpu_torch.analysis import renderer as trenderer
from loner_tpu_torch.sim import synthetic_sensors as tsim

import torch_parity as tp

two_threads = tp.two_threads
K = np.array([[8.0, 0.0, 8.0], [0.0, 8.0, 6.0], [0.0, 0.0, 1.0]])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX run directory, the port's, trajectory poses) of one map."""
    return tp.tiny_run_dirs(str(tmp_path_factory.mktemp("sim")))


def test_from_run_dir_defaults_to_the_card(runs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.SyntheticSensorService.from_run_dir(runs[1])


def test_service_renders_what_the_renderers_render(runs):
    """``from_run_dir`` loads the run's map; its lidar scan equals
    ``render_lidar_scan`` at the pose and its camera image
    ``render_camera_image`` (the same draws: each starts from a generator
    seeded with 0), and both are shaped as the JAX service's over the same
    map."""
    jdir, tdir, poses = runs
    svc = tsim.SyntheticSensorService.from_run_dir(tdir, device="cpu")
    jsvc = jsim.SyntheticSensorService.from_run_dir(jdir)
    scan = svc.lidar_scan(poses[3], n_channels=8, n_azimuth=64)
    ref = trenderer.render_lidar_scan(svc.cfg, svc.cube, svc.state, poses[3], n_channels=8, n_azimuth=64)
    jscan = jsvc.lidar_scan(poses[3], n_channels=8, n_azimuth=64)
    assert sorted(scan) == sorted(ref) == sorted(jscan)
    for k in scan:
        np.testing.assert_array_equal(scan[k], ref[k], err_msg=k)
        assert scan[k].shape[1:] == jscan[k].shape[1:] and scan[k].dtype == jscan[k].dtype, k
    assert scan["depth"].shape == (8 * 64,)
    img = svc.camera_image(poses[3], K, 12, 16)
    ref = trenderer.render_camera_image(svc.cfg, svc.cube, svc.state, poses[3], K, 12, 16)
    jimg = jsvc.camera_image(poses[3], K, 12, 16)
    assert sorted(img) == sorted(ref) == sorted(jimg)
    for k in img:
        np.testing.assert_array_equal(img[k], ref[k], err_msg=k)
        assert img[k].shape == jimg[k].shape and img[k].dtype == jimg[k].dtype, k


def test_server_answers_on_the_loopback(runs):
    """A client on 127.0.0.1: ping, a lidar request (its points and depth
    summary equal to the service's own scan), a camera request, and an
    error for an unknown request type; the server stops."""
    _, tdir, poses = runs
    svc = tsim.SyntheticSensorService.from_run_dir(tdir, device="cpu")
    server = tsim.SensorServer(svc).start()
    client = tsim.SensorClient(*server.address)
    try:
        assert client.request({"type": "ping"}) == {"ok": True}
        resp = client.lidar(poses[2], n_channels=8, n_azimuth=32)
        scan = svc.lidar_scan(poses[2], n_channels=8, n_azimuth=32)
        np.testing.assert_allclose(np.asarray(resp["points"]).reshape(-1, 3), scan["points"], rtol=0, atol=1e-12)
        assert resp["depth_summary"]["n_points"] == int(scan["keep"].sum())
        cam = client.camera(poses[2], K, 6, 8)
        np.testing.assert_allclose(np.asarray(cam["depth"]), svc.camera_image(poses[2], K, 6, 8)["depth"], rtol=1e-7)
        assert "error" in client.request({"type": "radar"})
    finally:
        client.close()
        server.stop()
