"""The data preparation of the PyTorch port against the JAX package: the
rosbag numerics (loner_tpu_torch/data/rosbag_convert.py: the cases of
tests/test_dataset_submaps.py's trajectory extraction, the timestamp
heuristics with ns and µs stamps and negative offsets, the box and range
filters of ``scan_from_arrays``), the ROS-less raises, and the native
point-cloud functions (runtime/native.py) on tests/test_native.py's cases
against JAX's ``loner_tpu.runtime.native`` (which loads the tracked
native/libloner_native.so; its ``build_native`` is never called here),
once through the port's library and once through its numpy path, and
both paths equal on an Ouster-size sweep. The JAX modules are imported
inside the tests: ``loner_tpu.runtime`` pulls in orbax, which the card's
machine lacks."""
import os

import numpy as np
import pytest

from loner_tpu_torch.data import rosbag_convert as trb
from loner_tpu_torch.data import synthetic
from loner_tpu_torch.runtime import native as tnative

NUMPY = {"extract_cloud": tnative.extract_cloud_np, "voxel_downsample": tnative.voxel_downsample_np,
         "box_filter": tnative.box_filter_np, "range_filter": tnative.range_filter_np,
         "spherical_occupancy": tnative.spherical_occupancy_np}


@pytest.fixture(params=["library", "numpy"])
def port(request):
    """The port's native functions by name: its library's, or its numpy paths."""
    if request.param == "library":
        assert tnative.has_native(), f"the port's native library did not build: {tnative.build_log}"
        return lambda name: getattr(tnative, name)
    return NUMPY.__getitem__


@pytest.fixture(scope="module")
def jrb():
    from loner_tpu.data import rosbag_convert

    return rosbag_convert


@pytest.fixture(scope="module")
def jax_native():
    """JAX's module, on its tracked library (its _lib would build it in
    native/ were the file missing)."""
    from loner_tpu.runtime import native as jnative

    assert os.path.exists(jnative._SO_PATH)
    assert jnative.has_native()
    return jnative


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-20, 20, (5000, 3)).astype(np.float32)
    ts = np.sort(rng.uniform(0, 0.1, 5000)).astype(np.float32)
    return pts, ts, rng.uniform(size=5000) > 0.05


def _sorted_rows(a):
    return a[np.lexsort(a.T[::-1])]


# ---------------------------------------------------------------------------
# native functions against JAX's, on tests/test_native.py's cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keep,n_out,n", [(0.9, 2048, 5000), (1.0, 256, 100), (0.5, 1000, 5000)])
def test_extract_cloud_matches_jax(port, jax_native, cloud, keep, n_out, n):
    pts, ts, valid = (a[:n] for a in cloud)
    out_p, out_v = port("extract_cloud")(pts, ts, valid, keep, n_out)
    jp, jv = jax_native.extract_cloud(pts, ts, valid, keep, n_out)
    np.testing.assert_array_equal(out_p, jp)
    np.testing.assert_array_equal(out_v, jv)
    assert out_p.shape == (n_out, 3) and out_v.dtype == bool


def test_voxel_downsample_matches_jax(port, jax_native):
    pts = np.random.default_rng(1).uniform(-5, 5, (2000, 3)).astype(np.float32)
    out = port("voxel_downsample")(pts, 0.7)
    # the port's voxels in ascending key order, JAX's library's in its hash
    # map's: the same points
    np.testing.assert_array_equal(_sorted_rows(out), _sorted_rows(jax_native.voxel_downsample(pts, 0.7)))
    keys = np.floor(out.astype(np.float64) / np.float64(np.float32(0.7))).astype(np.int64)
    assert np.array_equal(keys, np.unique(keys, axis=0))  # one point a voxel, in key order


def test_box_and_range_filters_match_jax(port, jax_native, cloud):
    pts = np.array([[0, 0, 0], [10, 0, 0], [1.9, 0, 0]], np.float32)
    np.testing.assert_array_equal(port("box_filter")(pts, np.ones(3, bool), (0, 0, 0), (4, 4, 4)),
                                  [False, True, False])
    d = np.array([0.1, 5.0, 100.0], np.float32)
    np.testing.assert_array_equal(port("range_filter")(d, np.ones(3, bool), 0.3, 50.0), [False, True, False])
    pts, _, valid = cloud
    box = ((1.0, -2.0, 0.5), (6.0, 3.0, 40.0))
    np.testing.assert_array_equal(port("box_filter")(pts, valid, *box), jax_native.box_filter(pts, valid, *box))
    dist = np.linalg.norm(pts, axis=1).astype(np.float32)
    np.testing.assert_array_equal(port("range_filter")(dist, valid, 5.0, 30.0),
                                  jax_native.range_filter(dist, valid, 5.0, 30.0))
    v8 = valid.astype(np.uint8)
    port("box_filter")(pts, v8, *box)
    np.testing.assert_array_equal(v8, valid)  # the caller's mask is left as it was


def test_spherical_occupancy_matches_jax(port, jax_native):
    """The port bins in float64, JAX's library in float32: the same image
    but for directions on a bin border (tests/test_native.py's bound)."""
    d = np.random.default_rng(2).normal(size=(3000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    img = port("spherical_occupancy")(d, np.ones(3000, bool), 64, 32, -0.5, 1.5)
    assert (img == jax_native.spherical_occupancy(d, np.ones(3000, bool), 64, 32, -0.5, 1.5)).mean() > 0.995
    from loner_tpu.tracking.sky import spherical_projection

    assert (img == spherical_projection(d, np.ones(3000, bool), 64, 32, (-0.5, 1.5))).mean() > 0.995


def test_library_and_numpy_paths_equal_on_an_ouster_sweep():
    """One 128 x 1024 sweep (131,072 returns, Ouster OS-128 size): every
    function's library and numpy paths give the same arrays."""
    assert tnative.has_native(), tnative.build_log
    scene = synthetic.Scene.default()
    pose = synthetic.circular_trajectory(n_poses=4, radius=6.0)[0][0]
    rng = np.random.default_rng(3)
    dirs, dists, stamps, hit = synthetic.simulate_scan(scene, pose, 0.0, n_channels=128, n_azimuth=1024,
                                                       max_range=60.0, rng=rng, noise_std=0.01)
    assert dirs.shape == (131072, 3)
    pts = np.where(hit[:, None], dirs * np.nan_to_num(dists, posinf=0.0)[:, None], 0.0).astype(np.float32)
    cases = {
        "extract_cloud": (pts, stamps, hit, 0.9, 16384),
        "voxel_downsample": (pts[hit], 0.2),
        "box_filter": (pts, hit, (-1.0, 0.0, -0.5), (3.0, 2.5, 2.0)),
        "range_filter": (np.nan_to_num(dists, posinf=1e9), hit, 1.0, 40.0),
        "spherical_occupancy": (dirs, hit, 1024, 128, -np.pi / 6, np.pi / 2),
    }
    for name, args in cases.items():
        lib, ref = getattr(tnative, name)(*args), NUMPY[name](*args)
        for a, b in zip(lib if isinstance(lib, tuple) else (lib,), ref if isinstance(ref, tuple) else (ref,)):
            np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# rosbag numerics
# ---------------------------------------------------------------------------


def test_poses_from_stamped_quats_matches_jax(jrb):
    stamps = np.array([2.0, 0.0, 1.0])
    pos = np.array([[2, 0, 0], [0, 0, 0], [1, 0, 0]], float)
    quats = np.array([[0, 0, 0, 1], [0, 0, 0, 1], [0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)]], float)
    poses, times = trb.poses_from_stamped_quats(stamps, pos, quats)
    np.testing.assert_allclose(times, [0.0, 1.0, 2.0])
    np.testing.assert_allclose(poses[:, 0, 3], [0.0, 1.0, 2.0])
    np.testing.assert_allclose(poses[1, :3, 0], [0, 1, 0], atol=1e-6)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(50, 4))
    args = (rng.uniform(0, 10, 50), rng.normal(size=(50, 3)), q)
    # the rotations are float32 in both packages, from other orders of the
    # quaternion products: a few ulps apart
    for a, b in zip(trb.poses_from_stamped_quats(*args), jrb.poses_from_stamped_quats(*args)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_select_tf_pair_matches_jax(jrb):
    parents = ["map", "odom", "/map", "map"]
    children = ["base", "base", "base", "lidar"]
    args = (parents, children, np.arange(4.0), np.arange(12.0).reshape(4, 3), np.tile([0, 0, 0, 1.0], (4, 1)),
            "map", "base")
    s, p, q = trb.select_tf_pair(*args)
    np.testing.assert_allclose(s, [0.0, 2.0])
    np.testing.assert_allclose(p[:, 0], [0.0, 6.0])
    for a, b in zip((s, p, q), jrb.select_tf_pair(*args)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("unit,scale", [("s", 1.0), ("ms", 1e3), ("us", 1e6), ("ns", 1e9)])
@pytest.mark.parametrize("offset", [0.0, -0.05])
@pytest.mark.parametrize("relative", [True, False])
def test_normalize_point_times_matches_jax(jrb, unit, scale, offset, relative):
    """Per-point times over a 0.1 s sweep in each unit (negative offsets as
    some Velodynes emit them), relative to the scan start or absolute."""
    t = (np.linspace(0.0, 0.1, 777) + offset) * scale
    stamp = 1_700_000_000.25
    out = trb.normalize_point_times(t, stamp, relative)
    np.testing.assert_array_equal(out, jrb.normalize_point_times(t, stamp, relative))
    if unit in ("us", "ns"):
        np.testing.assert_allclose(out - stamp, np.linspace(0.0, 0.1, 777), atol=1e-6)
    assert len(trb.normalize_point_times(np.zeros(0), stamp)) == 0


def test_fusion_portable_times_and_scan_from_arrays_match_jax(jrb):
    np.testing.assert_array_equal(trb.fusion_portable_times(5000, 2048, 12.5), jrb.fusion_portable_times(5000, 2048,
                                                                                                          12.5))
    rng = np.random.default_rng(5)
    pts = rng.uniform(-10, 10, (4000, 3))
    pts[:20] *= 0.01  # under min_range
    times = rng.uniform(0, 0.1, 4000)
    for box in ((None, None), ((-1.0, 0.0, -0.5), (3.0, 2.5, 2.0))):
        tcfg = trb.BagConversionConfig(remove_box_center=box[0], remove_box_size=box[1])
        jcfg = jrb.BagConversionConfig(remove_box_center=box[0], remove_box_size=box[1])
        out, ref = trb.scan_from_arrays(pts, times, tcfg), jrb.scan_from_arrays(pts, times, jcfg)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
        assert np.all(np.diff(out[2]) >= 0) and out[1].min() >= 0.3
    assert trb.BagConversionConfig() == trb.BagConversionConfig(lidar_topic="/os_cloud_node/points")


def test_bag_readers_raise_without_ros(monkeypatch, tmp_path):
    monkeypatch.setattr(trb, "HAS_ROS", False)
    for call in (lambda: trb.convert_bag("x.bag", str(tmp_path)),
                 lambda: trb.extract_trajectory_from_bag("x.bag", str(tmp_path / "t.txt")),
                 lambda: trb.extract_images_from_bag("x.bag", str(tmp_path))):
        with pytest.raises(RuntimeError, match="rosbag is not available"):
            call()
    assert not os.listdir(tmp_path)
