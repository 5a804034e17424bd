"""The port's point-to-plane ICP (loner_tpu_torch/tracking/icp.py) against
``loner_tpu.tracking.icp`` on the CPU, from the same clouds: the voxel-hash
grid bit for bit, nearest neighbours, normals up to their sign, and the
whole coarse-to-fine ICP on a frame pair of the synthetic loop."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.tracking import icp as jicp
from loner_tpu.tracking.tracker import Tracker as JTracker, TrackerConfig as JTrackerConfig
from loner_tpu_torch.tracking import icp as ticp

import torch_parity as tp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while these tests run: their tensors are small and
    their operators many, and parallel test workers each running torch's
    default thread pool oversubscribe the cores (a SLAM case took 86 s
    instead of 4 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

N_BUCKETS = 1 << 12


@functools.lru_cache(maxsize=None)
def _pair(first: int = 0, gap: int = 1):
    """(src, src_valid, tgt, tgt_valid) numpy: the JAX tracker's downsampled
    clouds (2048 points) of frames first + gap and first of the loop."""
    _, _, _, scans, _ = tp.loop_scans(first + gap + 1)
    tracker = JTracker(JTrackerConfig(target_points=2048, motion_compensation=False))
    src = [np.asarray(a) for a in tracker._extract_cloud(scans[first + gap])]
    tgt = [np.asarray(a) for a in tracker._extract_cloud(scans[first])]
    return (*src, *tgt)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_hash_cells_matches_the_uint32_hash():
    """Negative cells wrap as two's complement; every product reduces mod
    2^32; the extremes of int32 included."""
    rng = np.random.default_rng(0)
    cells = rng.integers(-(2**31), 2**31, size=(4096, 3), dtype=np.int64).astype(np.int32)
    cells[:4] = [[0, 0, 0], [-1, -1, -1], [2**31 - 1, -(2**31), 7], [-(2**31), 2**31 - 1, -5]]
    for n_buckets in (1 << 12, 1 << 14, 1000):
        expect = np.asarray(jicp._hash_cells(jnp.asarray(cells), n_buckets))
        got = ticp._hash_cells(torch.from_numpy(cells).to(torch.int64), n_buckets).numpy()
        np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("cell_size", [1.5, 0.125, 0.3])
def test_voxel_grid_is_bit_equal(cell_size):
    src, sv, tgt, tv = _pair()
    tv = tv & (np.arange(len(tv)) % 7 != 0)  # invalid points go to the overflow bucket
    j = jicp.build_voxel_grid(jnp.asarray(tgt), jnp.asarray(tv), jnp.asarray(cell_size), N_BUCKETS, 8)
    t = ticp.build_voxel_grid(*_t(tgt, tv), cell_size, N_BUCKETS, 8)
    np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
    assert (t.table >= 0).sum() > 1000


@pytest.mark.parametrize("cell_size", [1.5, 0.125])
def test_nearest_neighbor_matches(cell_size):
    src, sv, tgt, tv = _pair()
    j = jicp.build_voxel_grid(jnp.asarray(tgt), jnp.asarray(tv), jnp.asarray(cell_size), N_BUCKETS, 8)
    t = ticp.build_voxel_grid(*_t(tgt, tv), cell_size, N_BUCKETS, 8)
    ji, jd = jicp.nearest_neighbor(j, jnp.asarray(src))
    ti, td = ticp.nearest_neighbor(t, torch.from_numpy(np.array(src)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    finite = np.isfinite(np.asarray(jd))
    np.testing.assert_array_equal(np.isfinite(td.numpy()), finite)
    # within 1e-6, relative past 1 m: hash collisions bring candidates from
    # cells ~10 m away, whose f32 distances the packages sum in other orders
    np.testing.assert_allclose(td.numpy()[finite], np.asarray(jd)[finite], rtol=1e-6, atol=1e-6)
    assert finite.sum() > 500


def test_k_nearest_matches():
    src, sv, tgt, tv = _pair()
    j = jicp.build_voxel_grid(jnp.asarray(tgt), jnp.asarray(tv), jnp.asarray(1.5), N_BUCKETS, 8)
    t = ticp.build_voxel_grid(*_t(tgt, tv), 1.5, N_BUCKETS, 8)
    _, jd = jicp.k_nearest(j, jnp.asarray(tgt), 10)
    _, td = ticp.k_nearest(t, torch.from_numpy(np.array(tgt)), 10)
    jd, td = np.asarray(jd), td.numpy()
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    np.testing.assert_allclose(td[np.isfinite(jd)], jd[np.isfinite(jd)], rtol=1e-6, atol=1e-6)
    assert np.all(np.diff(np.where(np.isfinite(td), td, 1e9), axis=1) >= 0)  # sorted


def test_normals_agree_up_to_sign():
    """|dot| >= 1 - 1e-4 for every valid point whose neighbourhood holds at
    least 3 points."""
    src, sv, tgt, tv = _pair()
    jn = np.asarray(jicp.estimate_normals(jnp.asarray(tgt), jnp.asarray(tv), jnp.asarray(1.5), 10, N_BUCKETS, 8))
    tn = ticp.estimate_normals(*_t(tgt, tv), 1.5, 10, N_BUCKETS, 8).numpy()
    grid = ticp.build_voxel_grid(*_t(tgt, tv), 1.5, N_BUCKETS, 8)
    _, dist = ticp.k_nearest(grid, torch.from_numpy(np.array(tgt)), 10)
    populated = tv & (np.isfinite(dist.numpy()).sum(axis=1) >= 3)
    assert populated.sum() > 1500
    dot = np.abs(np.sum(jn * tn, axis=-1))
    assert dot[populated].min() >= 1 - 1e-4
    np.testing.assert_allclose(np.linalg.norm(tn[populated], axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("first,gap", [(0, 1), (5, 1), (10, 2)])
def test_make_icp_matches(first, gap):
    """The whole schedule (1.5 m then 0.125 m, 10 steps each): T within 1e-4,
    rmse and fitness within 1e-5."""
    src, sv, tgt, tv = _pair(first, gap)
    cfg = dict(n_buckets=N_BUCKETS)
    jT, jr, jf = jicp.make_icp(jicp.IcpConfig(**cfg))(*(jnp.asarray(a) for a in (src, sv, tgt, tv)), jnp.eye(4))
    tT, tr, tf = ticp.make_icp(ticp.IcpConfig(**cfg), device="cpu")(*_t(src, sv, tgt, tv), torch.eye(4))
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(tr), float(jr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tf), float(jf), rtol=0, atol=1e-5)
    # the frames are gap * 0.65 m apart on the loop: ICP moved
    assert np.linalg.norm(tT.numpy()[:3, 3]) > 0.3 * gap and float(tf) > 0.2


def test_icp_point_to_plane_recovers_a_known_transform():
    """The one-shot entry with its defaults (valid masks all true, identity
    start): a cloud against a copy of itself moved by a small rigid motion."""
    src, sv, tgt, tv = _pair()
    pts = tgt[tv]
    T_true = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.05), np.sin(0.05)
    T_true[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T_true[:3, 3] = [0.2, -0.1, 0.05]
    moved = (pts - T_true[:3, 3]) @ T_true[:3, :3]  # inverse motion: ICP maps it back
    T, rmse, fit = ticp.icp_point_to_plane(*_t(moved, pts), cfg=ticp.IcpConfig(n_buckets=N_BUCKETS), device="cpu")
    jT, _, _ = jicp.icp_point_to_plane(jnp.asarray(moved), jnp.asarray(pts), cfg=jicp.IcpConfig(n_buckets=N_BUCKETS))
    np.testing.assert_allclose(T.numpy(), T_true, atol=2e-3)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-4)
    assert float(fit) > 0.9 and float(rmse) < 1e-2


def test_make_icp_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ticp.make_icp(ticp.IcpConfig())


@pytest.mark.gpu
def test_icp_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src, sv, tgt, tv = _pair()
    args = _t(src, sv, tgt, tv) + [torch.eye(4)]
    cfg = ticp.IcpConfig(n_buckets=N_BUCKETS)
    grid_c = ticp.build_voxel_grid(*_t(tgt, tv), 0.125, N_BUCKETS, 8)
    grid_g = ticp.build_voxel_grid(*(a.cuda() for a in _t(tgt, tv)), 0.125, N_BUCKETS, 8)
    assert torch.equal(grid_g.table.cpu(), grid_c.table)
    Tc, rc, fc = ticp.make_icp(cfg, device="cpu")(*args)
    Tg, rg, fg = ticp.make_icp(cfg)(*args)
    assert Tg.device.type == "cuda"
    np.testing.assert_allclose(Tg.cpu().numpy(), Tc.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(rg), float(rc), atol=1e-5)
    np.testing.assert_allclose(float(fg), float(fc), atol=1e-5)
