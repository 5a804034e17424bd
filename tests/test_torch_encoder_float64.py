"""The alternate hash encoders' table gradient on a float64 table
(loner_tpu_torch/ops/hash_encode_fast.py, cell_hash.py): the backward sums
in the table's dtype, so a float64 table gives the float64 sum of the terms
the f32 run sums, the reference that chip_smoke.py's leg 3h holds the card
against. The f32 table gradient is that of tests/test_torch_hash_encoders.py."""
import numpy as np
import pytest
import torch

from loner_tpu_torch.models.hash_encoding import HashEncodingConfig, hash_encode_t
from loner_tpu_torch.models.nerf import cell_config_from
from loner_tpu_torch.ops import cell_hash as ch
from loner_tpu_torch.ops import hash_encode_fast as hf

ENC = HashEncodingConfig(n_levels=4, log2_hashmap_size=12, base_resolution=4)
N = 3000


def _inputs(seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    pts = torch.rand((3, N), generator=gen)
    hash_table = torch.rand((ENC.n_levels, 2, ENC.table_size), generator=gen) * 2 - 1
    cell_table = torch.rand((ENC.n_levels, cell_config_from(ENC, "exact").table_size, 16), generator=gen) * 2 - 1
    u = torch.rand((ENC.n_levels, N), generator=gen)
    g = torch.randn((2 * ENC.n_levels, N), generator=gen)
    return pts, hash_table, cell_table, u, g


MODES = {
    "exact": (False, lambda t, p, u: hash_encode_t(t, p, ENC)),
    "packed": (False, lambda t, p, u: hf.hash_encode_packed_t(t, p, ENC)),
    "packed_corner": (False, lambda t, p, u: hf.hash_encode_packed_t(t, p, ENC, u=u)),
    "cell_exact": (True, lambda t, p, u: ch.cell_hash_encode_t(t, p, cell_config_from(ENC, "exact"))),
    "cell_level1": (True, lambda t, p, u: ch.cell_hash_encode_t(t, p, cell_config_from(ENC, "level1"))),
    "cell_level1_corner": (True, lambda t, p, u: ch.cell_hash_encode_t(t, p, cell_config_from(ENC, "level1"), u=u)),
}


def _table_grad(fn, table, pts, u, g):
    t = table.clone().requires_grad_(True)
    torch.sum(fn(t, pts, u) * g).backward()
    return t.grad


@pytest.mark.parametrize("mode", sorted(MODES))
def test_float64_table_gradient_sums_the_f32_terms(mode):
    """A float64 table gives a float64 gradient within 1e-6 (normwise) of
    the f32 one, and the same forward."""
    pts, hash_table, cell_table, u, g = _inputs()
    cell, fn = MODES[mode]
    table = cell_table if cell else hash_table
    d32 = _table_grad(fn, table, pts, u, g)
    d64 = _table_grad(fn, table.double(), pts, u, g)
    assert d32.dtype == torch.float32 and d64.dtype == torch.float64
    rel = float(torch.linalg.vector_norm(d32.double() - d64) / torch.linalg.vector_norm(d64))
    assert 0 < rel < 1e-6, rel
    if mode != "exact":  # the table is read in bf16: the forward does not see its dtype
        assert torch.equal(fn(table.double(), pts, u), fn(table, pts, u))


def test_float64_packed_gradient_is_the_exact_sum_of_its_terms():
    """The packed encoder's float64 table gradient equals numpy's float64
    sum of (trilinear weight x cotangent), each term rounded to f32 as the
    f32 backward forms it, at the fused corner indices."""
    pts, table, _, u, g = _inputs(1)
    d64 = _table_grad(MODES["packed"][1], table.double(), pts, u, g)
    idx, w = hf._fused_indices(pts, ENC)  # (L, 8, N)
    gl = g.reshape(ENC.n_levels, 2, N)
    ref = np.zeros((2, ENC.n_levels * ENC.table_size))
    for f in range(2):
        np.add.at(ref[f], idx.reshape(-1).numpy(), (w * gl[:, f][:, None, :]).reshape(-1).numpy().astype(np.float64))
    got = d64.permute(1, 0, 2).reshape(2, -1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
