"""Inverse-CDF importance sampling: kernel B3.

The port of ``loner_tpu/ops/pdf_kernel.py``. :func:`pdf_sample` is the kernel
wrapper (CUDA source in ``csrc/pdf_kernel.cu``, replacing
``loner_tpu/ops/pdf_kernel.py::_pdf_kernel``): the plain version for a CPU
tensor, the kernel for a CUDA tensor, with ``launches`` counting the
launches. :func:`pdf_sample_ref` is the plain version, the broadcast
compare-and-count of ``loner_tpu.models.sampling._count_le(method="count")``.
The CDF is built outside, by :func:`build_cdf`, as in the JAX package.
"""
from __future__ import annotations

import torch

from loner_tpu_torch.ops import kernels


def build_cdf(weights: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(N, M) weights -> (N, M+1) CDF: weights + eps, normalised, cumsum,
    leading 0."""
    w = weights + eps
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    return torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)


def pdf_sample_ref(bins: torch.Tensor, cdf: torch.Tensor, u: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(N, K) samples: bins (N, M+1), cdf (N, M+1), u (N, K)."""
    m = cdf.shape[-1] - 1
    # #{j : cdf[j] <= u}, in blocks of rays of at most 2^27 comparisons
    step = max(1, (1 << 27) // max(1, (m + 1) * u.shape[1]))
    inds = torch.cat([torch.sum(cdf[s:s + step, :, None] <= u[s:s + step, None, :], dim=1)
                      for s in range(0, max(u.shape[0], 1), step)])  # (N, K)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=m)
    cdf_lo = torch.gather(cdf, 1, below)
    cdf_hi = torch.gather(cdf, 1, above)
    bins_lo = torch.gather(bins, 1, below)
    bins_hi = torch.gather(bins, 1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_lo + (u - cdf_lo) / denom * (bins_hi - bins_lo)


def pdf_sample(bins: torch.Tensor, cdf: torch.Tensor, u: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(N, K) samples: kernel B3 on CUDA, the plain version on CPU."""
    if u.device.type == "cpu":
        return pdf_sample_ref(bins, cdf, u, eps)
    n, m1 = cdf.shape
    k = u.shape[1]
    kernels.require(cdf, "cdf", torch.float32)
    kernels.require(bins, "bins", torch.float32, (n, m1))
    kernels.require(u, "u", torch.float32, (n, k))
    if not (bins.device == cdf.device == u.device):
        raise ValueError("bins, cdf and u lie on different devices")
    if m1 < 2:
        raise ValueError(f"cdf: expected at least 2 entries per ray, got {m1}")
    out = torch.empty((n, k), dtype=torch.float32, device=u.device)
    if n == 0 or k == 0:
        return out
    with torch.cuda.device(u.device):
        rc = kernels.load().loner_pdf_sample(
            bins.data_ptr(), cdf.data_ptr(), u.data_ptr(), out.data_ptr(), n, m1 - 1, k, eps,
            kernels.stream_ptr(u),
        )
    kernels.check(rc, "pdf_sample")
    pdf_sample.launches += 1
    return out


kernels.counted(pdf_sample)
