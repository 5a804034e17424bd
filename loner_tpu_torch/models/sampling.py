"""Ray samplers: stratified-uniform and occupancy-guided importance sampling.

The port of ``loner_tpu/models/sampling.py`` (``stratified_z_vals``,
``sample_pdf``, ``uniform_sampler_z_vals``, ``occ_grid_sampler_z_vals``).
Every ray yields exactly ``n_samples`` z values. The random draws come from
the caller as uniform tensors, so a test can hand both packages the same
numbers; with ``perturb=0`` the stratified samples are the interval ends and
need none.
"""
from __future__ import annotations

import torch

from loner_tpu_torch.models.occupancy_grid import occupancy_probs_t
from loner_tpu_torch.ops.pdf_kernel import build_cdf, pdf_sample


def stratified_z_vals(
    near: torch.Tensor,  # (N,)
    far: torch.Tensor,  # (N,)
    n_samples: int,
    perturb: float = 1.0,
    u: torch.Tensor = None,  # (N, S) uniforms in [0, 1), needed when perturb > 0
) -> torch.Tensor:
    """(N, S) linear near->far samples, jittered between interval midpoints."""
    steps = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype, device=near.device)
    z = near[:, None] * (1.0 - steps) + far[:, None] * steps
    if perturb > 0:
        mids = 0.5 * (z[:, :-1] + z[:, 1:])
        upper = torch.cat([mids, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mids], dim=-1)
        z = lower + (upper - lower) * (perturb * u)
    return z


def sample_pdf(
    bins: torch.Tensor,  # (N, M+1) bin edges
    weights: torch.Tensor,  # (N, M)
    u: torch.Tensor,  # (N, K) uniforms
    eps: float = 1e-5,
) -> torch.Tensor:
    """(N, K) inverse-CDF samples of the piecewise-constant pdf over
    ``bins``; kernel B3 for CUDA tensors."""
    return pdf_sample(bins.contiguous(), build_cdf(weights, eps).contiguous(), u.contiguous(), eps)


def uniform_sampler_z_vals(bundle, n_samples: int, perturb: float = 1.0, u: torch.Tensor = None) -> torch.Tensor:
    """(N, n_samples) stratified samples between each ray's near and far,
    differentiable through them (``u``: (N, n_samples) when perturb > 0)."""
    return stratified_z_vals(bundle.near, bundle.far, n_samples, perturb, u)


def _reattach_affine_z(z_sg: torch.Tensor, near: torch.Tensor, far: torch.Tensor) -> torch.Tensor:
    """Re-attach the (near, far) gradient to the sampler's detached output.

    Every emitted z is ``near + t * (far - near)`` with t independent of
    (near, far) given the detached occupancy CDF, so the exact affine
    gradient is restored here instead of differentiating through the sort.
    This re-attaches it to the importance half too, which the reference
    detaches: a deliberate deviation of the JAX package, kept as it is."""
    span = far - near
    t = (z_sg - near[:, None]).detach() / torch.where(
        torch.abs(span) < 1e-12, torch.ones_like(span), span
    ).detach()[:, None]
    return near[:, None] + t * span[:, None]


def occ_grid_sampler_z_vals(
    bundle,
    occ_grid: torch.Tensor,
    n_samples: int,
    perturb: float = 1.0,
    u_strat: torch.Tensor = None,  # (N, n_samples // 2)
    u_pdf: torch.Tensor = None,  # (N, n_samples // 2)
) -> torch.Tensor:
    """Half stratified-uniform, half importance-sampled from the occupancy
    grid, merged and sorted: (N, n_samples). The body runs without autograd;
    (near, far), and through them the poses, get their exact gradient
    re-attached on the way out."""
    half = n_samples // 2
    with torch.no_grad():
        near = bundle.near.detach()
        far = bundle.far.detach()
        z = stratified_z_vals(near, far, half, perturb, u_strat)
        pts_t = bundle.origins.detach().T[:, :, None] + bundle.directions.detach().T[:, :, None] * z[None]
        probs = occupancy_probs_t(occ_grid, pts_t)  # (N, half)
        mids = 0.5 * (z[:, :-1] + z[:, 1:])
        z_imp = sample_pdf(mids, probs[:, 1:-1], u_pdf)
        z_sorted = torch.sort(torch.cat([z, z_imp], dim=-1), dim=-1).values
    return _reattach_affine_z(z_sorted, bundle.near, bundle.far)
