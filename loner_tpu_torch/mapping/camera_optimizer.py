"""Camera and intensity training: the decoupled RGB phase.

The port of ``loner_tpu/mapping/camera_optimizer.py``: after the sigma field
has trained from lidar, the intensity branch (its encoder and MLP) trains
from camera images with per-image pixel masks, the sigma branch detached and
the camera poses fixed. One step samples ``n_rays`` pixels across a stacked
image window, builds their rays, renders with ``sigma_only=False,
detach_sigma=True`` (kernels B1 and B3 forward, B2 for the intensity lines'
gradient) and takes one Adam step of the intensity group on the masked L1
intensity loss. Like the JAX step it counts itself in ``global_step`` (which
the lidar loss schedule reads) and a non-finite step in ``skipped_steps``.

A step records its spans (``runtime/profiling.py``): ``loner.camera.step``
holding ``.forward`` (``.rays``, ``.sample``, the field's ``loner.field``
chunks, each with its ``loner.field.intensity``, ``loner.composite`` and
``.loss``), ``.backward`` (``autograd.grad``) and ``.update`` (``.finite``,
``.adam``).

The pixel and sampler draws come in a :class:`CameraDraws`, or from the
step's ``torch.Generator``, so that a caller can replay another source's.
With a mesh (``mesh=``) the step runs on the mesh's first device, where
the mesh's state lives.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.geometry import se3
from loner_tpu_torch.geometry.rays import RayBundle, far_cube_exit
from loner_tpu_torch.mapping.optimizer import (
    MapperConfig,
    MapperState,
    _all_finite,
    _masked_group,
    _tree_unflatten,
    draw_encoder_uniforms,
    tree_leaves,
)
from loner_tpu_torch.models import sampling
from loner_tpu_torch.models.losses import compute_camera_loss
from loner_tpu_torch.models.rendering import render_rays
from loner_tpu_torch.runtime.profiling import span


class CameraWindow(NamedTuple):
    """A stacked window of B images on one device."""

    intensities: torch.Tensor  # (B, H, W, C) in [0, 1]
    masks: torch.Tensor  # (B, H, W) bool: True where pixels are trainable
    poses: torch.Tensor  # (B, 6) world_T_camera se3 vectors (fixed)
    k_inv: torch.Tensor  # (3, 3) inverse intrinsics (shared)

    @property
    def batch(self) -> int:
        return self.intensities.shape[0]


class CameraDraws(NamedTuple):
    """Every random number one camera step uses."""

    bi: torch.Tensor  # (N,) int64 image of each ray
    yi: torch.Tensor  # (N,) int64 pixel row
    xi: torch.Tensor  # (N,) int64 pixel column
    u_strat: torch.Tensor  # (N, S/2) stratified jitter (OGM); (N, S) under UNIFORM
    u_pdf: Optional[torch.Tensor]  # (N, S/2) inverse-CDF uniforms (OGM)
    enc_key: torch.Tensor  # (2,) int64: the sigma encoder's key words
    enc_key_intensity: torch.Tensor  # (2,) int64: the intensity encoder's
    # (L, points per chunk): the "cell" intensity encoder's corner uniforms,
    # shared by every point chunk (None: drawn from enc_key_intensity)
    u_enc_intensity: Optional[torch.Tensor] = None


def upsample_images(images: np.ndarray, masks: np.ndarray, K: np.ndarray, factor: int = 2):
    """Bilinear upsampling of (B, H, W, C) images by ``factor`` with the
    intrinsics rescaled (the reference's optional 2x RGB-phase upsampling);
    masks (B, H, W) are nearest-sampled. Returns (images', masks', K')."""
    if factor <= 1:
        return images, masks, K
    b, h, w, c = images.shape
    nh, nw = h * factor, w * factor
    # align-corners=False: output pixel centre -> source coordinate
    ys = (np.arange(nh) + 0.5) / factor - 0.5
    xs = (np.arange(nw) + 0.5) / factor - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 2)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 2)
    fy = np.clip(ys - y0, 0.0, 1.0)[None, :, None, None]  # (1, nh, 1, 1)
    fx = np.clip(xs - x0, 0.0, 1.0)[None, None, :, None]  # (1, 1, nw, 1)
    g = images[:, y0][:, :, x0]
    g01 = images[:, y0][:, :, x0 + 1]
    g10 = images[:, y0 + 1][:, :, x0]
    g11 = images[:, y0 + 1][:, :, x0 + 1]
    up = (g * (1 - fy) * (1 - fx) + g01 * (1 - fy) * fx + g10 * fy * (1 - fx) + g11 * fy * fx).astype(np.float32)
    yn = np.clip(np.round(ys).astype(np.int64), 0, h - 1)
    xn = np.clip(np.round(xs).astype(np.int64), 0, w - 1)
    masks_up = masks[:, yn][:, :, xn]
    # K maps rays to continuous pixel coordinates (index + 0.5), where
    # upsampling is exactly x' = f x: K' = diag(f, f, 1) K
    Kp = np.asarray(K, np.float64).copy()
    Kp[:2] *= factor
    return up, masks_up, Kp


def stack_camera_window(images: np.ndarray, masks: np.ndarray, poses: np.ndarray, K: np.ndarray, upsample: int = 1,
                        device="cuda") -> CameraWindow:
    """(B, H, W, C) images, (B, H, W) masks, (B, 4, 4) world_T_camera poses
    and the (3, 3) intrinsics as a window on ``device`` (``upsample`` 2: the
    reference's RGB-phase option)."""
    dev = resolve_device(device)
    images, masks, K = upsample_images(images, masks, K, upsample)
    pose6 = se3.matrix_to_pose(torch.as_tensor(np.asarray(poses, np.float32)))
    return CameraWindow(
        torch.as_tensor(np.asarray(images, np.float32)).to(dev),
        torch.as_tensor(np.asarray(masks, bool)).to(dev),
        pose6.to(dev),
        torch.as_tensor(np.linalg.inv(K).astype(np.float32)).to(dev),
    )


def draw_camera_step(cfg: MapperConfig, window: CameraWindow, n_rays: int, generator: torch.Generator,
                     device) -> CameraDraws:
    """Draw one camera step's random numbers from ``generator``."""
    b, h, w = window.intensities.shape[:3]
    half = cfg.n_samples_train // 2
    uniform = cfg.samples_strategy == "UNIFORM"

    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=generator, device=device)

    return CameraDraws(
        bi=randint(b, (n_rays,)), yi=randint(h, (n_rays,)), xi=randint(w, (n_rays,)),
        u_strat=torch.rand((n_rays, cfg.n_samples_train if uniform else half), generator=generator, device=device),
        u_pdf=None if uniform else torch.rand((n_rays, half), generator=generator, device=device),
        enc_key=randint(2**32, (2,)), enc_key_intensity=randint(2**32, (2,)),
        u_enc_intensity=draw_encoder_uniforms(cfg.nerf, cfg.nerf.pos_encoding_intensity.n_levels,
                                              n_rays * cfg.n_samples_train, cfg.nerf.point_chunks, generator,
                                              device),
    )


def _sample_camera_rays(window: CameraWindow, cube, cfg: MapperConfig, bi: torch.Tensor, yi: torch.Tensor,
                        xi: torch.Tensor) -> Tuple[RayBundle, torch.Tensor]:
    """The rays of pixels (bi, yi, xi) through their centres (index + 0.5),
    and the target intensities (N, C). Rays of masked-out pixels, and rays
    with under 1 m inside the cube, are invalid."""
    n = bi.shape[0]
    target = window.intensities[bi, yi, xi]  # (N, C)
    pix_ok = window.masks[bi, yi, xi]
    ones = torch.ones(n, dtype=torch.float32, device=bi.device)
    pix_h = torch.stack([xi.to(torch.float32) + 0.5, yi.to(torch.float32) + 0.5, ones], dim=-1)
    dirs_cam = pix_h @ window.k_inv.T  # (N, 3)
    T = se3.pose_to_matrix(window.poses[bi])  # (N, 4, 4)
    scale = cube.scale_factor
    origins = (T[:, :3, 3] + cube.shift.to(T.device)) / scale
    dirs = (T[:, :3, :3] @ dirs_cam[:, :, None])[:, :, 0]
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-20)
    near = torch.full((n,), cfg.ray_range[0] / scale, dtype=torch.float32, device=bi.device)
    far = torch.minimum(torch.full((n,), cfg.ray_range[1] / scale, dtype=torch.float32, device=bi.device),
                        far_cube_exit(origins, dirs))
    valid = pix_ok & (far > near + 1.0 / scale)
    return RayBundle(origins, dirs, dirs, near, far, valid, torch.zeros_like(near)), target


def camera_rays_and_samples(cfg: MapperConfig, cube, window: CameraWindow, occ_grid, draws: CameraDraws):
    """The rays of a camera step's pixel draws, their target intensities and
    their samples (the occupancy-grid sampler under OGM, else uniform)."""
    with span("loner.camera.step.rays"):
        bundle, target = _sample_camera_rays(window, cube, cfg, draws.bi, draws.yi, draws.xi)
    with span("loner.camera.step.sample"):
        if cfg.samples_strategy == "OGM":
            z_vals = sampling.occ_grid_sampler_z_vals(bundle, occ_grid, cfg.n_samples_train, cfg.perturb,
                                                      draws.u_strat, draws.u_pdf)
        else:
            z_vals = sampling.uniform_sampler_z_vals(bundle, cfg.n_samples_train, cfg.perturb, draws.u_strat)
    return bundle, target, z_vals


def camera_forward(cfg: MapperConfig, params, bundle: RayBundle, target: torch.Tensor, z_vals: torch.Tensor,
                   enc_key: torch.Tensor, enc_key_intensity: torch.Tensor,
                   u_enc_intensity: Optional[torch.Tensor] = None):
    """The forward half of :func:`camera_loss_and_grads`: (loss, aux,
    leaves), the loss and aux still attached to the graph through
    ``leaves``, the leaves of ``params["intensity"]`` that the backward
    differentiates by."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params["intensity"])]
    p = {"sigma": params["sigma"], "intensity": _tree_unflatten(params["intensity"], leaves)}
    with torch.enable_grad():
        render = render_rays(p, bundle, z_vals, cfg.nerf, enc_key, sigma_only=False, detach_sigma=True,
                             key_intensity=enc_key_intensity, enc_u_intensity=u_enc_intensity)
        with span("loner.camera.step.loss"):
            loss, aux = compute_camera_loss(render, target, bundle.valid, cfg.loss)
    return loss, aux, leaves


def camera_backward(loss: torch.Tensor, leaves) -> list:
    """The backward half: the gradient of ``loss`` by each leaf (zeros for a
    leaf the loss does not reach)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]


def camera_loss_and_grads(cfg: MapperConfig, params, bundle: RayBundle, target: torch.Tensor, z_vals: torch.Tensor,
                          enc_key: torch.Tensor, enc_key_intensity: torch.Tensor,
                          u_enc_intensity: Optional[torch.Tensor] = None):
    """The field part of a camera step: render ``bundle`` at ``z_vals`` with
    ``sigma_only=False, detach_sigma=True``, the masked camera loss against
    ``target``, and its gradient with respect to each leaf of
    ``params["intensity"]`` (zeros for a leaf the loss does not reach).
    ``u_enc_intensity`` is the "cell" intensity encoder's corner uniforms.
    Returns (loss, aux, grads), all detached."""
    loss, aux, leaves = camera_forward(cfg, params, bundle, target, z_vals, enc_key, enc_key_intensity,
                                       u_enc_intensity)
    grads = camera_backward(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def make_camera_train_step(cfg: MapperConfig, cube, n_rays: int = 4096, mesh=None, device="cuda",
                           generator: Optional[torch.Generator] = None):
    """The intensity branch's train step ``camera_step(state, window,
    draws=None) -> (new_state, aux)`` on ``device``: ``aux`` holds the loss,
    ``cam_l1``, ``finite`` and ``grads["intensity"]``. Without ``draws`` the
    step draws from ``generator`` (one seeded with 0 on ``device`` when
    None), kept as ``camera_step.generator``. With ``mesh`` (a
    ``parallel.sharding.Mesh`` whose steps train the lidar branch) the step
    runs on the mesh's first device, where the mesh's state lives, and
    leaves every leaf there: the camera batch is small, so it is not
    split."""
    dev = resolve_device(device) if mesh is None else mesh.first_device
    cube = cube.to(dev)
    # f32 products stay f32 (the JAX package's precision), never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def camera_step(state: MapperState, window: CameraWindow, draws: Optional[CameraDraws] = None):
        with span("loner.camera.step"):
            return step(state, window, draws)

    def step(state: MapperState, window: CameraWindow, draws: Optional[CameraDraws]):
        if draws is None:
            draws = draw_camera_step(cfg, window, n_rays, generator, state.poses.device)
        with span("loner.camera.step.forward"):
            bundle, target, z_vals = camera_rays_and_samples(cfg, cube, window, state.occ_grid, draws)
            loss, aux, leaves = camera_forward(cfg, state.params, bundle, target, z_vals, draws.enc_key,
                                               draws.enc_key_intensity, draws.u_enc_intensity)
        with span("loner.camera.step.backward"):
            grads = camera_backward(loss, leaves)
        with span("loner.camera.step.update"):
            loss = loss.detach()
            g_intensity = _tree_unflatten(state.params["intensity"], grads)
            with span("loner.camera.step.finite"):
                finite = torch.isfinite(loss) & _all_finite(grads)
            with torch.no_grad(), span("loner.camera.step.adam"):
                new_intensity, opt_intensity = _masked_group(
                    g_intensity, state.opt_intensity, state.params["intensity"], False, finite,
                    cfg.lr_rgb, cfg.lr_gamma, cfg.rgb_weight_decay,
                )
                new_state = state._replace(
                    params={"sigma": state.params["sigma"], "intensity": new_intensity},
                    opt_intensity=opt_intensity,
                    global_step=state.global_step + 1,
                    skipped_steps=state.skipped_steps + (~finite).to(torch.int32),
                )
        return new_state, {"cam_l1": aux["cam_l1"].detach(), "loss": loss, "finite": finite,
                           "grads": {"intensity": g_intensity}}

    camera_step.generator = generator
    return camera_step


def optimize_intensity(cfg: MapperConfig, cube, state: MapperState, window: CameraWindow, n_iterations: int = 1000,
                       n_rays: int = 4096, seed: int = 0, log_every: int = 200, log_fn=print,
                       device="cuda") -> MapperState:
    """The FDT RGB phase: ``n_iterations`` camera steps over one window,
    drawing from a generator seeded with ``seed``; the L1 is read back and
    logged every ``log_every`` steps."""
    dev = resolve_device(device)
    step = make_camera_train_step(cfg, cube, n_rays, device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(seed))
    for i in range(n_iterations):
        state, aux = step(state, window)
        if log_every and (i + 1) % log_every == 0:
            log_fn(f"[camera] it {i + 1}/{n_iterations}: L1 {float(aux['cam_l1']):.4f}")
    return state
