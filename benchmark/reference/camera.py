"""The FDT RGB phase's camera steps, in plain PyTorch, from the state a run
hands over.

One camera step draws ``n_rays`` pixels of a stack of images
(:func:`camera_draws`, from the run's seed and the step's index), casts
their pinhole rays through the pixel centres from the fixed camera poses,
samples them with the occupancy-guided sampler (``reference/render.py``),
queries the sigma branch with no gradient and the intensity branch with
it, composites the colours with the sigma weights and takes the masked L1
against the pixels' intensities. Its gradient by the intensity leaves
feeds optax's ``chain(add_decayed_weights(wd), adam(lr))`` on the intensity
group alone; sigma, the occupancy grid and the poses stay as handed over.

The intensity branch follows LONER's ``nerf_tcnn.py`` (``default_nerf_hash.yaml``):
the intensity hash grid, the real spherical harmonics of degree 4 of the
unit view direction (16 functions, :func:`sh_basis`, written from their
closed forms), concatenated after the grid's features, a ReLU MLP of
``intensity_hidden_layers`` x ``intensity_hidden_dim`` and a sigmoid.
Departures, each the port's: the hash grid is FusedHash's layout (one row
of 8 corners a cell, ``reference/encoders/fused.py``) where tiny-cuda-nn
hashes each vertex; the MLP's operands are rounded to bf16 with f32
products (``reference/field.py::mlp_t``) where tiny-cuda-nn computes in
fp16; tiny-cuda-nn maps the directions to [0, 1] and back before its SH,
here they are taken as they are. The field is computed in the program's
point chunks, each chunk's MLP rounding its weight gradient to bf16 once,
as the program's does. ``lower=True`` computes both branches one
precision down (``reference/field.py``), as the control of the check.
TF32 is off.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from benchmark.draws import sub_seed
from benchmark.reference.encoders.fused_rgb import encode, init, intensity_grid
from benchmark.reference.field import init_mlp, mlp_t, sigma_t
from benchmark.reference.geometry import Rays, far_cube_exit, matrix_to_pose, pose_to_matrix
from benchmark.reference.render import ogm_z_vals
from benchmark.reference.train import Readings, _adam, named_leaves, norm

IMAGES, CAMERA_STEPS = 5, 6  # sub-seed tags beside benchmark/draws.py's 1-4

# real SH, Condon-Shortley phase, m from -l to l within each band l
_C0 = 0.5 * math.sqrt(1.0 / math.pi)
_C1 = math.sqrt(3.0 / (4.0 * math.pi))
_C2 = (0.5 * math.sqrt(15.0 / math.pi), 0.25 * math.sqrt(5.0 / math.pi), 0.25 * math.sqrt(15.0 / math.pi))
_C3 = (0.25 * math.sqrt(35.0 / (2.0 * math.pi)), 0.5 * math.sqrt(105.0 / math.pi),
       0.25 * math.sqrt(21.0 / (2.0 * math.pi)), 0.25 * math.sqrt(7.0 / math.pi), 0.25 * math.sqrt(105.0 / math.pi))


def sh_basis(d: torch.Tensor) -> torch.Tensor:
    """(16, N) real SH of bands 0-3 of unit directions (3, N)."""
    x, y, z = d[0], d[1], d[2]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, _C0),
        -_C1 * y, _C1 * z, -_C1 * x,
        _C2[0] * xy, -_C2[0] * yz, _C2[1] * (3.0 * zz - 1.0), -_C2[0] * xz, _C2[2] * (xx - yy),
        -_C3[0] * y * (3.0 * xx - yy), _C3[1] * xy * z, -_C3[2] * y * (5.0 * zz - 1.0), _C3[3] * z * (5.0 * zz - 3.0),
        -_C3[2] * x * (5.0 * zz - 1.0), _C3[4] * z * (xx - yy), -_C3[0] * x * (xx - 3.0 * yy),
    ])


def init_intensity(gen: torch.Generator, field: dict, device) -> dict:
    """The intensity branch's ``{"table": ..., "mlp": ...}``: the grid's
    table drawn first, then the colour MLP (He-normal, zero biases)."""
    grid = intensity_grid(field)
    table = init(gen, grid, device)
    in_dim = grid["hash_levels"] * grid["hash_features"] + field["sh_degree"] ** 2
    mlp = init_mlp(gen, in_dim, field["intensity_hidden_dim"], field["intensity_hidden_layers"], field["num_colors"],
                   device)
    return {"table": table, "mlp": mlp}


def colour_t(params: dict, pts_cube: torch.Tensor, dirs: torch.Tensor, field: dict, lower: bool = False):
    """(C, N) colours in (0, 1) of cube points (3, N) seen along unit
    directions (3, N)."""
    if field["sh_degree"] != 4:
        raise ValueError(f"sh_degree {field['sh_degree']}: the reference writes degree 4 alone")
    h = encode(params["table"], (pts_cube + 1.0) / 2.0, intensity_grid(field), lower)
    return torch.sigmoid(mlp_t(params["mlp"], torch.cat([h, sh_basis(dirs)]), lower))


def camera_draws(seed: int, step: int, n_rays: int, batch: int, height: int, width: int, n_samples: int,
                 device) -> Dict[str, torch.Tensor]:
    """Camera step ``step``'s random numbers, in the port's ``CameraDraws``
    fields: each ray's image, row and column, the sampler's stratified and
    inverse-CDF uniforms (half the samples each) and the two encoders' key
    words."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, CAMERA_STEPS, step))
    half = n_samples // 2

    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=device)

    return {"bi": randint(batch, (n_rays,)), "yi": randint(height, (n_rays,)), "xi": randint(width, (n_rays,)),
            "u_strat": torch.rand((n_rays, half), generator=gen, device=device),
            "u_pdf": torch.rand((n_rays, half), generator=gen, device=device),
            "enc_key": randint(2**32, (2,)), "enc_key_intensity": randint(2**32, (2,))}


@dataclass
class CameraInputs:
    """What the reference is handed: the run's images and cameras, and the
    state its set-up left (parameters, the intensity group's Adam moments
    and count, the occupancy grid), as copies."""

    seed: int
    field: dict
    train: dict
    rgb: dict  # the configuration's rgb_phase block
    images: torch.Tensor  # (B, H, W, C) in [0, 1]
    masks: torch.Tensor  # (B, H, W) bool: True where a pixel trains
    cam_poses: np.ndarray  # (B, 4, 4) world_T_camera
    K: np.ndarray  # (3, 3)
    scale: float
    shift: np.ndarray  # (3,)
    ray_range: tuple
    first_step: int  # the draws' index of the first step followed
    sigma: dict
    intensity: dict
    mu: dict
    nu: dict
    count: int
    occ: torch.Tensor
    device: str = "cuda"


def pixel_rays(inp: CameraInputs, d: dict):
    """(rays, target (N, C)) of the drawn pixels: through the pixel centres,
    invalid where the pixel is masked or under 1 m of the ray lies inside the
    cube."""
    dev = inp.images.device
    bi, yi, xi = d["bi"], d["yi"], d["xi"]
    k_inv = torch.linalg.inv(torch.as_tensor(inp.K, dtype=torch.float64)).to(torch.float32).to(dev)
    poses6 = matrix_to_pose(torch.as_tensor(np.asarray(inp.cam_poses, np.float32))).to(dev)
    pix = torch.stack([xi.float() + 0.5, yi.float() + 0.5, torch.ones_like(xi, dtype=torch.float32)], dim=-1)
    t = pose_to_matrix(poses6[bi])
    d_world = (t[:, :3, :3] @ (pix @ k_inv.T)[:, :, None])[:, :, 0]
    d_world = d_world / torch.sqrt(torch.sum(d_world * d_world, dim=-1, keepdim=True) + 1e-20)
    shift = torch.as_tensor(np.asarray(inp.shift, np.float32), device=dev)
    origins = (t[:, :3, 3] + shift) / inp.scale
    near = torch.full((len(bi),), inp.ray_range[0] / inp.scale, device=dev)
    far = torch.minimum(torch.full_like(near, inp.ray_range[1] / inp.scale), far_cube_exit(origins, d_world))
    valid = inp.masks[bi, yi, xi] & (far > near + 1.0 / inp.scale)
    return Rays(origins, d_world, near, far, valid, torch.zeros_like(near)), inp.images[bi, yi, xi]


def composite_colour(sigma: dict, intensity: dict, rays: Rays, z_vals: torch.Tensor, field: dict,
                     lower: bool = False) -> torch.Tensor:
    """(N, C): the colours at the samples composited with the sigma branch's
    weights (relu sigma, a 1e10 terminal interval), the field taken in
    ``field["point_chunks"]`` chunks."""
    n, s = z_vals.shape
    pts = (rays.origins.T[:, :, None] + rays.directions.T[:, :, None] * z_vals[None]).reshape(3, n * s)
    dirs = rays.directions.T[:, :, None].expand(3, n, s).reshape(3, n * s)
    chunks = field["point_chunks"] if (n * s) % field["point_chunks"] == 0 else 1
    sig, col = [], []
    for p, dd in zip(pts.chunk(chunks, dim=1), dirs.chunk(chunks, dim=1)):
        with torch.no_grad():
            sig.append(sigma_t(sigma, p, field, lower))
        col.append(colour_t(intensity, p, dd, field, lower))
    sigmas = torch.cat(sig).reshape(n, s)
    colours = torch.cat(col, dim=1).reshape(-1, n, s)
    deltas = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], torch.full_like(z_vals[:, :1], 1e10)], dim=-1)
    d_norm = torch.sqrt(torch.sum(rays.directions * rays.directions, dim=-1, keepdim=True) + 1e-20)
    alphas = 1.0 - torch.exp(-(deltas * d_norm) * torch.relu(sigmas))
    trans = torch.cumprod(torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10], dim=-1), dim=-1)[:, :-1]
    weights = (alphas * trans).detach()
    return torch.sum(weights[None] * colours, dim=-1).T


def camera_loss(rgb: torch.Tensor, target: torch.Tensor, valid: torch.Tensor, cam_lambda: float) -> torch.Tensor:
    """LONER's masked L1: the mean over the valid rays of each ray's mean
    absolute error over the channels."""
    m = valid.to(rgb.dtype)
    return cam_lambda * torch.sum(torch.mean(torch.abs(rgb - target), dim=-1) * m) / torch.clamp(torch.sum(m), min=1.0)


def follow_camera(inp: CameraInputs, lower: bool = False, n_steps: int = 3, states=None) -> Readings:
    """``n_steps`` camera steps from the handed-over state: each step's loss,
    each intensity leaf's gradient (the first step) and change (over the
    steps), by norm.

    With ``states`` (one a step: the intensity leaves, their Adam first and
    second moments, each a list in leaf order, and the Adam count the
    program started that step from) each step starts from the program's own
    state instead of the reference's last one, and the change is the sum of
    the reference's own updates of those states. Each step is then held
    alone: a masked L1 flips a ray's gradient where its colour meets its
    target, a ReLU unit turns on or off at zero, and Adam moves an element
    whose second moment is small by about the learning rate whatever its
    gradient's size, so rounding that the two sides do in other orders, left
    to compound over free-running steps, reads as a gap of 1e-4 in about one
    run in fifty."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(inp.device)
    tr, rgb = inp.train, inp.rgb
    names = [f"intensity.{n}" for n, _ in named_leaves(inp.intensity)]
    leaves = [t.detach().clone() for _, t in named_leaves(inp.intensity)]
    opt = [{"mu": m.detach().clone(), "nu": v.detach().clone(), "count": inp.count}
           for (_, m), (_, v) in zip(named_leaves(inp.mu), named_leaves(inp.nu))]
    init = [t.clone() for t in leaves]
    b, h, w = inp.images.shape[:3]
    read = Readings()

    def unflatten(ts):
        it = iter(ts)
        return {"table": next(it), "mlp": {"w": [next(it) for _ in inp.intensity["mlp"]["w"]],
                                           "b": [next(it) for _ in inp.intensity["mlp"]["b"]]}}

    total = [torch.zeros_like(t) for t in leaves]
    for k in range(n_steps):
        i = inp.first_step + k
        if states is not None:
            s_leaves, s_mu, s_nu, s_count = states[k]
            leaves = [t.detach().to(dev, copy=True) for t in s_leaves]
            opt = [{"mu": m.detach().to(dev, copy=True), "nu": v.detach().to(dev, copy=True), "count": int(s_count)}
                   for m, v in zip(s_mu, s_nu)]
        d = camera_draws(inp.seed, i, rgb["rgb_rays"], b, h, w, tr["n_samples_train"], dev)
        rays, target = pixel_rays(inp, d)
        z = ogm_z_vals(rays, inp.occ, tr["n_samples_train"], tr["perturb"], d["u_strat"], d["u_pdf"])
        params = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            colour = composite_colour(inp.sigma, unflatten(params), rays, z, inp.field, lower)
            loss = camera_loss(colour, target, rays.valid, rgb["cam_lambda"])
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(params, grads)]
        read.losses[i] = float(loss.detach())
        if k == 0:
            read.grads.update({n: norm(g) for n, g in zip(names, grads)})
        finite = bool(torch.isfinite(loss.detach())) and all(bool(torch.all(torch.isfinite(g))) for g in grads)
        if finite:
            with torch.no_grad():
                new = []
                for j, (p, g) in enumerate(zip(leaves, grads)):
                    upd, opt[j] = _adam(g + tr["rgb_weight_decay"] * p, p, opt[j], tr["lr_rgb"])
                    new.append(p + upd)
                total = [t + (a - p) for t, a, p in zip(total, new, leaves)]
                leaves = new
    if states is None:
        read.changes.update({n: norm(a - b0) for n, a, b0 in zip(names, leaves, init)})
    else:
        read.changes.update({n: norm(t) for n, t in zip(names, total)})
    return read
