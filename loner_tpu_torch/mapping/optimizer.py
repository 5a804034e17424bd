"""The mapping optimizer: one train step of the implicit map.

The port of ``loner_tpu/mapping/optimizer.py`` (``make_train_step_body``).
One call of the step does

  build rays from the (differentiable) keyframe poses -> occupancy-guided z
  sampling (kernel B3) -> field encode (TriadField: kernels B1/B2, and B4/B5
  for its hash level; FusedHash: B4/B5; the cell, packed and exact hash
  grids: plain gathers and scatters) + sigma MLP ->
  composite -> JS/LOS loss -> backward -> Adam for sigma / intensity / poses
  -> optional occupancy-grid update

eagerly on the state's device. The schedule's phases are runtime flags plus a
per-keyframe pose mask; ``freeze_poses`` picks the variant without the pose
backward, as the JAX package picks one of its two compiled steps.

Adam is written out to match optax's ``adam`` exactly: b1 0.9, b2 0.999,
eps 1e-8, the count incremented before the bias correction, and weight
decay as coupled L2 (``add_decayed_weights`` added to the gradient before
Adam, not AdamW). A non-finite loss or gradient, or a frozen group, leaves
that group's parameters, moments and count as they were. Everything is
selected on the device (``torch.where``), so a step makes no host sync.

Random draws (ray and sky indices or FIXED's permutation, the stratified,
pdf and occupancy-corner uniforms, the hash encoder's two key words, the
"cell" encoder's corner uniforms) come in
a :class:`StepDraws`; without one the step draws them from its
``torch.Generator``. Rays are drawn RANDOM (uniformly per step), MASK (a
share from each keyframe's trunk band) or FIXED (consecutive slices of one
permutation per window); samples OGM (occupancy-guided) or UNIFORM.

The step runs over data rows of devices (``make_mesh_train_step``; the
single-device step is its one-row case): the window's keyframes split into
contiguous blocks, one a row, each row builds its rays, samples and renders
on its own device from parameters handed to it inside the autograd graph,
and the loss, the backward's sum, Adam and the occupancy update run once, on
the first device, where the state lives (``parallel/sharding.py``,
``parallel/tp.py``). ``apply_updates=False`` returns the loss and the
gradients and leaves the state's parameters, moments, poses and grid as
they were.

``make_render_fn`` is the evaluation render: ``n_samples_test`` samples per
ray, no jitter, no gradient. ``make_debug_probe`` is the train step's ray
build, sampler and render without gradients, returning per-ray and
per-sample diagnostics for the debug dumps.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.geometry import se3
from loner_tpu_torch.geometry.rays import RayBundle, build_lidar_rays
from loner_tpu_torch.models import sampling
from loner_tpu_torch.models.losses import LossConfig, compute_lidar_loss
from loner_tpu_torch.models.mlp import round_weights
from loner_tpu_torch.models.nerf import NeRFConfig, init_nerf
from loner_tpu_torch.models.occupancy_grid import OccGridConfig, init_occ_grid, occ_grid_cotangent
from loner_tpu_torch.models.rendering import RenderResult, chunk_points, render_rays
from loner_tpu_torch.ops.fused_encoder import TableSlabs


class MapperConfig(NamedTuple):
    nerf: NeRFConfig = NeRFConfig()
    loss: LossConfig = LossConfig()
    occ: OccGridConfig = OccGridConfig()

    ray_range: Tuple[float, float] = (1.0, 50.0)
    world_scale: float = 20.0  # world-cube scale factor

    window_size: int = 8
    max_keyframes: int = 512
    rays_per_kf: int = 512
    sky_rays_per_kf: int = 64
    n_samples_train: int = 512
    n_samples_test: int = 2048  # make_render_fn's samples per ray
    perturb: float = 1.0
    samples_strategy: str = "OGM"  # OGM | UNIFORM
    # RANDOM: a uniform draw per step; MASK: the first mask_band_fraction of
    # each keyframe's draws index its trunk band (FDT); FIXED: one
    # permutation per window, sliced in order by the iteration (the caller
    # holds the permutation across the window, as OnlineMapper does)
    rays_strategy: str = "RANDOM"
    mask_band_fraction: float = 0.75
    # sequential point chunks of the train step's field pass (1 = one pass);
    # the eval render keeps NeRFConfig.point_chunks
    train_point_chunks: int = 1

    lr_sigma: float = 0.01
    lr_rgb: float = 0.01
    lr_pose: float = 0.001
    lr_gamma: float = 1.0  # exponential decay per optimizer step
    pose_lr_gamma: float = 1.0
    rgb_weight_decay: float = 1e-5
    sigma_weight_decay: float = 0.0

    @property
    def rays_per_window(self) -> int:
        return self.window_size * (self.rays_per_kf + self.sky_rays_per_kf)


class AdamState(NamedTuple):
    count: torch.Tensor  # scalar int32: steps taken
    mu: Any  # first moments, same tree as the parameters
    nu: Any  # second moments


class MapperState(NamedTuple):
    params: dict  # {"sigma": {...}, "intensity": {...}}
    poses: torch.Tensor  # (K, 6) keyframe poses (se3 vectors)
    opt_sigma: AdamState
    opt_intensity: AdamState
    opt_poses: AdamState
    occ_grid: torch.Tensor  # (V, V, V) logits
    opt_occ: AdamState
    global_step: torch.Tensor  # scalar int32
    skipped_steps: torch.Tensor  # scalar int32: non-finite guard trips


class TrainStepFlags(NamedTuple):
    """Phase flags of the keyframe schedule (host-side booleans)."""

    freeze_sigma: bool
    freeze_rgb: bool
    freeze_poses: bool
    do_occ_update: bool


class StepDraws(NamedTuple):
    """Every random number one train step uses."""

    ray_idx: Optional[torch.Tensor]  # (W, R) int64 lidar point indices per keyframe (None under FIXED)
    sky_idx: torch.Tensor  # (W, Rs) int64 sky indices per keyframe
    u_strat: torch.Tensor  # (N, S/2) stratified jitter (OGM); (N, S) under UNIFORM
    u_pdf: Optional[torch.Tensor]  # (N, S/2) inverse-CDF uniforms (OGM)
    u_occ: torch.Tensor  # (N, S) occupancy-corner uniforms
    enc_key: torch.Tensor  # (2,) int64 in [0, 2^32): the encoder's two key words
    perm: Optional[torch.Tensor] = None  # (W, P) int64: FIXED's per-keyframe permutation
    # (L, points per chunk): the "cell" encoder's corner uniforms, one block
    # shared by every point chunk (None: drawn from enc_key in each chunk)
    u_enc: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# parameter trees (nested dicts and lists of tensors)
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of dicts, lists and named tuples; None
    is an empty subtree (an absent draw of :class:`StepDraws`). Named tuples
    and list subclasses (:class:`TableSlabs`) keep their type."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return out if type(tree) in (list, tuple) else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _tree_unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _all_finite(tensors) -> torch.Tensor:
    """One verdict, on the first tensor's device, for tensors on any devices."""
    ok = torch.ones((), dtype=torch.bool, device=tensors[0].device)
    for t in tensors:
        ok = ok & torch.all(torch.isfinite(t)).to(ok.device)
    return ok


# ---------------------------------------------------------------------------
# Adam (optax.adam, with add_decayed_weights before it)
# ---------------------------------------------------------------------------

_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def adam_init(params) -> AdamState:
    leaf = tree_leaves(params)[0]
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=leaf.device),
        mu=tree_map(torch.zeros_like, params),
        nu=tree_map(torch.zeros_like, params),
    )


def adam_updates(grads, state: AdamState, params, lr: float, gamma: float = 1.0, weight_decay: float = 0.0):
    """(updates, new_state): optax ``chain(add_decayed_weights(wd),
    adam(lr * gamma**count))`` on one parameter group, each leaf on its own
    device (the count and its scalars live on the first leaf's)."""
    if weight_decay:
        grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
    mu = tree_map(lambda g, m: (1 - _B1) * g + _B1 * m, grads, state.mu)
    nu = tree_map(lambda g, v: (1 - _B2) * (g * g) + _B2 * v, grads, state.nu)
    count = torch.where(state.count < torch.iinfo(torch.int32).max, state.count + 1, state.count)
    c = count.to(torch.float32)
    bc1 = 1 - _B1**c
    bc2 = 1 - _B2**c
    step = lr if gamma == 1.0 else lr * gamma ** state.count.to(torch.float32)

    def update(m, v):
        d = m.device
        s = step if gamma == 1.0 else step.to(d)
        return (m / bc1.to(d)) / (torch.sqrt(v / bc2.to(d)) + _ADAM_EPS) * (-s)

    return tree_map(update, mu, nu), AdamState(count, mu, nu)


def _select(keep: torch.Tensor, old, new):
    """keep ? old : new, leaf by leaf (keep is a scalar bool tensor)."""
    return tree_map(lambda o, n: torch.where(keep.to(o.device), o, n), old, new)


def _masked_group(grads, state: AdamState, params, freeze: bool, finite: torch.Tensor, lr, gamma, wd):
    """One Adam group; frozen or non-finite leaves params, moments and count."""
    if freeze:
        return params, state
    updates, new_state = adam_updates(grads, state, params, lr, gamma, wd)
    new_params = tree_map(lambda p, u: p + u, params, updates)
    skip = ~finite
    return _select(skip, params, new_params), _select(skip, state, new_state)


# ---------------------------------------------------------------------------
# state, draws, rays
# ---------------------------------------------------------------------------


def init_mapper_state(generator: Optional[torch.Generator], cfg: MapperConfig, device="cuda") -> MapperState:
    """A fresh state on ``device`` with random field parameters from
    ``generator`` (one seeded with 0 on ``device`` when None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = init_nerf(generator, cfg.nerf, dev)
    poses = torch.zeros((cfg.max_keyframes, 6), dtype=torch.float32, device=dev)
    occ = init_occ_grid(cfg.occ, dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return MapperState(
        params=params,
        poses=poses,
        opt_sigma=adam_init(params["sigma"]),
        opt_intensity=adam_init(params["intensity"]),
        opt_poses=adam_init(poses),
        occ_grid=occ,
        opt_occ=adam_init(occ),
        global_step=zero.clone(),
        skipped_steps=zero.clone(),
    )


_RAYS_STRATEGIES = ("RANDOM", "MASK", "FIXED")
_SAMPLES_STRATEGIES = ("OGM", "UNIFORM")


def draw_step(cfg: MapperConfig, window, generator: torch.Generator, device,
              perm: Optional[torch.Tensor] = None, u_occ: Optional[torch.Tensor] = None) -> StepDraws:
    """Draw one step's random numbers from ``generator`` on ``device``.
    Under FIXED the step slices ``perm`` (W, P), drawn here when None;
    ``u_occ``, when given, is used in place of a fresh draw."""
    w = window.window_size
    p = window.dirs.shape[1]
    s = window.sky_dirs.shape[1]
    n = cfg.rays_per_window
    half = cfg.n_samples_train // 2
    uniform = cfg.samples_strategy == "UNIFORM"

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    ray_idx = None
    if cfg.rays_strategy == "FIXED":
        if perm is None:
            perm = draw_permutation(window, generator, device)
    else:
        ray_idx = torch.randint(0, p, (w, cfg.rays_per_kf), generator=generator, device=device)
    return StepDraws(
        ray_idx=ray_idx,
        sky_idx=torch.randint(0, s, (w, cfg.sky_rays_per_kf), generator=generator, device=device),
        u_strat=rand(n, cfg.n_samples_train if uniform else half),
        u_pdf=None if uniform else rand(n, half),
        u_occ=draw_occ_uniforms(cfg, generator, device) if u_occ is None else u_occ,
        enc_key=torch.randint(0, 2**32, (2,), generator=generator, device=device),
        perm=perm,
        u_enc=draw_encoder_uniforms(cfg.nerf, cfg.nerf.pos_encoding_sigma.n_levels, n * cfg.n_samples_train,
                                    cfg.train_point_chunks, generator, device),
    )


def draw_encoder_uniforms(nerf: NeRFConfig, n_levels: int, n_points: int, point_chunks: int,
                          generator: torch.Generator, device) -> Optional[torch.Tensor]:
    """The "cell" encoder's corner uniforms (L, points per chunk) for a
    field pass over ``n_points`` in ``point_chunks`` chunks; None for the
    other encoders, which draw none."""
    if nerf.encoding_impl != "cell":
        return None
    return torch.rand((n_levels, chunk_points(n_points, point_chunks)), generator=generator, device=device)


def draw_occ_uniforms(cfg: MapperConfig, generator: torch.Generator, device) -> torch.Tensor:
    """(N, S) uniforms of the occupancy update's corner draws."""
    return torch.rand((cfg.rays_per_window, cfg.n_samples_train), generator=generator, device=device)


def draw_permutation(window, generator: torch.Generator, device) -> torch.Tensor:
    """(W, P) int64: a random permutation of each keyframe's P points."""
    w, p = window.dirs.shape[:2]
    return torch.argsort(torch.rand((w, p), generator=generator, device=device), dim=1)


def fixed_ray_idx(perm: torch.Tensor, iteration: int, rays_per_kf: int) -> torch.Tensor:
    """FIXED's lidar indices at ``iteration``: rays_per_kf consecutive
    entries of each keyframe's permutation (W, P) from (iteration *
    rays_per_kf) mod P on, wrapping; P // rays_per_kf iterations visit every
    point once."""
    p = perm.shape[1]
    start = (int(iteration) * rays_per_kf) % p
    cols = (start + torch.arange(rays_per_kf, device=perm.device)) % p
    return perm[:, cols]


def build_window_rays(poses: torch.Tensor, window, cube, cfg: MapperConfig, ray_idx: torch.Tensor, sky_idx: torch.Tensor) -> RayBundle:
    """rays_per_kf lidar + sky_rays_per_kf sky rays from every keyframe of
    the window, as one flat bundle of W * (R + Rs) rays, keyframe-major with
    each keyframe's lidar rays before its sky rays. Gradients flow to
    ``poses`` through the lidar rays; sky rays use the detached pose. Under
    MASK the first ``int(R * mask_band_fraction)`` of each keyframe's
    ``ray_idx`` index its trunk band (``window.band_idx``), the rest its
    scan."""
    if cfg.rays_strategy not in _RAYS_STRATEGIES:
        raise ValueError(f"rays_strategy={cfg.rays_strategy!r}: one of {_RAYS_STRATEGIES}")
    if cfg.rays_strategy == "MASK":
        n_band = int(cfg.rays_per_kf * cfg.mask_band_fraction)
        ray_idx = torch.cat([torch.gather(window.band_idx, 1, ray_idx[:, :n_band]), ray_idx[:, n_band:]], dim=1)
    sky_range = cfg.ray_range[1] + 1.0
    T = se3.pose_to_matrix(poses[window.pose_idx])  # (W, 4, 4)

    def take(a, idx):
        if a.dim() == 3:
            return torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))
        return torch.gather(a, 1, idx)

    lidar = build_lidar_rays(
        take(window.dirs, ray_idx), take(window.dists, ray_idx), T, cube, cfg.ray_range,
        point_valid=take(window.point_valid, ray_idx),
    )
    sky_dirs = take(window.sky_dirs, sky_idx)
    sky = build_lidar_rays(
        sky_dirs, torch.full(sky_dirs.shape[:-1], sky_range, dtype=sky_dirs.dtype, device=sky_dirs.device),
        T.detach(), cube, cfg.ray_range, point_valid=take(window.sky_valid, sky_idx),
    )
    return RayBundle(*(
        torch.cat([a, b], dim=1).reshape((-1,) + tuple(a.shape[2:])) for a, b in zip(lidar, sky)
    ))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _place(tree, row):
    """``tree`` on the data row ``row`` (its devices): slab m of a
    :class:`TableSlabs` on ``row[m]`` (all on ``row[0]`` for a row of one
    device), every other leaf on ``row[0]``. The copies are differentiable;
    a leaf already there is itself."""
    if isinstance(tree, TableSlabs):
        return TableSlabs(t.to(row[m] if len(row) > 1 else row[0]) for m, t in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _place(v, row) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_place(t, row) for t in tree]
    return tree.to(row[0])


def split_window(window, devices) -> list:
    """The window's keyframe axis in ``len(devices)`` contiguous blocks, one
    per device: ``[(k0, k1, block on its device)]``. The device count must
    divide the window size."""
    w, n = window.window_size, len(devices)
    if w % n:
        raise ValueError(f"window_size={w} is not divisible by {n} devices")
    return [(i * w // n, (i + 1) * w // n, type(window)(*(t[i * w // n:(i + 1) * w // n].to(d) for t in window)))
            for i, d in enumerate(devices)]


def _slice(t: Optional[torch.Tensor], a: int, b: int, device) -> Optional[torch.Tensor]:
    return None if t is None else t[a:b].to(device)


def _shard_u_enc(u: Optional[torch.Tensor], p0: int, n_pts: int, n_total: int) -> Optional[torch.Tensor]:
    """A shard's "cell" corner uniforms: the whole window's block when the
    shard is the window, else one column per point of the shard's points
    [p0, p0 + n_pts), each the uniform of its place in the window's point
    chunks."""
    if u is None or (p0 == 0 and n_pts == n_total):
        return u
    return u[:, (p0 + torch.arange(n_pts, device=u.device)) % u.shape[-1]]


def _join(parts, device):
    """One bundle or render from the shards' (keyframe order), on
    ``device``: each per-ray field concatenated on the ray axis; a render's
    points and raw outputs (channels leading) are left out."""
    if len(parts) == 1:
        return parts[0]
    skip = ("points", "raw") if isinstance(parts[0], RenderResult) else ()
    return type(parts[0])(*(
        None if name in skip else torch.cat([getattr(p, name).to(device) for p in parts])
        for name in parts[0]._fields
    ))


def make_train_step(cfg: MapperConfig, cube, device="cuda", generator: Optional[torch.Generator] = None,
                    apply_updates: bool = True):
    """The train step ``train_step(state, window, flags, pose_mask,
    iteration, draws=None) -> (new_state, aux)`` on ``device``.

    ``aux`` holds the loss, its terms, ``finite`` and the gradients
    (``grads["sigma"]``, ``grads["intensity"]``, ``grads["poses"]``).
    Without ``draws`` the step draws from ``generator`` (one seeded with 0
    on ``device`` when None), kept as ``train_step.generator``. With
    ``apply_updates=False`` the new state is the old one with only
    ``global_step`` and ``skipped_steps`` advanced, as the JAX package's."""
    return make_mesh_train_step(cfg, cube, [(resolve_device(device),)], generator, apply_updates)


def make_mesh_train_step(cfg: MapperConfig, cube, rows, generator: Optional[torch.Generator] = None,
                         apply_updates: bool = True):
    """The train step over data rows of devices: ``rows[i]`` lists data row
    i's devices, its compute device first; with hash-table slabs
    (:class:`TableSlabs`) in the state, ``rows[i][m]`` holds slab m. The
    state lives on ``rows[0]`` (its slabs on ``rows[0][m]``, the rest on
    ``rows[0][0]``). A window of W keyframes splits into ``len(rows)``
    contiguous blocks when that divides W, else runs whole on the first
    row. Each row builds its block's rays, samples and renders on its
    compute device; the loss runs once, on the first device, over the rows'
    per-ray outputs in keyframe order, and the gradients of every row's
    copy of a parameter arrive summed at the parameter; with several rows a
    bf16 MLP's weights round to bf16 on the first device before the copies,
    so that their gradient rounds once, after the sum (as the JAX package's
    sharded step rounds it). The draws (one set for the whole window, drawn
    on the first device) go to each row as its slice."""
    rows = [tuple(torch.device(d) for d in r) for r in rows]
    dev = rows[0][0]
    if cfg.samples_strategy not in _SAMPLES_STRATEGIES:
        raise ValueError(f"samples_strategy={cfg.samples_strategy!r}: one of {_SAMPLES_STRATEGIES}")
    cubes = {r[0]: cube.to(r[0]) for r in rows}
    # f32 products stay f32 (the JAX package's precision), never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    scale = cfg.world_scale
    per_kf = cfg.rays_per_kf + cfg.sky_rays_per_kf
    n_samples = cfg.n_samples_train
    # the strided table gradient's slot period is the samples per ray
    # (points arrive flattened (rays, S))
    cfg = cfg._replace(nerf=cfg.nerf._replace(encoding_slot_period=n_samples))

    def render_shard(params, poses, occ_grid, window, draws: StepDraws, ray_idx, cube_d):
        bundle = build_window_rays(poses, window, cube_d, cfg, ray_idx, draws.sky_idx)
        if cfg.samples_strategy == "OGM":
            z_vals = sampling.occ_grid_sampler_z_vals(bundle, occ_grid, n_samples, cfg.perturb, draws.u_strat,
                                                      draws.u_pdf)
        else:
            z_vals = sampling.uniform_sampler_z_vals(bundle, n_samples, cfg.perturb, draws.u_strat)
        render = render_rays(params, bundle, z_vals, cfg.nerf, draws.enc_key, point_chunks=cfg.train_point_chunks,
                             enc_u=draws.u_enc)
        return render, bundle

    def forward(params, poses, occ_grid, window, draws, iteration, global_step):
        """(loss, aux, each row's (render, bundle, draws))."""
        ray_idx = (fixed_ray_idx(draws.perm, iteration, cfg.rays_per_kf) if cfg.rays_strategy == "FIXED"
                   else draws.ray_idx)
        w = window.window_size
        devs = [r[0] for r in rows] if w % len(rows) == 0 else [dev]
        sigma = params["sigma"]
        if len(devs) > 1:  # a bf16 MLP's weight gradient rounds once, after the rows' sum
            sigma = {**sigma, "mlp": round_weights(sigma["mlp"], cfg.nerf.sigma_mlp_config())}
        shards = []
        for row, (k0, k1, d_window) in zip(rows, split_window(window, devs)):
            d = row[0]
            r0, r1 = k0 * per_kf, k1 * per_kf
            d_draws = StepDraws(
                ray_idx=None, sky_idx=_slice(draws.sky_idx, k0, k1, d), u_strat=_slice(draws.u_strat, r0, r1, d),
                u_pdf=_slice(draws.u_pdf, r0, r1, d), u_occ=_slice(draws.u_occ, r0, r1, d),
                enc_key=draws.enc_key.to(d),
                u_enc=_slice(_shard_u_enc(draws.u_enc, r0 * n_samples, (r1 - r0) * n_samples, w * per_kf * n_samples),
                             0, None, d),
            )
            render, bundle = render_shard({"sigma": _place(sigma, row)}, poses.to(d), occ_grid.to(d),
                                          d_window, d_draws, _slice(ray_idx, k0, k1, d), cubes[d])
            shards.append((render, bundle, d_draws))
        render = _join([s[0] for s in shards], dev)
        bundle = _join([s[1] for s in shards], dev)
        loss, aux = compute_lidar_loss(render, bundle, scale, cfg.loss, global_step, iteration)
        return loss, aux, shards

    def occ_cotangent(occ_grid, shards):
        """The occupancy gradient of every row's samples, each row's on its
        device, summed on the first device in row order."""
        g_occ = None
        for render, bundle, draws in shards:
            g = occ_grid_cotangent(
                occ_grid.to(render.z_vals.device),
                render.points.detach(),
                render.z_vals.detach() * scale,
                (bundle.depth * scale)[:, None],
                bundle.valid,
                u=draws.u_occ,
                estimator=cfg.occ.estimator,
            ).to(dev)
            g_occ = g if g_occ is None else g_occ + g
        return g_occ

    def train_step(state: MapperState, window, flags: TrainStepFlags, pose_mask: torch.Tensor,
                   iteration, draws: Optional[StepDraws] = None):
        if draws is None:
            draws = draw_step(cfg, window, generator, state.poses.device)
        pose_grads = not flags.freeze_poses
        sigma_leaves = [t.detach().requires_grad_(True) for t in tree_leaves(state.params["sigma"])]
        params = {"sigma": _tree_unflatten(state.params["sigma"], sigma_leaves), "intensity": state.params["intensity"]}
        poses = state.poses.detach().requires_grad_(pose_grads)
        with torch.enable_grad():
            loss, aux, shards = forward(
                params, poses, state.occ_grid, window, draws, iteration, state.global_step.to(torch.float32),
            )
            wrt = sigma_leaves + ([poses] if pose_grads else [])
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, grads)]
        g_sigma = _tree_unflatten(state.params["sigma"], grads[: len(sigma_leaves)])
        g_intensity = tree_map(torch.zeros_like, state.params["intensity"])
        g_poses = grads[-1] if pose_grads else torch.zeros_like(state.poses)
        loss = loss.detach()
        finite = torch.isfinite(loss) & _all_finite(grads)
        aux = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in aux.items()}
        aux["loss"] = loss
        aux["finite"] = finite
        aux["grads"] = {"sigma": g_sigma, "intensity": g_intensity, "poses": g_poses}
        not_finite = (~finite).to(torch.int32)
        if not apply_updates:
            return state._replace(global_step=state.global_step + 1,
                                  skipped_steps=state.skipped_steps + not_finite), aux

        with torch.no_grad():
            new_sigma, opt_sigma = _masked_group(
                g_sigma, state.opt_sigma, state.params["sigma"], flags.freeze_sigma, finite,
                cfg.lr_sigma, cfg.lr_gamma, cfg.sigma_weight_decay,
            )
            new_intensity, opt_intensity = _masked_group(
                g_intensity, state.opt_intensity, state.params["intensity"], flags.freeze_rgb, finite,
                cfg.lr_rgb, cfg.lr_gamma, cfg.rgb_weight_decay,
            )
            if pose_grads:
                # the mask applies after Adam: every row's moments advance
                upd, opt_poses_new = adam_updates(g_poses, state.opt_poses, state.poses, cfg.lr_pose, cfg.pose_lr_gamma)
                new_poses = state.poses + upd * pose_mask[:, None]
                skip = ~finite
                new_poses = torch.where(skip, state.poses, new_poses)
                opt_poses = _select(skip, state.opt_poses, opt_poses_new)
            else:
                new_poses, opt_poses = state.poses, state.opt_poses

            occ_grid, opt_occ = state.occ_grid, state.opt_occ
            if flags.do_occ_update:
                upd, opt_occ_new = adam_updates(occ_cotangent(state.occ_grid, shards), state.opt_occ, state.occ_grid,
                                                cfg.occ.lr)
                skip = ~finite
                occ_grid = torch.where(skip, state.occ_grid, state.occ_grid + upd)
                opt_occ = _select(skip, state.opt_occ, opt_occ_new)

            new_state = MapperState(
                params={"sigma": new_sigma, "intensity": new_intensity},
                poses=new_poses,
                opt_sigma=opt_sigma,
                opt_intensity=opt_intensity,
                opt_poses=opt_poses,
                occ_grid=occ_grid,
                opt_occ=opt_occ,
                global_step=state.global_step + 1,
                skipped_steps=state.skipped_steps + not_finite,
            )
        return new_state, aux

    train_step.generator = generator
    return train_step


def make_render_fn(cfg: MapperConfig, test: bool = True, sigma_only: bool = True,
                   render_strategy: str = "default", device="cuda"):
    """The evaluation render ``render_fn(params, occ_grid, bundle, u_pdf=None,
    generator=None) -> RenderResult`` on ``device``, without gradients:
    ``n_samples_test`` samples per ray (``n_samples_train`` when not
    ``test``), no stratified jitter, OGM or UNIFORM as the config says, the
    field in ``cfg.nerf.point_chunks`` chunks, composited by
    ``render_strategy`` ("default" or "adjusted"), and the intensity
    branch's colours too unless ``sigma_only``. OGM's importance half still draws its
    inverse-CDF uniforms, as the JAX package's render does: ``u_pdf``
    (N, S/2), else drawn from ``generator``."""
    if cfg.samples_strategy not in _SAMPLES_STRATEGIES:
        raise ValueError(f"samples_strategy={cfg.samples_strategy!r}: one of {_SAMPLES_STRATEGIES}")
    dev = resolve_device(device)
    n_samples = cfg.n_samples_test if test else cfg.n_samples_train

    @torch.no_grad()
    def render_fn(params, occ_grid, bundle: RayBundle, u_pdf: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
        if cfg.samples_strategy == "OGM":
            if u_pdf is None:
                u_pdf = torch.rand((bundle.near.shape[0], n_samples // 2), generator=generator, device=dev)
            z_vals = sampling.occ_grid_sampler_z_vals(bundle, occ_grid, n_samples, 0.0, None, u_pdf)
        else:
            z_vals = sampling.uniform_sampler_z_vals(bundle, n_samples, 0.0)
        return render_rays(params, bundle, z_vals, cfg.nerf, sigma_only=sigma_only, render_strategy=render_strategy)

    return render_fn


def make_debug_probe(cfg: MapperConfig, cube, device="cuda"):
    """The debug probe ``probe(state, window, draws, iteration=0) -> dict``
    on ``device``: the train step's ray build, sampler and sigma render from
    ``draws`` (a :class:`StepDraws`, as the step takes), without gradients,
    and the lidar loss's per-ray terms. Returns cube-frame tensors:
    ``origins`` and ``endpoints`` (N, 3), ``points`` (N, S, 3),
    ``weights`` (N, S), ``valid`` (N,) and the per-ray ``depth_err``
    (metric), ``js`` and ``los``; ``runtime/debug_dump.py`` maps them to
    the metric world."""
    dev = resolve_device(device)
    cube = cube.to(dev)
    cfg = cfg._replace(nerf=cfg.nerf._replace(encoding_slot_period=cfg.n_samples_train))

    @torch.no_grad()
    def probe(state: MapperState, window, draws: StepDraws, iteration: int = 0) -> dict:
        ray_idx = (fixed_ray_idx(draws.perm, iteration, cfg.rays_per_kf) if cfg.rays_strategy == "FIXED"
                   else draws.ray_idx)
        bundle = build_window_rays(state.poses, window, cube, cfg, ray_idx, draws.sky_idx)
        if cfg.samples_strategy == "OGM":
            z_vals = sampling.occ_grid_sampler_z_vals(
                bundle, state.occ_grid, cfg.n_samples_train, cfg.perturb, draws.u_strat, draws.u_pdf
            )
        else:
            z_vals = sampling.uniform_sampler_z_vals(bundle, cfg.n_samples_train, cfg.perturb, draws.u_strat)
        render = render_rays(state.params, bundle, z_vals, cfg.nerf, draws.enc_key,
                             point_chunks=cfg.train_point_chunks)
        _, aux = compute_lidar_loss(render, bundle, cfg.world_scale, cfg.loss, state.global_step.to(torch.float32),
                                    iteration, return_per_ray=True)
        per_ray = aux["per_ray"]
        return {
            "origins": bundle.origins,
            "endpoints": bundle.origins + bundle.directions * render.depth[:, None],
            "points": bundle.origins[:, None, :] + bundle.directions[:, None, :] * z_vals[..., None],
            "weights": render.weights,
            "valid": bundle.valid,
            "depth_err": per_ray["depth_err_m"],
            "js": per_ray["js"],
            "los": per_ray["los"],
        }

    return probe
