"""The mapper's first steps, in plain PyTorch, from the run's inputs.

``follow_online`` starts from the weights the seed makes, an empty
occupancy grid and the keyframes' tracked poses, and takes the online
mapper's first steps as the benchmark schedules them: the first keyframe's
pose-frozen burn-in over a window of that keyframe repeated, then, once the
keyframes that take no steps have come, the joint steps of the keyframe
that fills the window, over the window LONER's HYBRID selection draws from
all of them, every pose but the anchor's updated; the occupancy grid is
updated every ``occ_every``-th step. ``follow_offline`` takes the offline
loop's first steps over its first window, poses frozen. Each step draws what the benchmark's draws give for
its index. Adam is optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8), the pose
update masked after Adam to the keyframes that are not anchored; a step with
a non-finite loss or gradient leaves its group as it was.

It returns :class:`Readings`: the loss of each compared step, each
parameter leaf's first gradient (sigma leaves at the first step, the poses
at the first joint step, the grid at its first update), each leaf's change
(sigma leaves after three steps, the grid at its first update, the poses
after three joint steps), the poses' first Adam moment after the three
joint steps and the pose rows those steps moved.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.draws import step_draws
from benchmark.reference import field as F
from benchmark.reference.geometry import matrix_to_pose, pose_to_matrix, window_rays
from benchmark.reference.render import lidar_loss, occupancy_gradient, ogm_z_vals, render

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass
class Readings:
    """What the check compares, from the program or the reference."""

    losses: Dict[int, float] = dc_field(default_factory=dict)  # step index -> loss
    grads: Dict[str, float] = dc_field(default_factory=dict)  # leaf -> norm of its first gradient
    changes: Dict[str, float] = dc_field(default_factory=dict)  # leaf -> norm of its change
    moments: Dict[str, float] = dc_field(default_factory=dict)  # leaf -> norm of Adam's first moment
    moved: Dict[str, List[int]] = dc_field(default_factory=dict)  # leaf -> the rows its change moved


def named_leaves(tree, prefix: str = "") -> List[tuple]:
    """(name, tensor) of a parameter tree of dicts and lists, in the port's
    leaf order (dict keys in order, list items in order)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in named_leaves(t, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def moved_rows(change: torch.Tensor) -> List[int]:
    """The rows of a change that are not all nought."""
    return torch.nonzero(change.detach().abs().amax(dim=1) > 0).flatten().tolist()


def _adam(g: torch.Tensor, p: torch.Tensor, st: dict, lr: float):
    mu = (1 - B1) * g + B1 * st["mu"]
    nu = (1 - B2) * (g * g) + B2 * st["nu"]
    count = st["count"] + 1
    c = torch.tensor(float(count), dtype=torch.float32, device=g.device)
    upd = (mu / (1 - B1**c)) / (torch.sqrt(nu / (1 - B2**c)) + ADAM_EPS) * (-lr)
    return upd, {"mu": mu, "nu": nu, "count": count}


def _adam_init(p: torch.Tensor) -> dict:
    return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p), "count": 0}


@dataclass
class OnlineInputs:
    """What the benchmark hands the program and the reference alike."""

    seed: int
    field: dict  # the configuration's field block
    train: dict  # the configuration's training block
    keyframes: List[dict]  # per keyframe: dirs, dists, valid, sky_dirs, sky_valid (host arrays), pose (4, 4)
    scale: float
    shift: np.ndarray  # (3,)
    ray_range: tuple
    device: str = "cuda"


def band_indices(scan: dict, z_range) -> np.ndarray:
    """MASK's trunk band of a scan: its valid points whose world height lies
    in ``z_range`` (all valid points where none does), tiled to the scan's
    length."""
    pose = np.asarray(scan["pose"])
    z = ((scan["dirs"] * scan["dists"][:, None]) @ pose[:3, :3].T + pose[:3, 3])[:, 2]
    valid = np.asarray(scan["valid"])
    idx = np.flatnonzero(valid & (z > z_range[0]) & (z < z_range[1]))
    if len(idx) == 0:
        idx = np.flatnonzero(valid)
    if len(idx) == 0:
        idx = np.zeros(1, np.int64)
    p = len(valid)
    return np.tile(idx, int(np.ceil(p / len(idx))))[:p].astype(np.int64)


def _window(kfs: List[dict], pose_idx: List[int], device) -> dict:
    def put(key):
        return torch.as_tensor(np.stack([kfs[i][key] for i in pose_idx])).to(device)

    out = {"dirs": put("dirs"), "dists": put("dists"), "valid": put("valid"), "sky_dirs": put("sky_dirs"),
           "sky_valid": put("sky_valid"), "pose_idx": torch.as_tensor(pose_idx, device=device)}
    if "band" in kfs[0]:
        out["band"] = put("band")
    return out


def hybrid_rows(n: int, w: int, recent: int, rng: random.Random) -> List[int]:
    """The window over keyframes 0..n-1 as LONER's HYBRID selection picks it:
    a random sample of the older ones and the ``recent`` latest, repeated to
    ``w`` rows. ``rng`` is the keyframe manager's generator, seeded with the
    run's seed; a sample is drawn only where the older ones are enough."""
    rows = list(range(n))
    latest = rows[-recent:]
    past = rows[:-recent] or rows
    need = w - len(latest)
    chosen = (rng.sample(past, need) if len(past) >= need else past) + latest
    while len(chosen) < w:
        chosen = chosen + chosen[:w - len(chosen)]
    return chosen[:w]


def follow_online(inp: OnlineInputs, lower: bool = False, max_keyframes: int = 512) -> Readings:
    """The mapper's burn-in on the first keyframe (a window of it repeated),
    then the keyframes up to the window's size, each pose rebased on the one
    before as ``OnlineMapper`` rebases a tracked pose, of which only the last
    takes steps: three joint steps over the window HYBRID draws from all of
    them. ``lower`` computes the field one precision down (the control)."""
    dev = torch.device(inp.device)
    burn, w = inp.train["burn_in_iterations"], inp.train["window_size"]
    rng = random.Random(inp.seed)
    windows = [hybrid_rows(n, w, inp.train["num_recent_frames"], rng) for n in range(1, w + 1)]
    tracked = [np.asarray(k["pose"]) for k in inp.keyframes[:w]]
    poses = torch.zeros((max_keyframes, 6), device=dev)
    poses[0] = matrix_to_pose(torch.as_tensor(tracked[0].astype(np.float32), device=dev))

    def rebase(i, p):
        if i != burn:
            return p
        p = p.clone()
        for k in range(1, w):
            last = pose_to_matrix(p[k - 1].cpu()).numpy()
            t = last @ (np.linalg.inv(tracked[k - 1]) @ tracked[k])
            p[k] = matrix_to_pose(torch.as_tensor(t.astype(np.float32), device=dev))
        return p

    return _follow(inp, burn + 3, lambda i: windows[-1] if i >= burn else windows[0], burn, poses, rebase,
                   lower, "stochastic")


def follow_offline(inp: OnlineInputs, rows: List[int], lower: bool = False, max_keyframes: int = 512) -> Readings:
    """The offline loop's first steps over its first window (the keyframes
    ``rows``), poses frozen at ground truth, through the grid's first update
    with the exact transpose."""
    dev = torch.device(inp.device)
    poses = torch.zeros((max_keyframes, 6), device=dev)
    gt = torch.as_tensor(np.stack([np.asarray(k["pose"]) for k in inp.keyframes]), dtype=torch.float32)
    poses[:len(inp.keyframes)] = matrix_to_pose(gt).to(dev)
    return _follow(inp, max(3, inp.train["occ_every"]), lambda i: rows, None, poses, lambda i, p: p, lower, "exact")


def _follow(inp: OnlineInputs, n_steps: int, rows_of, first_joint: Optional[int], poses: torch.Tensor, pose_hook,
            lower: bool, estimator: str) -> Readings:
    """``n_steps`` steps from the seed's weights and an empty grid: step i
    trains on the window of keyframes ``rows_of(i)``, with pose gradients
    from ``first_joint`` on (the window's rows updated, but the anchor's,
    row 0), and ``pose_hook(i, poses)`` sets the poses before it."""
    dev = torch.device(inp.device)
    tr, fld = inp.train, inp.field
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sigma = F.init_sigma(torch.Generator(device=dev).manual_seed(_weights_seed(inp.seed)), fld, dev)
    names = [n for n, _ in named_leaves(sigma)]
    leaves = [t for _, t in named_leaves(sigma)]
    opt = [_adam_init(t) for t in leaves]
    v = tr["occ_voxels"]
    occ = torch.zeros((v, v, v), device=dev)
    opt_occ = _adam_init(occ)
    opt_poses = _adam_init(poses)
    shift = torch.as_tensor(np.asarray(inp.shift, np.float32), device=dev)
    n_samples, w = tr["n_samples_train"], tr["window_size"]
    band = tr["mask_band_fraction"] if tr["rays_strategy"] == "MASK" else None
    read = Readings()
    joint_steps = set() if first_joint is None else {first_joint, first_joint + 1, first_joint + 2}
    compared = {0, 1, 2} | joint_steps
    init = [t.clone() for t in leaves]
    pose_start = None

    def unflatten(ts):
        it = iter(ts)

        def build(tree):
            if isinstance(tree, dict):
                return {k: build(x) for k, x in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [build(x) for x in tree]
            return next(it)

        return build(sigma)

    for i in range(n_steps):
        joint = first_joint is not None and i >= first_joint
        poses = pose_hook(i, poses)
        if i == first_joint:
            pose_start = poses.clone()
        window = _window(inp.keyframes, rows_of(i), dev)
        d = step_draws(inp.seed, i, w, window["dirs"].shape[1], window["sky_dirs"].shape[1], tr["rays_per_kf"],
                       tr["sky_rays_per_kf"], n_samples, dev)
        params = [t.detach().requires_grad_(True) for t in leaves]
        p6 = poses.detach().requires_grad_(joint)
        with torch.enable_grad():
            rays = window_rays(p6, window, d["ray_idx"], d["sky_idx"], inp.scale, shift, inp.ray_range, band)
            z = ogm_z_vals(rays, occ, n_samples, tr["perturb"], d["u_strat"], d["u_pdf"])
            r = render(unflatten(params), rays, z, fld, lower)
            loss = lidar_loss(r, rays, inp.scale, tr["loss"])
            wrt = params + ([p6] if joint else [])
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, grads)]
        finite = bool(torch.isfinite(loss.detach())) and all(bool(torch.all(torch.isfinite(g))) for g in grads)
        if i in compared:
            read.losses[i] = float(loss.detach())
        if i == 0:
            read.grads.update({f"sigma.{n}": norm(g) for n, g in zip(names, grads)})
        if finite:
            with torch.no_grad():
                new = []
                for k, (p, g) in enumerate(zip(leaves, grads)):
                    upd, opt[k] = _adam(g, p, opt[k], tr["lr_sigma"])
                    new.append(p + upd)
                leaves = new
                if joint:
                    upd, opt_poses = _adam(grads[-1], poses, opt_poses, tr["lr_pose"])
                    mask = torch.zeros((poses.shape[0],), device=dev)
                    mask[sorted(set(rows_of(i)) - {0})] = 1.0
                    poses = poses + upd * mask[:, None]
                if i % tr["occ_every"] == tr["occ_every"] - 1:
                    g_occ = occupancy_gradient(occ, r.points.detach(), r.z_vals.detach() * inp.scale,
                                               (rays.depth * inp.scale)[:, None], rays.valid, d["u_occ"],
                                               estimator=estimator)
                    upd, opt_occ = _adam(g_occ, occ, opt_occ, tr["occ_lr"])
                    occ_new = occ + upd
                    if i == tr["occ_every"] - 1:
                        read.grads["occ_grid"] = norm(g_occ)
                        read.changes["occ_grid"] = norm(occ_new - occ)
                    occ = occ_new
        if i == first_joint:
            read.grads["poses"] = norm(grads[-1])
        if i == 2:
            read.changes.update({f"sigma.{n}": norm(a - b) for n, a, b in zip(names, leaves, init)})
        if first_joint is not None and i == first_joint + 2:
            read.changes["poses"] = norm(poses - pose_start)
            read.moments["poses"] = norm(opt_poses["mu"])
            read.moved["poses"] = moved_rows(poses - pose_start)
    return read


def _weights_seed(seed: int) -> int:
    from benchmark.draws import WEIGHTS, sub_seed

    return sub_seed(seed, WEIGHTS)
