"""Chained timings of the field's memory primitives and of the mapper's
parts: the port of ``scripts/bench_honest.py`` (P3).

Every leg runs K dependent iterations that end in one scalar, once to warm
up and once timed, and reports ms per iteration:

* ``gather``: the row gather ``table[idx]`` at N/8 and N points;
* ``lane``: the lane gather kernel ``lane_gather`` on an (N/128, 128) table
  (the script's Pallas leg), held against the same chain with the plain
  ``torch.gather``;
* ``scatter``: ``index_add_`` of N/32, N/8 and N rows of 16 f32;
* ``fwd``: the sigma field (``query_sigma_t``: the CP forward B1, Fourier
  features and MLP) at N points;
* ``fieldbwd``: its gradient against the sigma parameters (B1 and B2);
* ``sampler``: the occupancy-grid sampler (``occ_grid_sampler_z_vals``, B3)
  on the flagship's rays;
* ``step``: the mapper's train step (pose-frozen, sigma only), B1-B3.

The field legs use the flagship mapper (``flagship``), whose scan and ray
sizes are arguments so that a test can build it small.

    python -m loner_tpu_torch.probes.bench_honest [--device cuda] [--only gather,lane,...]
"""
from __future__ import annotations

import argparse

import torch

from loner_tpu_torch.device import resolve_device
from loner_tpu_torch.flagship import flagship
from loner_tpu_torch.mapping import optimizer as opt
from loner_tpu_torch.models.nerf import query_sigma_t
from loner_tpu_torch.ops import cp_kernel, pdf_kernel
from loner_tpu_torch.ops import gather_scatter as gs
from loner_tpu_torch.probes.timing import chained_ms, counts, device_name, launches, record

SEED = 0  # the seed of every input
K = 8
N = 2_359_296
T = 65536  # a power of two: indices wrap with & (T - 1)
LANES = 128
LEGS = ("gather", "lane", "scatter", "fwd", "fieldbwd", "sampler", "step")
WRAPPERS = (gs.lane_gather, cp_kernel.cp_fwd, cp_kernel.cp_bwd, pdf_kernel.pdf_sample)


def _scalar_chain_ms(chain, dev):
    """(ms per iteration, the timed run's scalar as a float): the scalar is
    fetched to the host, as the script does."""
    ms, v = chained_ms(chain, dev, K)
    return ms, float(v)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", default="", help=f"comma-separated legs of {','.join(LEGS)}")
    ap.add_argument("--n", type=int, default=N, help="points (a multiple of 128)")
    ap.add_argument("--t", type=int, default=T, help="table rows (a power of two)")
    ap.add_argument("--keyframes", type=int, default=8)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--azimuth", type=int, default=512)
    ap.add_argument("--pad-to", type=int, default=16384)
    ap.add_argument("--sky", type=int, default=1024)
    ap.add_argument("--rays-per-kf", type=int, default=512)
    ap.add_argument("--sky-rays-per-kf", type=int, default=64)
    ap.add_argument("--samples", type=int, default=512)
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else set(LEGS)
    unknown = only - set(LEGS)
    if unknown:
        raise ValueError(f"--only: unknown legs {sorted(unknown)}; choose from {LEGS}")
    n, t = args.n, args.t
    dev = resolve_device(args.device)
    before = counts(WRAPPERS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    print(f"{device_name(dev)}: N={n} T={t} K={K}; legs {sorted(only)}")
    legs = {}

    if "gather" in only:
        for m in (n // 8, n):
            table = torch.randn((t, 8), generator=gen, device=dev)
            idx0 = torch.randint(0, t, (m,), generator=gen, device=dev)

            def chain():
                idx, acc = idx0, torch.zeros((), device=dev)
                for _ in range(K):
                    acc = acc + table[idx].sum()
                    idx = (idx + acc.to(torch.int64)) & (t - 1)
                return acc

            ms, v = _scalar_chain_ms(chain, dev)
            record(legs, f"gather {m} x (T,8) f32", ms_per_iter=ms, value=v)

    if "lane" in only:
        rows = n // LANES
        tabl = torch.randn((rows, LANES), generator=gen, device=dev)
        li0 = torch.randint(0, LANES, (rows, LANES), generator=gen, device=dev, dtype=torch.int32)

        def lane_chain(gather):
            def chain():
                idx, acc = li0, torch.zeros((), device=dev)
                for _ in range(K):
                    acc = acc + gather(tabl, idx).sum()
                    idx = (idx + acc.to(torch.int32)) & (LANES - 1)
                return acc
            return chain

        ms, v = _scalar_chain_ms(lane_chain(gs.lane_gather), dev)
        ref = float(lane_chain(gs.lane_gather_ref)())
        record(legs, f"lane_gather {n / 1e6:.2f}M elems", ms_per_iter=ms, value=v, abs_err=abs(v - ref))

    if "scatter" in only:
        for m in (n // 32, n // 8, n):
            idx0 = torch.randint(0, t, (m,), generator=gen, device=dev)
            upd = torch.randn((m, 16), generator=gen, device=dev)

            def chain():
                idx, acc = idx0, torch.zeros((), device=dev)
                for _ in range(K):
                    acc = acc + torch.zeros((t, 16), device=dev).index_add_(0, idx, upd).sum()
                    idx = (idx + acc.to(torch.int64)) & (t - 1)
                return acc

            ms, v = _scalar_chain_ms(chain, dev)
            record(legs, f"scatter index_add_ {m} x (T,16) f32", ms_per_iter=ms, value=v)

    if only & {"fwd", "fieldbwd", "sampler", "step"}:
        mcfg = opt.MapperConfig(window_size=args.keyframes, rays_per_kf=args.rays_per_kf,
                                sky_rays_per_kf=args.sky_rays_per_kf, n_samples_train=args.samples)
        cfg, cube, state, window = flagship(
            device=dev, seed=SEED, cfg=mcfg, n_keyframes=args.keyframes, n_channels=args.channels,
            n_azimuth=args.azimuth, pad_to=args.pad_to, n_sky=args.sky)
        nerf_cfg = cfg.nerf._replace(encoding_slot_period=cfg.n_samples_train)
        pts0 = torch.rand((3, n), generator=gen, device=dev) * 2.0 - 1.0

    if "fwd" in only:
        def chain():
            pts, acc = pts0, torch.zeros((), device=dev)
            with torch.no_grad():
                for _ in range(K):
                    acc = acc + query_sigma_t(state.params, pts, nerf_cfg).sum()
                    pts = torch.clamp(pts + acc * 1e-30, -1.0, 1.0)
            return acc

        ms, v = _scalar_chain_ms(chain, dev)
        record(legs, f"field fwd (enc+mlp) {n / 1e6:.2f}M", ms_per_iter=ms, value=v)

    if "fieldbwd" in only:
        def chain():
            p, acc = state.params["sigma"], torch.zeros((), device=dev)
            for _ in range(K):
                leaves = [x.detach().requires_grad_(True) for x in opt.tree_leaves(p)]
                it = iter(leaves)
                params = {"sigma": opt.tree_map(lambda _: next(it), p)}
                with torch.enable_grad():
                    g = torch.autograd.grad(query_sigma_t(params, pts0, nerf_cfg).sum(), leaves)
                acc = acc + g[0].sum()
                it = iter(g)
                p = opt.tree_map(lambda a: a.detach() - 1e-12 * next(it), params["sigma"])
            return acc

        ms, v = _scalar_chain_ms(chain, dev)
        record(legs, f"field fwd+bwd (params) {n / 1e6:.2f}M", ms_per_iter=ms, value=v)

    if "sampler" in only:
        draws = opt.draw_step(cfg, window, gen, dev)
        with torch.no_grad():
            bundle = opt.build_window_rays(state.poses, window, cube.to(dev), cfg, draws.ray_idx, draws.sky_idx)

        def chain():
            acc = torch.zeros((), device=dev)
            for _ in range(K):
                d = opt.draw_step(cfg, window, gen, dev)
                z = opt.sampling.occ_grid_sampler_z_vals(bundle, state.occ_grid, cfg.n_samples_train, cfg.perturb,
                                                         d.u_strat, d.u_pdf)
                acc = acc + z.sum()
            return acc

        ms, v = _scalar_chain_ms(chain, dev)
        record(legs, "occ sampler", ms_per_iter=ms, value=v)

    if "step" in only:
        step = opt.make_train_step(cfg, cube, device=dev, generator=gen)
        flags = opt.TrainStepFlags(freeze_sigma=False, freeze_rgb=True, freeze_poses=True, do_occ_update=False)
        pose_mask = torch.zeros(cfg.max_keyframes, device=dev)

        def chain():
            st = state
            for i in range(K):
                st, aux = step(st, window, flags, pose_mask, i)
            return aux["loss"]

        ms, v = _scalar_chain_ms(chain, dev)
        record(legs, "full train step", ms_per_iter=ms, value=v)

    return {"device": device_name(dev), "legs": legs, "launches": launches(WRAPPERS, before)}


if __name__ == "__main__":
    main()
