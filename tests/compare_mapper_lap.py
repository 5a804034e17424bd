"""Both packages' online mappers on the CPU over the quality experiment's lap
at 1.5 s keyframe spacing, started from the JAX package's TPU record's
tracking errors, step by step.

The lap of scripts/exp_quality_flagship.py: radius 5 m, 126 poses over
12.6 s, 32 x 512 returns, noise 0.01, scans padded to 16384; each package
writes it with its own generator. Only the frames that the full run makes
keyframes reach the mappers: its 5 Hz frame synthesis and TEMPORAL 1.5 s
gate keep 8 frames, at 0, 1.6, ..., 11.2 s (the processed frames are 0.2 s
apart, so 1.6 s is the first at or past 1.5 s). Each keyframe's tracked pose
is its ground truth with an error of the record's per-keyframe length
[0, .07, .17, .32, .41, .41, .32, .24] m (QUALITY_r05.json,
online.envelope_characterization): a horizontal translation in a direction
drawn with numpy from --seed, plus a yaw of length / 5 m rad of a drawn
sign. The mapper then rebases each new keyframe on the previous one's
refined pose, as in the full run.

The settings are those exp_quality_flagship.run_online builds
(cfg/defaults.yaml and its overrides: TEMPORAL 1.5 s, window 8, 1000
pose-frozen steps on the first keyframe then 50 joint steps a keyframe,
the TriadField, OGM, the stochastic occupancy update, and the cfg tier's
f32 MLP), with two cuts, both in the JSON: 128 lidar + 16 sky rays a
keyframe, and 256 samples a ray. Not 128: from the JAX mapper's initial
state the first Adam step at 128 samples turns the field transparent
everywhere (opacity loss 1.0 from step 2 on), where it stays, with no pose
gradient; at 256 and 512 samples it turns opaque and trains. The port's
mapper runs on the CPU from the JAX mapper's initial state
(``convert.state_from_jax``) on the JAX mapper's draws
(``torch_parity.replayed_jax_draws``).

Prints each step's loss on both sides and the largest difference of the
keyframe positions, the first step at which a position parts by more than
1e-3 m and the first at which the losses part by more than 1e-3
(relative), each keyframe's refined error against the ground truth on both
sides, each package's wall time, and one JSON line last (``--out`` adds the
per-step records).

    JAX_PLATFORMS=cpu python tests/compare_mapper_lap.py [--seed 0] [--out result.json]

``--restart-at K ...`` restarts the port from the JAX mapper's state at
those steps, and reports each restart's step (the same state and draws)
and the 20 after it. ``--ulp-control`` runs the port twice in place of
JAX, the second from sigma parameters one ulp up: how far f32 rounding
alone parts two runs. ``--port-only`` runs the port alone on its own draws
and initial state, without JAX, at the flagship width (512 + 64 rays, 512
samples) unless the cuts are given:

    python tests/compare_mapper_lap.py --port-only --device cuda [--out result.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)

# the TPU record's tracked and refined per-keyframe errors (m)
START_ERRORS_M = (0.0, 0.07, 0.17, 0.32, 0.41, 0.41, 0.32, 0.24)
TPU_REFINED_M = (0.0, 0.02, 0.02, 0.02, 0.11, 3.28, 6.04, 7.89)
LAP = dict(n_poses=126, radius=5.0, period=12.6, n_channels=32, n_azimuth=512, noise_std=0.01)
PAD_TO = 16384
PART_M, LOSS_PART = 1e-3, 1e-3  # where the keyframe positions (m) and the losses (relative) part


def cut_overrides(args) -> dict:
    """The settings' cuts: rays, samples, and the schedule when cut for a
    quick check."""
    opt = {"num_samples": {"lidar": args.rays, "sky": args.sky_rays},
           "model_config": {"model": {"render": {"N_samples_train": args.samples}}}}
    if args.first_iters is not None or args.iters is not None:
        phase = dict(freeze_sigma_mlp=False, freeze_rgb_mlp=True)
        opt["keyframe_schedule"] = [
            {"num_keyframes": 1, "iteration_schedule": [
                {"num_iterations": 1000 if args.first_iters is None else args.first_iters, "freeze_poses": True,
                 **phase}]},
            {"num_keyframes": -1, "iteration_schedule": [
                {"num_iterations": 50 if args.iters is None else args.iters, "freeze_poses": False, **phase}]}]
    return {"mapper": {"optimizer": opt}}


def build(pkg: str, seq: str, overrides: dict, device):
    """(settings, dataset, SlamConfig, a fresh OnlineMapper) of one package,
    its lap written under ``seq`` by its own generator."""
    from loner_tpu_torch.experiments.exp_quality_flagship import ONLINE_OVERRIDES, online_settings

    if pkg == "jax":
        from loner_tpu.config.build import build_slam_config
        from loner_tpu.config.settings import load_settings
        from loner_tpu.data.dataset import SequenceDataset, write_synthetic_dataset
        from loner_tpu.data.synthetic import Scene
        from loner_tpu.geometry.world_cube import compute_world_cube
        from loner_tpu.mapping.mapper import OnlineMapper

        settings = load_settings(os.path.join(REPO, "cfg", "defaults.yaml"), overrides=ONLINE_OVERRIDES)
        settings = settings.augment(overrides)
        kw = {}
    else:
        from loner_tpu_torch.config.build import build_slam_config
        from loner_tpu_torch.data.dataset import SequenceDataset, write_synthetic_dataset
        from loner_tpu_torch.data.synthetic import Scene
        from loner_tpu_torch.geometry.world_cube import compute_world_cube
        from loner_tpu_torch.mapping.mapper import OnlineMapper

        settings = online_settings(False, overrides)
        kw = {"device": device}
    write_synthetic_dataset(seq, scene=Scene.default(), **LAP)
    dataset = SequenceDataset(seq, pad_to=PAD_TO)
    cube = compute_world_cube(dataset.gt_poses, tuple(settings.data.ray_range))
    cfg = build_slam_config(settings, float(cube.scale_factor))
    return settings, dataset, cfg, lambda **extra: OnlineMapper(cfg.mapper, cube, **kw, **extra)


def keyframe_frames(dataset, cfg, n_keyframes: int):
    """(frame indices, timestamps, ground-truth poses rebased on the first
    scan) of the frames that the full run's frame synthesis and keyframe
    gate make keyframes, the first ``n_keyframes``."""
    from loner_tpu_torch.mapping.keyframe import KeyFrame
    from loner_tpu_torch.mapping.keyframe_manager import KeyFrameManager
    from loner_tpu_torch.tracking.frame_synthesis import FrameSynthesis

    synth, gate = FrameSynthesis(cfg.frame_synthesis), KeyFrameManager(cfg.mapper.keyframe_manager)
    idx, times = [], []
    for i in range(len(dataset)):
        _, t = dataset.load_scan(i)
        if synth.accepts(t) and gate.decide(t, np.eye(4)) == "NEW":
            gate.accept(KeyFrame(scan=None, timestamp=t, pose_index=len(idx), tracked_pose=np.eye(4)))
            idx.append(i)
            times.append(t)
    idx, times = idx[:n_keyframes], times[:n_keyframes]
    gt0_inv = np.linalg.inv(dataset.gt_pose_at(dataset.load_scan(0)[1]))
    return idx, times, np.stack([gt0_inv @ dataset.gt_pose_at(t) for t in times])


def tracked_poses(gt: np.ndarray, seed: int, lengths=START_ERRORS_M) -> np.ndarray:
    """Each ground-truth pose with an error of ``lengths``' length: a
    horizontal translation in a drawn direction and a yaw of length / 5 m
    rad of a drawn sign."""
    rng = np.random.default_rng(seed)
    out = []
    for T, length in zip(gt, lengths):
        a, sign = rng.uniform(0.0, 2 * np.pi), rng.choice((-1.0, 1.0))
        yaw = sign * length / 5.0
        rz = np.array([[np.cos(yaw), -np.sin(yaw), 0.0], [np.sin(yaw), np.cos(yaw), 0.0], [0.0, 0.0, 1.0]])
        P = np.array(T, np.float64)
        P[:3, :3] = rz @ T[:3, :3]
        P[:3, 3] = T[:3, 3] + length * np.array([np.cos(a), np.sin(a), 0.0])
        out.append(P)
    return np.stack(out)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def run_mapper(mapper, scans, times, tracked, gt, name: str, hook=None) -> dict:
    """Feed the keyframes to ``mapper``, recording each step's loss and the
    keyframe poses (6-vectors [t, w]) before and after it; ``hook(step,
    state)`` returns the state that step i starts from."""
    n = len(scans)
    rec = {"loss": [], "poses_in": [], "poses": [], "kf": []}
    current = [0]
    train_step = mapper._train_step

    def step(state, *args):
        if hook is not None:
            state = hook(len(rec["loss"]), state)
        rec["poses_in"].append(_np(state.poses)[:n].copy())
        state, aux = train_step(state, *args)
        rec["loss"].append(float(aux["loss"]))
        rec["poses"].append(_np(state.poses)[:n].copy())
        rec["kf"].append(current[0])
        return state, aux

    mapper._train_step = step
    t0 = time.perf_counter()
    for k, (scan, t, P, G) in enumerate(zip(scans, times, tracked, gt)):
        current[0] = k
        t_kf = time.perf_counter()
        assert mapper.process_frame(scan, t, P, gt_pose=G), f"{name}: frame at {t} s is no keyframe"
        print(f"[{name}] keyframe {k} at {t:.2f} s: {sum(1 for x in rec['kf'] if x == k)} steps in "
              f"{time.perf_counter() - t_kf:.1f} s, loss {rec['loss'][-1]:.6e}", flush=True)
    rec["seconds"] = time.perf_counter() - t0
    rec["skipped_steps"] = int(_np(mapper.state.skipped_steps))
    assert [k.timestamp for k in mapper.kf_manager.keyframes] == list(times), f"{name}: other keyframes"
    return {k: np.asarray(v) if isinstance(v, list) else v for k, v in rec.items()}


def pose_errors(pose6: np.ndarray, gt: np.ndarray):
    """(translation error m, rotation error deg) of each keyframe's pose
    row against its ground truth."""
    import torch

    from loner_tpu_torch.geometry import se3

    R = se3.pose_to_matrix(torch.as_tensor(pose6, dtype=torch.float64)).numpy()[:, :3, :3]
    trans = np.linalg.norm(pose6[:, :3] - gt[:, :3, 3], axis=1)
    cos = (np.einsum("kij,kij->k", R, gt[:, :3, :3]) - 1.0) / 2.0
    return trans, np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def window_starts(kf: np.ndarray) -> list:
    """The first step of each keyframe's window."""
    return [int(np.flatnonzero(kf == k)[0]) for k in range(int(kf.max()) + 1)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0, help="the error directions and yaw signs")
    ap.add_argument("--port-only", action="store_true", help="the port alone, on its own draws, no JAX")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--rays", type=int, default=None, help="lidar rays a keyframe (128; port-only 512)")
    ap.add_argument("--sky-rays", type=int, default=None, help="sky rays a keyframe (16; port-only 64)")
    ap.add_argument("--samples", type=int, default=None, help="samples a ray (256; port-only 512)")
    ap.add_argument("--keyframes", type=int, default=8, help="a quick check: fewer keyframes")
    ap.add_argument("--first-iters", type=int, default=None, help="a quick check: the first keyframe's steps")
    ap.add_argument("--iters", type=int, default=None, help="a quick check: each later keyframe's steps")
    ap.add_argument("--restart-at", type=int, nargs="*", default=[],
                    help="steps at which the port restarts from the JAX mapper's state (a bisection)")
    ap.add_argument("--ulp-control", action="store_true",
                    help="in place of JAX, the port again from its initial state with every sigma "
                         "parameter moved one ulp: how fast f32 rounding alone parts two runs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    wide = args.port_only
    args.rays = args.rays or (512 if wide else 128)
    args.sky_rays = args.sky_rays or (64 if wide else 16)
    args.samples = args.samples or (512 if wide else 256)

    import torch

    from loner_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    overrides = cut_overrides(args)
    cuts = {"rays_per_kf": args.rays, "sky_rays_per_kf": args.sky_rays, "n_samples_train": args.samples,
            "keyframes": args.keyframes, "first_iters": args.first_iters, "iters": args.iters}
    mode = "port-only" if wide else "ulp-control" if args.ulp_control else "compare"
    res = {"mode": mode, "device": str(dev), "seed": args.seed, "cuts": cuts}
    if dev.type == "cuda":
        res["card"] = torch.cuda.get_device_name(dev)
    with tempfile.TemporaryDirectory() as tmp:
        settings, dataset, tcfg, make_port = build("torch", os.path.join(tmp, "port_lap"), overrides, dev)
        idx, times, gt = keyframe_frames(dataset, tcfg, args.keyframes)
        tracked = tracked_poses(gt, args.seed)
        tscans = [dataset.load_scan(i)[0] for i in idx]
        mcfg = tcfg.mapper.mapper
        res.update(keyframe_times_s=times, keyframe_frames=idx, start_errors_m=list(START_ERRORS_M[:len(idx)]),
                   tpu_record_refined_m=list(TPU_REFINED_M[:len(idx)]), compute_dtype=mcfg.nerf.compute_dtype,
                   window_size=mcfg.window_size, schedule=[[p.num_iterations for p in s.iteration_schedule]
                                                           for s in tcfg.mapper.schedule])
        print(f"keyframes at {[round(t, 3) for t in times]} s (frames {idx}); MLP {mcfg.nerf.compute_dtype}; "
              f"{args.rays} + {args.sky_rays} rays x {args.samples} samples; device {dev}", flush=True)
        runs = {}
        if not wide:
            import jax

            jax.config.update("jax_platforms", "cpu")
            import torch_parity as tp
            from loner_tpu_torch.convert import state_from_jax

            jsettings, jdataset, jcfg, make_jax = build("jax", os.path.join(tmp, "jax_lap"), overrides, None)
            assert jsettings.to_dict() == settings.to_dict(), "the packages built other settings"
            jidx, jtimes, jgt = keyframe_frames(jdataset, tcfg, args.keyframes)
            assert jidx == idx and np.allclose(jtimes, times) and np.allclose(jgt, gt, atol=1e-9)
            jscans = [jdataset.load_scan(i)[0] for i in idx]
            res["scan_max_diff"] = {
                "directions": max(float(np.abs(np.asarray(a.ray_directions) - np.asarray(b.ray_directions)).max())
                                  for a, b in zip(jscans, tscans)),
                "distances_m": max(float(np.abs(np.asarray(a.distances) - np.asarray(b.distances)).max())
                                   for a, b in zip(jscans, tscans)),
                "valid_equal": all(np.array_equal(np.asarray(a.valid), np.asarray(b.valid)) for a, b in zip(jscans, tscans))}
            jm = make_jax()
            initial = tp.np_tree(jm.state)
            saved = {}

            def save(i, state):  # a copy: the JAX step donates its input
                if i in args.restart_at:
                    saved[i] = jax.tree.map(np.array, state)
                return state

            def restart(i, state):
                return state_from_jax(saved[i], device=dev) if i in saved else state

            def port_run(name, state, hook=None):
                draws, draw_s = tp.replayed_jax_draws(jcfg.mapper.mapper, jcfg.mapper.seed), [0.0]

                def timed_draws(window):
                    t0 = time.perf_counter()
                    out = draws(window)
                    draw_s[0] += time.perf_counter() - t0
                    return out

                tm = make_port(step_draws=timed_draws)
                tm.state = state
                runs[name] = run_mapper(tm, tscans, times, tracked, gt, name, hook)
                res.setdefault("replayed_draws_s", {})[name] = draw_s[0]

            if args.ulp_control:
                from loner_tpu_torch.mapping.optimizer import tree_map

                port_run("port", state_from_jax(initial, device=dev))
                st = state_from_jax(initial, device=dev)
                up = tree_map(lambda x: torch.nextafter(x, torch.full_like(x, float("inf"))), st.params["sigma"])
                port_run("port_ulp", st._replace(params={**st.params, "sigma": up}))
            else:
                runs["jax"] = run_mapper(jm, jscans, times, tracked, gt, "jax", save)
                port_run("port", state_from_jax(initial, device=dev), restart)
        else:
            runs["port"] = run_mapper(make_port(), tscans, times, tracked, gt, "port")

    for name, r in runs.items():
        starts = window_starts(r["kf"])
        init_t, init_r = pose_errors(np.stack([r["poses_in"][s][k] for k, s in enumerate(starts)]), gt)
        ref_t, ref_r = pose_errors(r["poses"][-1], gt)
        res.setdefault("init_errors_m", {})[name] = init_t.tolist()
        res.setdefault("init_rot_errors_deg", {})[name] = init_r.tolist()
        res.setdefault("refined_errors_m", {})[name] = ref_t.tolist()
        res.setdefault("refined_rot_errors_deg", {})[name] = ref_r.tolist()
        res.setdefault("seconds", {})[name] = r["seconds"]
        res.setdefault("skipped_steps", {})[name] = r["skipped_steps"]
        res.setdefault("final_loss", {})[name] = float(r["loss"][-1])
    res["steps"] = int(len(runs["port"]["loss"]))

    if not wide:
        a, b = ("port", "port_ulp") if args.ulp_control else ("jax", "port")
        j, t = runs[a], runs[b]
        assert len(j["loss"]) == len(t["loss"])
        d_pos = np.linalg.norm(j["poses"][:, :, :3] - t["poses"][:, :, :3], axis=2).max(axis=1)
        d_loss = np.abs(t["loss"] - j["loss"]) / np.maximum(np.abs(j["loss"]), 1e-30)
        for i in range(res["steps"]):
            print(f"step {i:4d} kf {int(j['kf'][i])}: loss {a} {j['loss'][i]:.7e} {b} {t['loss'][i]:.7e} "
                  f"rel {d_loss[i]:.2e}; keyframe positions apart {d_pos[i]:.3e} m")
        parted, loss_parted = np.flatnonzero(d_pos > PART_M), np.flatnonzero(d_loss > LOSS_PART)
        diff = np.abs(np.asarray(res["refined_errors_m"][a]) - np.asarray(res["refined_errors_m"][b]))
        res.update(first_parted_step=int(parted[0]) if len(parted) else None, part_threshold_m=PART_M,
                   first_loss_parted_step=int(loss_parted[0]) if len(loss_parted) else None,
                   loss_part_threshold=LOSS_PART, max_pose_diff_m=float(d_pos.max()),
                   final_pose_diff_m=float(d_pos[-1]), max_loss_rel_diff=float(d_loss.max()),
                   max_refined_error_diff_m=float(diff.max()), same_landing=bool(diff.max() < 0.05))
        # from each restart: the step from the same state on the same draws, and
        # the largest loss difference over the 20 steps after it
        res["restarts"] = {str(k): {"loss_rel_diff": float(d_loss[k]), "positions_apart_m": float(d_pos[k]),
                                    "next_20_max_loss_rel_diff": float(d_loss[k:k + 20].max())}
                           for k in args.restart_at}
    for name in runs:
        print(f"{name}: keyframe errors m, tracked {res['start_errors_m']}, at insertion "
              f"{np.round(res['init_errors_m'][name], 4).tolist()}, refined "
              f"{np.round(res['refined_errors_m'][name], 4).tolist()} "
              f"(rotation {np.round(res['refined_rot_errors_deg'][name], 3).tolist()} deg); "
              f"{res['seconds'][name]:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**res, "per_step": {name: {"kf": r["kf"].tolist(), "loss": r["loss"].tolist(),
                                                  "poses": r["poses"].tolist()} for name, r in runs.items()}}, f)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
