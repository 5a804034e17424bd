"""Drive the PyTorch port (the mapper, the online SLAM loop with its loop
closure and camera phase, the users' programs, the map tools and debug
dumps, and the alternate encoders and data prep) on one CUDA card, and
check it.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

(``python3 chip_smoke.py --only 3h`` builds the kernels and runs leg 3h
alone, with its reduced-depth steps, and prints neither result line;
``--only 3i`` and ``--only 3j`` do the same for legs 3i and 3j.)

In order:
  1. print the card's name and power limit, build the kernel library
     (``loner_tpu_torch/csrc/*.cu`` with nvcc, at first use);
  2. run each kernel (B1 cp_fwd, B2 cp_bwd, B3 pdf_sample, B4 interp_fwd,
     B5 interp_dpts) at the flagship shapes on inputs taken from the
     flagship's own sampler, hold it against its plain PyTorch version, and
     time both with CUDA events, and each kernel by CUDA-graph replay (B3
     also against torch.searchsorted + gathers, the library call). B2 is
     also checked and timed on a fixed permutation of its points and
     gradients (its worst case), and its ray-ordered device time must be
     at most 0.65 ms. B4/B5 run
     at the shapes of both hash-on configurations (the triad's fat-row
     level, L=1 x F=16, and the 16-level FusedHash, L=16 x F=2), beside the
     corner-row gather and the strided table-gradient scatter they sit
     between. The memory probes' kernels
     (row_scatter_add, row_gather, col_gather, lane_gather, sublane_gather,
     two_stage_gather, cp_fwd_gather) run at their probe scripts' default
     shapes against their plain versions and library calls, col_gather
     also on an odd N and on one row, two_stage_gather also on rows of
     all-distinct m and of one value, row_scatter_add's four variants also
     exact at W = 8, 3, 32, on an update view 4 bytes off and on one row
     (each variant's device ms and share of the bound, the zero fill
     alone), sublane_gather also on every index equal, as an empty kernel
     of its grid, and on 4099 and 8192 rows, 136 and 4 columns and a table
     view 4 bytes off (each kernel's device ms beside its bound and its
     share of it);
  3. build the flagship mapper and run joint, pose-frozen and
     occupancy-update train steps, with every kernel's launch count set to 0
     just before and read just after: each kernel of the path must have
     launched once per step (B5 once per step with pose gradients), and
     every loss must be finite. Three paths: the default hash-off triad
     (B1-B3), the triad with its hash level (B1-B5; profiled), and the
     FusedHash field (B3-B5);
  3b. run the six memory probes (``loner_tpu_torch/probes/``) at their
      default sizes, each with every launch count set to 0 just before and
      read just after: each must launch its kernels as often as its own
      constants say, and every leg's numbers must be finite and its kernel
      results equal to their plain counterparts;
  3c. run the online SLAM loop (``LonerSLAM``) with cfg/defaults.yaml on the
      synthetic loop of 48 poses at the flagship scan width, every launch
      count set to 0 just before and read just after: B1-B3 once per train
      step of the keyframe schedule, the tracking ATE under 0.3 m, every pose
      finite; tracking ms per frame, each keyframe window's ms and its/s,
      tracking and keyframe ATE; one frame pair's ICP and one scan's motion
      compensation on the card against the CPU, and a profile of five ICP
      calls (chiprun_out/icp_profile.txt); a threaded run of 12 frames
      checked for the output files (into chiprun_out/slam*/);
  3d. the users' drivers, each with every launch count set to 0 just before
      and read just after (B1-B3 as their steps and renders imply, B4/B5
      never): ``python -m loner_tpu_torch.run_slam`` in-process over a
      36-pose synthetic sequence written to disk at 32 x 512 returns, with
      cfg/defaults.yaml as its baseline (ATE under 0.35 m, every output file
      present); the offline FDT optimization (``optimize_implicit_map``,
      through the encoder experiment's ``run_encoder``,
      ``loner_tpu_torch/experiments/exp_encoder_flagship.py``) of
      an 80-tree forest at window 16, 512 + 64 rays, 512 samples, MASK rays
      and the exact occupancy update, at most 8 epochs (final held-out L1
      under 1.15 m; set-up, training and eval times apart; a window-16
      step's time split and profile in chiprun_out/offline_step_profile.txt;
      B1 and B3 held against their plain versions on the inputs they met
      there: the window-16 step's and an eval render's);
      and ``python -m loner_tpu_torch.bench`` (its JSON line printed on its
      own; joint at most 1.05x frozen);
  3j. the encoder experiment as a user runs it:
      ``python -m loner_tpu_torch.experiments.exp_encoder_flagship
      --encoders triad:hash=1,fused --max-epochs 1`` in-process, at full
      width, every launch count set to 0 just before and read just after
      (per step and eval render B1-B4 as the hash-on fields, the point
      chunks and the frozen poses imply, B5 never), a finite L1, and B1-B4
      held against their plain versions on the inputs met there;
  3e. loop closure at the reference operating point: the online half of
      scripts/exp_quality_flagship.py through its port's ``run_online``
      (``loner_tpu_torch/experiments/exp_quality_flagship.py``), which runs
      ``run_slam.run_trial`` (126
      scans of one 31 m lap at 10 Hz, 32 x 512 returns, noise 0.01;
      cfg/defaults.yaml with loop closure on, motion compensation off and
      keyframes 0.75 s apart), every launch count set to 0 just before and
      read just after (B1-B3 once per train step): tracking-only and
      estimated ATE (at least one loop closure; the estimated ATE under the
      tracking-only one and under 0.1 m), ba_info.json, the windows' its/s,
      and the refinement's pose-graph solve on the card against the CPU;
  3f. the camera phase at full width: LonerSLAM as in 3c with the online
      camera phase on (20 steps of 1024 rays a window, the bf16 MLP) and a
      640 x 360 image after each scan through ``process_image``, every
      launch count set to 0 just before and read just after (B1-B3 as the
      lidar steps, the camera steps and their point chunks imply): images
      attached and dropped, the trained intensity branch's camera L1 under
      0.8x a fresh one's, a camera step's ms and device-busy ms (profile in
      chiprun_out/camera_step_profile.txt), B1-B3 held against their plain
      versions on a camera step's inputs, and one camera step on the card
      against the CPU;
  3g. the map tools and the debug dumps as a user runs them, on 3d's run
      directory (chiprun_out/cli_run) and sequence: ``render_map lidar`` and
      ``render_map mesh`` (resolution 128) over every 4th pose of its
      estimated trajectory (9 poses), 640 x 360 camera images (colours and
      peak consistency; the adjusted compositing), ``compute_metrics traj``
      (equal to ate.yaml) and ``map`` (the rendered cloud against the scans'
      world points), ``summarize_results`` over chiprun_out/, the sensor
      service and one loopback round trip, each part with every launch count
      set to 0 just before and read just after (B1 once per field point
      chunk and branch of each render chunk, B3 once per render chunk; B2,
      B4 and B5 never); the virtual scan's median depth error against the
      recorded scan under 1.15 m; B1 and B3 against their plain versions on
      the lidar render's inputs, and a render chunk of 1024 rays at 2048
      samples on the card against the CPU at five poses (the whole render
      within 8.1e-5, from the same rays and samples 2.75e-5: four times the
      largest of fifteen readings); and run_slam over the first 12 scans of
      3d's sequence with every debug dump flag on (ATE under 0.35 m; B1-B3
      once per train step, B1 and B3 once more per window's probe; every
      dump file present);
  3h. the three alternate hash encoders ("exact", "packed", "cell") at the
      flagship (16 levels x 2 features, 2^18 and 2^19 vertices; CellHash
      2^16 and 2^17 cells): per encoder 7 train steps (joint, pose-frozen,
      occupancy-update) with every launch count set to 0 just before and
      read just after (B3 once per step, B1, B2, B4, B5 never), a profile of
      three joint steps (chiprun_out/step_profile_<encoder>.txt) and the
      peak memory; B3 against its plain version on the inputs met there;
      each encoder and backward mode on one keyframe's points on the card
      (three times) against the CPU (forward within 1e-6, gradients within
      1e-5 of their largest entry, tied corner draws left out); the offline
      FDT leg of 3d on its keyframes with the "cell" field, 3 epochs (the
      last held-out L1 under 0.8x the first; B3 once per step and render);
      and the data prep: the native library built with g++ and each of its
      functions equal to its numpy path on a 128 x 1024 sweep, both timed,
      and ``scan_from_arrays`` with a harvester box;
  3i. the multi-device layer on meshes of cuda:0 listed n times (one
      controller drives a mesh; the machine has one card, so the shards run
      in turn and the numbers are the layer's overhead): the flagship
      hash-off DP step over 1, 2, 4 and 8 shards (wall ms, device busy ms,
      peak memory; B1-B3 n times a step), DP x TP on the hash-on triad at
      (2, 2) and (4, 2) and on the "exact", "packed" and "cell" flagships of
      3h at (2, 2), EP over 4 submaps of 3d's forest, 3e's pose graph
      over 8 devices, the camera step under a 2-device mesh, LonerSLAM
      with the tracker on device 0 and the mapper over [0, 0] (ATE under
      0.3 m) and ``dryrun_multichip(8)``, each part with every launch count
      set to 0 just before and read just after, and each sharded result held
      against the single-device one on the same draws (the bf16 MLP's
      gradients within 1e-4 normwise; ``_parallel_leg``);
  4. at a reduced depth (2 keyframes, 64 + 16 rays, 64 samples, full widths)
     run one step on the card and the same step on the CPU from one state
     with the same draws, and compare the loss and the gradients: hash off
     with the MLP in f32 and in bf16, and both hash-on fields and the three
     alternate encoders with an f32 MLP (64 samples per ray: the strided
     table gradient is active), each also from the same rays and samples on
     both devices (the whole step of FusedHash and the alternate encoders
     reported, not held);
  5. profile five more joint steps of each path (torch.profiler): device
     time by operator and the device's idle share, into
     chiprun_out/step_profile.txt (hash off), step_profile_hash.txt and
     step_profile_fused.txt;
  6. print one JSON line of the kernels and, last, the device line.

Any failed phase raises, and the script exits non-zero without printing a
result. It needs no network and leaves no process behind.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from loner_tpu_torch.probes.timing import empty_grid, graph_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores


def _event_ms(fn, iters: int, warmup: int = 2) -> float:
    from loner_tpu_torch.probes.timing import time_ms

    return time_ms(fn, torch.device("cuda", 0), iters, warmup)


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rel(a, b) -> float:
    from loner_tpu_torch.mapping.optimizer import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    num = sum(float(torch.sum((x.double().cpu() - y.double().cpu()) ** 2)) for x, y in zip(la, lb))
    den = sum(float(torch.sum(y.double().cpu() ** 2)) for y in lb)
    return math.sqrt(num / max(den, 1e-300))


def _steps(step, state, window, flags, mask):
    """One train step per call, threading the state: the unit ``_profile``
    runs."""
    box = {"state": state, "it": 0}

    def run():
        box["state"], _ = step(box["state"], window, flags, mask, box["it"])
        box["it"] += 1

    return run


def _profile(run_once, n_steps: int, wall_ms: float, path: Path, unit: str = "step") -> dict:
    """Device time by operator over ``n_steps`` calls of ``run_once``
    (torch.profiler, after one unrecorded warm-up call), and the device's
    idle share against ``wall_ms``, the call's time measured without the
    profiler, into ``path``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n_steps), acc_events=True) as prof:
        for _ in range(n_steps + 1):
            run_once()
            torch.cuda.synchronize()
            prof.step()
    events = prof.key_averages()

    def dev_ms(e):
        return e.self_device_time_total / 1e3 / n_steps

    # each kernel's time is the self device time of the one host operator
    # that launched it, so the host operators' sum is the busy time
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU and dev_ms(e) > 0), key=dev_ms, reverse=True)
    busy_ms = sum(dev_ms(e) for e in ops)
    calls = sum(e.count for e in ops) / n_steps
    lines = [f"{n_steps} {unit}s; per {unit}: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
             f"(wall measured without the profiler), idle share {1 - busy_ms / wall_ms:.3f}, "
             f"{calls:.0f} operators with device time",
             f"self device ms/{unit}  calls/{unit}  operator"]
    lines += [f"{dev_ms(e):10.4f}  {e.count / n_steps:8.1f}  {e.key[:90]}" for e in ops[:30]]
    path.write_text("\n".join(lines) + "\n")
    print("\n".join(lines[:16]))
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "idle_share": 1 - busy_ms / wall_ms, "operators": calls}


PATH_KERNELS = ("cp_fwd", "cp_bwd", "pdf_sample")  # B1-B3: the hash-off field and the sampler


class _Recorder:
    """Stands in for a kernel wrapper under its module name: keeps a copy of
    the arguments of the wrapper's first call at each set of tensor shapes,
    in ``into``, then calls the wrapper. ``launches`` is the wrapper's own
    count (the wrapper counts through its module name, which now names the
    recorder)."""

    def __init__(self, fn, into: dict):
        self.fn, self.into = fn, into

    def __call__(self, *args):
        shapes = tuple(tuple(a.shape) for a in args if torch.is_tensor(a))
        if shapes not in self.into:
            self.into[shapes] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        return self.fn(*args)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n


@contextlib.contextmanager
def _first_inputs(module, name: str, into: dict):
    """Route calls of ``module.name`` through a :class:`_Recorder` into
    ``into`` while the block runs."""
    fn = getattr(module, name)
    setattr(module, name, _Recorder(fn, into))
    try:
        yield
    finally:
        setattr(module, name, fn)


def _check_met_inputs(name, cp_in: dict, pdf_in: dict, bwd_in: dict = None, interp_in: dict = None) -> list:
    """B1 (``cp_fwd``), B3 (``pdf_sample``) and, when given, B2 (``cp_bwd``)
    and B4 (``interp_fwd``) on the inputs a phase gave them, against their
    plain versions with the bounds of the flagship checks: B1 and B4 1e-5 of
    the features' scale, B3 1e-6, B2 dlines 1e-4 of its largest entry and
    dpts within 1e-4. B2's dlines in its f32 mode are held against the
    plain version run in float64 (the exact sum of the same terms): the f32
    plain version's ``index_add_`` sums each line cell's terms by atomics,
    and on MASK rays' points, which crowd a few cells, it lands about 1.2e-4
    of the largest entry from the exact sum (leg 3j, NVIDIA H100 80GB HBM3),
    where the kernel lands about 3e-7; the bf16 mode, which rounds its
    operands, is held against the f32 plain version."""
    from loner_tpu_torch.ops import cp_kernel, pdf_kernel
    from loner_tpu_torch.ops import fused_encoder as fe

    rows = []
    for lines, pts, res, nf in cp_in.values():
        ref = cp_kernel.cp_encode_ref(lines, pts, res)
        err = float((cp_kernel.cp_fwd(lines, pts, res, nf) - ref).abs().max())
        rows.append({"kernel": "cp_fwd", "points": pts.shape[1], "max_abs_err": err,
                     "ok": err <= 1e-5 * max(1.0, float(ref.abs().max()))})
        del ref
    for lines, pts, g, res, nf, *mm in (bwd_in or {}).values():
        dl, dp = cp_kernel.cp_bwd(lines, pts, g, res, nf, *mm)
        dl_ref, dp_ref = cp_kernel.cp_bwd_ref(lines, pts, g, res, nf, *mm)
        e_dl, e_dp = float((dl - dl_ref).abs().max()), float((dp - dp_ref).abs().max())
        row = {"kernel": "cp_bwd", "points": pts.shape[1], "dlines_err": e_dl,
               "dlines_scale": float(dl_ref.abs().max()), "dpts_err": e_dp}
        dl_ok = e_dl <= 1e-4 * row["dlines_scale"]
        if tuple(mm) in ((), ("f32",)):
            dl64 = cp_kernel.cp_bwd_ref(lines.double(), pts.double(), g.double(), res, nf)[0]
            row["dlines_err_vs_f64"] = float((dl.double() - dl64).abs().max())
            row["plain_err_vs_f64"] = float((dl_ref.double() - dl64).abs().max())
            dl_ok = row["dlines_err_vs_f64"] <= 1e-4 * float(dl64.abs().max())
            del dl64
        rows.append({**row, "ok": dl_ok and bool(torch.allclose(dp, dp_ref, 1e-4, 1e-4))})
        del dl, dp, dl_ref, dp_ref
    for pts, v_t, ecfg in (interp_in or {}).values():
        ref = fe.interp_fwd_ref(pts, v_t, ecfg)
        err = float((fe.interp_fwd(pts, v_t, ecfg) - ref).abs().max())
        rows.append({"kernel": "interp_fwd", "points": pts.shape[1], "levels": ecfg.n_levels,
                     "features": ecfg.n_features, "max_abs_err": err,
                     "ok": err <= 1e-5 * max(1.0, float(ref.abs().max()))})
        del ref
    for bins, cdf, u, eps in pdf_in.values():
        err = float((pdf_kernel.pdf_sample(bins, cdf, u, eps) - pdf_kernel.pdf_sample_ref(bins, cdf, u, eps)).abs().max())
        rows.append({"kernel": "pdf_sample", "rays": u.shape[0], "bins": bins.shape[1], "draws": u.shape[1],
                     "max_abs_err": err, "ok": err <= 1e-6})
    torch.cuda.empty_cache()
    print(f"{name}: kernels on the inputs met there, against their plain versions: {rows}", flush=True)
    if not all(r["ok"] for r in rows):
        raise AssertionError(f"{name}: a kernel disagrees with its plain version: {rows}")
    return rows


def _check_launches(name, wrappers, expected: dict):
    """Every wrapper launched as ``expected`` says (one it does not name:
    never); returns the launches."""
    launches = {w.__name__: w.launches for w in wrappers}
    expected = {w.__name__: expected.get(w.__name__, 0) for w in wrappers}
    print(f"{name}: launches {launches} (expected {expected})", flush=True)
    if launches != expected:
        raise AssertionError(f"{name}: launches {launches}, expected {expected}")
    return launches


def _drive(name, opt, cfg, cube, state, window, plan, wrappers, expected):
    """Run ``plan`` [(kind, flags)] from ``state`` with every wrapper's
    launch count set to 0 just before and read just after; check finite
    losses, no skipped step and ``expected`` launches per wrapper name.
    Returns (step, state, mask, record of step times, peak memory, losses
    and launches)."""
    dev = state.poses.device
    step = opt.make_train_step(cfg, cube, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    mask = torch.ones(cfg.max_keyframes, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    losses, times = [], {}
    for it, (kind, flags) in enumerate(plan):
        t = time.perf_counter()
        state, aux = step(state, window, flags, mask, it)
        torch.cuda.synchronize()
        times.setdefault(kind, []).append((time.perf_counter() - t) * 1e3)
        losses.append(float(aux["loss"]))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"{name}: {len(plan)} steps, losses {['%.4f' % x for x in losses]}")
    launches = _check_launches(name, wrappers, expected)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    if int(state.skipped_steps) != 0 or int(state.global_step) != len(plan):
        raise AssertionError(f"{name}: steps skipped: {int(state.skipped_steps)} of {int(state.global_step)}")
    # the first step of each kind pays one-time set-up (cuBLAS handles,
    # allocator growth): it is kept in the JSON file but not in the means
    step_ms = {k: sum(v[1:]) / len(v[1:]) if len(v) > 1 else v[0] for k, v in times.items()}
    print(f"{name}: step ms (host clock, after synchronize; first step of each kind excluded): "
          + ", ".join(f"{k} {v:.3f}" for k, v in step_ms.items())
          + f"; first step {times[plan[0][0]][0]:.1f} ms; peak memory {peak_gib:.2f} GiB")
    record = {"step_ms": step_ms, "step_ms_all": times, "peak_mem_gib": peak_gib, "losses": losses,
              "launches": launches}
    return step, state, mask, record


def _field_step(opt, cfg, scube, state, bundle, z, draws):
    """The field part of a train step on the tensors' device, from given rays
    and samples: render, lidar loss, and its gradients against the sigma
    parameters and the rays' origins and directions."""
    nerf = cfg.nerf._replace(encoding_slot_period=cfg.n_samples_train)
    leaves = [t.detach().requires_grad_(True) for t in opt.tree_leaves(state.params["sigma"])]
    it = iter(leaves)
    params = {"sigma": opt.tree_map(lambda _: next(it), state.params["sigma"])}
    bundle = bundle._replace(origins=bundle.origins.detach().requires_grad_(True),
                             directions=bundle.directions.detach().requires_grad_(True))
    render = opt.render_rays(params, bundle, z, nerf, draws.enc_key, point_chunks=1, enc_u=draws.u_enc)
    loss, _ = opt.compute_lidar_loss(render, bundle, cfg.world_scale, cfg.loss,
                                     state.global_step.to(torch.float32), 0)
    grads = torch.autograd.grad(loss, leaves + [bundle.origins, bundle.directions])
    return float(loss.detach()), {"sigma": list(grads[:-2]), "rays": list(grads[-2:])}


def _scale_hash_table(state, factor: float):
    """The state with the sigma branch's hash table (triad "hash" leaf or
    FusedHash table) scaled by ``factor``."""
    sigma = state.params["sigma"]
    table = sigma["table"]
    table = {**table, "hash": table["hash"] * factor} if isinstance(table, dict) else table * factor
    return state._replace(params={**state.params, "sigma": {**sigma, "table": table}})


def _card_vs_cpu(opt, flagship, cfg, dev, flags, tol, what, whole_step_gated=True, hash_scale=None):
    """One reduced-depth step on the card and on the CPU from one state with
    the same draws: loss within 1e-5 relative, gradients within ``tol``. Also
    the field part of the step on both devices from the same rays and
    samples (made on the CPU), held to the same bounds. With
    ``whole_step_gated`` False the whole step's numbers are reported only;
    ``hash_scale`` scales the state's hash table first."""
    cpu = torch.device("cpu")
    moved = lambda tree, d=cpu: opt.tree_map(lambda t: t.to(d), tree)  # noqa: E731
    small = cfg._replace(window_size=2, max_keyframes=4, rays_per_kf=64, sky_rays_per_kf=16, n_samples_train=64)
    scfg, scube, sstate, swindow = flagship(device=dev, seed=2, cfg=small, n_keyframes=2)
    if hash_scale is not None:
        sstate = _scale_hash_table(sstate, hash_scale)
    sdraws = opt.draw_step(scfg, swindow, torch.Generator(device=dev).manual_seed(3), dev)
    smask = torch.ones(scfg.max_keyframes, device=dev)
    _, gpu_aux = opt.make_train_step(scfg, scube, device=dev)(sstate, swindow, flags, smask, 0, sdraws)
    _, cpu_aux = opt.make_train_step(scfg, scube, device=cpu)(
        moved(sstate), moved(swindow), flags, smask.cpu(), 0, moved(sdraws))
    loss_g, loss_c = float(gpu_aux["loss"]), float(cpu_aux["loss"])
    rel = {k: _rel(gpu_aux["grads"][k], cpu_aux["grads"][k]) for k in ("sigma", "poses")}

    # the rays and samples each device builds for itself, and the field from
    # the CPU's rays and samples on both
    rays = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        st, win, dr = moved(sstate, d), moved(swindow, d), moved(sdraws, d)
        with torch.no_grad():
            b = opt.build_window_rays(st.poses, win, scube.to(d), scfg, dr.ray_idx, dr.sky_idx)
            z = opt.sampling.occ_grid_sampler_z_vals(b, st.occ_grid, scfg.n_samples_train, scfg.perturb,
                                                     dr.u_strat, dr.u_pdf)
        rays[name] = (b, z)
    b_cpu, z_cpu = rays["cpu"]
    b_card, z_card = rays["card"]
    ray_diff = {"origins": float((b_card.origins.cpu() - b_cpu.origins).abs().max()),
                "directions": float((b_card.directions.cpu() - b_cpu.directions).abs().max()),
                "z_vals": float((z_card.cpu() - z_cpu).abs().max())}
    f_loss_g, f_grads_g = _field_step(opt, scfg, scube, moved(sstate, dev), moved(b_cpu, dev), z_cpu.to(dev),
                                      moved(sdraws, dev))
    f_loss_c, f_grads_c = _field_step(opt, scfg, scube, moved(sstate), b_cpu, z_cpu, moved(sdraws))
    f_rel = {k: _rel(f_grads_g[k], f_grads_c[k]) for k in ("sigma", "rays")}
    print(f"reduced step ({what}): loss card {loss_g:.6f} cpu {loss_c:.6f}; gradient rel err {rel}; "
          f"rays and samples built on each device differ by {ray_diff}; from the same rays and samples: "
          f"loss card {f_loss_g:.6f} cpu {f_loss_c:.6f}, gradient rel err {f_rel}")
    checks = [("field from the same rays", f_loss_g, f_loss_c, f_rel)]
    if whole_step_gated:
        checks.append(("whole step", loss_g, loss_c, rel))
    for part, lg, lc, r in checks:
        if not abs(lg - lc) <= 1e-5 * abs(lc):
            raise AssertionError(f"card and CPU losses differ ({what}, {part}): {lg} vs {lc}")
        if not max(r.values()) <= tol:
            raise AssertionError(f"card and CPU gradients differ ({what}, {part}): {r}")
    return {"loss_card": loss_g, "loss_cpu": loss_c, "grad_rel_err": rel, "whole_step_gated": whole_step_gated,
            "ray_diff": ray_diff, "field_loss_card": f_loss_g, "field_loss_cpu": f_loss_c,
            "field_grad_rel_err": f_rel, "bound": tol}


def _check_fused_kernels(fe, ecfg, pts, gen, what):
    """B4/B5 at one encoder configuration's flagship shapes against their
    plain versions, timed beside the gather and the table-gradient scatter."""
    dev = pts.device
    n, lf = pts.shape[1], ecfg.output_dim
    table = fe.init_fused_table(gen, ecfg, dev) * 1e4  # O(1) corner values
    tables_bf16 = table.to(torch.bfloat16)
    v_t = fe._gather_v_t(tables_bf16, pts, ecfg)
    g = torch.randn((lf, n), generator=gen, device=dev)
    out, ref = fe.interp_fwd(pts, v_t, ecfg), fe.interp_fwd_ref(pts, v_t, ecfg)
    e_fwd = float((out - ref).abs().max())
    if not e_fwd <= 1e-5 * max(1.0, float(ref.abs().max())):
        raise AssertionError(f"interp_fwd ({what}) disagrees with its plain version: max abs err {e_fwd}")
    del out, ref
    d, d_ref = fe.interp_dpts(pts, v_t, g, ecfg), fe.dpts_ref(pts, v_t, g, ecfg)
    e_dp, scale = float((d - d_ref).abs().max()), float(d_ref.abs().max())
    # dpts sums the levels' terms, each scaled by up to 2^19: held to 1e-4
    # relative with an absolute floor of 1e-4 of the largest entry
    if not torch.allclose(d, d_ref, rtol=1e-4, atol=1e-4 * scale):
        raise AssertionError(f"interp_dpts ({what}) disagrees: max abs err {e_dp} (scale {scale})")
    del d, d_ref
    key = torch.tensor([12345, 678], dtype=torch.int64, device=dev)
    res = {
        "fwd_err": e_fwd, "dpts_err": e_dp,
        "fwd_ms": _event_ms(lambda: fe.interp_fwd(pts, v_t, ecfg), 20),
        "fwd_plain_ms": _event_ms(lambda: fe.interp_fwd_ref(pts, v_t, ecfg), 3, 1),
        "dpts_ms": _event_ms(lambda: fe.interp_dpts(pts, v_t, g, ecfg), 20),
        "dpts_plain_ms": _event_ms(lambda: fe.dpts_ref(pts, v_t, g, ecfg), 3, 1),
        "fwd_graph_ms": graph_ms(lambda: fe.interp_fwd(pts, v_t, ecfg)),
        "dpts_graph_ms": graph_ms(lambda: fe.interp_dpts(pts, v_t, g, ecfg)),
        "gather_ms": _event_ms(lambda: fe._gather_v_t(tables_bf16, pts, ecfg), 10),
        "dtable_strided_ms": _event_ms(lambda: fe._bwd_dtable_strided(pts, g, key, ecfg), 10),
    }
    l, f = ecfg.n_levels, ecfg.n_features
    # B4 per (point, level): frac and 1-frac (15), 8 weights (16), 16 per
    # feature; bytes: pts + corner rows in, features out
    res["fwd_bound"] = _bound(n * (12 + 16 * l * f + 4 * l * f), n * l * (31 + 16 * f))
    # B5 per (point, level): frac (15), pc (16 per feature), 3 x 8 x 4 for the
    # three axis sums, 6 to scale and add; bytes: pts, rows, g in, dpts out
    res["dpts_bound"] = _bound(n * (12 + 16 * l * f + 4 * l * f + 12), n * l * (117 + 16 * f))
    print(f"B4/B5 at the {what} shapes (L={l}, F={f}, N={n}): " + ", ".join(
        f"{k} {v[0]:.4f} ({v[1]})" if isinstance(v, tuple) else f"{k} {v:.4g}" for k, v in res.items()))
    return res


def _entry(name, source, replaces, err, ms, plain_ms, bound, library_ms):
    return dict(name=name, route="cuda", source=f"loner_tpu_torch/csrc/{source}", replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                library_ms=library_ms)


def _check_probe_kernels(gs, cp_kernel, lines, pts, res, nf, b1_bound):
    """The probes' kernels at their scripts' default shapes against their
    plain versions and library calls (gathers equal; the scatter within 1e-6
    (f32) or 1e-2 (bf16) of the largest entry, and equal on updates whose
    partial sums are all exact; the CP forward within 1e-6 of
    its plain version and 1e-5 of B1), each timed with CUDA events over 200
    calls after a warm-up (the plain versions over 20). Bounds: bytes, each
    input read once and each output written once (the work is a load and a
    store, or an add, per element)."""
    from loner_tpu_torch.probes import bench_dyngather, bench_gather2, bench_pallas_scatter

    dev = pts.device
    gen = torch.Generator(device=dev).manual_seed(5)
    entries, details = [], {}

    def timed(fn, plain, library, name):
        """(ms, plain ms, library ms) of back-to-back calls, host included;
        the kernel's and the library call's device times (CUDA graph
        replay) go into ``details``."""
        details[f"{name}_graph_ms"] = {"kernel": graph_ms(fn), "library": graph_ms(library)}
        return _event_ms(fn, 200, 5), _event_ms(plain, 20, 2), _event_ms(library, 200, 5)

    # P1 row_scatter_add: N rows of 16 f32 into T rows
    n, t, w = bench_pallas_scatter.N, bench_pallas_scatter.T, bench_pallas_scatter.W
    idx = torch.randint(0, t, (n,), generator=gen, device=dev, dtype=torch.int32)
    upd = torch.randn((n, w), generator=gen, device=dev)
    idx64 = idx.long()
    library = lambda: torch.zeros((t, w), device=dev).index_add_(0, idx64, upd)  # noqa: E731
    exact = library()
    scale = float(exact.abs().max())
    # Small-integer updates, 4 rows an entry, whose partial sums are all
    # exact in bf16: every order of the atomics gives the exact sum, so each
    # variant must equal index_add_ and its plain version bit for bit
    int_idx = (torch.randperm(n, generator=gen, device=dev) % t).to(torch.int32)
    int_upd = torch.randint(-4, 5, (n, w), generator=gen, device=dev).float()
    int_exact = torch.zeros((t, w), device=dev).index_add_(0, int_idx.long(), int_upd)
    # the same on the edges: W = 8 and 32 (vector path), 3 and an update view
    # 4 bytes off a 16-byte boundary (scalar path), and one row
    edges = {}
    for ew, en, off in ((8, n, 0), (3, n, 0), (32, n // 4, 0), (w, n, 1), (w, 1, 0)):
        buf = torch.randint(-4, 5, (en * ew + off,), generator=gen, device=dev).float()
        e_upd = buf[off:].view(en, ew)
        e_idx = int_idx[:en].contiguous()
        edges[(ew, en, off)] = (e_idx, e_upd, torch.zeros((t, ew), device=dev).index_add_(0, e_idx.long(), e_upd))
    errs = {}
    for nshadow, acc, label in bench_pallas_scatter.VARIANTS:
        out = gs.row_scatter_add(int_idx, int_upd, t, nshadow, acc)
        plain = gs.row_scatter_add_ref(int_idx, int_upd, t, nshadow, acc)
        if not (torch.equal(out, int_exact) and torch.equal(out, plain)):
            raise AssertionError(f"{label}: not exact on updates whose every partial sum is exact")
        for (ew, en, off), (e_idx, e_upd, e_exact) in edges.items():
            out = gs.row_scatter_add(e_idx, e_upd, t, nshadow, acc)
            plain = gs.row_scatter_add_ref(e_idx, e_upd, t, nshadow, acc)
            if not (torch.equal(out, e_exact) and torch.equal(out, plain)):
                raise AssertionError(f"{label}: not exact at W={ew}, N={en}, a view {off} floats in")
        out = gs.row_scatter_add(idx, upd, t, nshadow, acc)
        plain = gs.row_scatter_add_ref(idx, upd, t, nshadow, acc)
        bound = 1e-6 if acc == torch.float32 else 1e-2
        e_plain, e_lib = float((out - plain).abs().max()), float((out - exact).abs().max())
        # atomics add in a varying order: held against the largest entry
        if not max(e_plain, e_lib) <= bound * scale:
            raise AssertionError(f"{label}: err vs plain {e_plain}, vs index_add_ {e_lib}, scale {scale}")
        call = lambda: gs.row_scatter_add(idx, upd, t, nshadow, acc)  # noqa: E731
        errs[label] = {"vs_plain": e_plain, "vs_index_add": e_lib, "ms": _event_ms(call, 200, 5),
                       "graph_ms": graph_ms(call)}
    bound = _bound(4 * n + 4 * n * w + 4 * t * w, n * w)
    fill_ms = graph_ms(lambda: torch.zeros((t, w), device=dev))
    details["row_scatter_add"] = {"scale": scale, "variants": errs, "zero_fill_graph_ms": fill_ms,
                                  "edges_exact": [list(k) for k in edges]}
    print("row_scatter_add variants: " + "; ".join(
        f"{k}: {v['ms']:.4f} ms, device {v['graph_ms']:.4f} ms ({bound[0] / v['graph_ms']:.0%} of the bound), "
        f"err vs plain {v['vs_plain']:.3e}, vs index_add_ {v['vs_index_add']:.3e}" for k, v in errs.items())
        + f" (largest entry {scale:.4f}); the zero fill alone {fill_ms:.4f} ms; exact at (W, N, offset) "
          f"{sorted(edges)}", flush=True)
    ms, plain_ms, lib_ms = timed(lambda: gs.row_scatter_add(idx, upd, t), lambda: gs.row_scatter_add_ref(idx, upd, t),
                                 library, "row_scatter_add")
    entries.append(_entry("row_scatter_add", "gather_scatter.cu", "scripts/bench_pallas_scatter.py:45",
                          errs[bench_pallas_scatter.VARIANTS[0][2]]["vs_plain"], ms, plain_ms, bound, lib_ms))
    del idx, upd, idx64, exact, int_idx, int_upd, int_exact, edges

    def variant_ms(name, fn, plain, library, tab, variants):
        """{variant: device ms} of ``fn(tab, idx)`` on each variant's
        indices, after holding it equal to its plain version and library
        call there."""
        out = {}
        for label, ix in variants.items():
            got = fn(tab, ix)
            if not (torch.equal(got, plain(tab, ix)) and torch.equal(got, library(ix))):
                raise AssertionError(f"{name} disagrees with its plain version or its library call on {label}")
            del got
            out[label] = graph_ms(lambda: fn(tab, ix))
        print(f"{name} device ms by graph replay on other indices: {out}", flush=True)
        return out

    def gather_entry(name, fn, plain, library, nbytes, replaces):
        out, ref = fn(), plain()
        if not (torch.equal(out, ref) and torch.equal(out, library())):
            raise AssertionError(f"{name} disagrees with its plain version or its library call")
        err = float((out - ref).abs().max())
        del out, ref
        ms, plain_ms, lib_ms = timed(fn, plain, library, name)
        entries.append(_entry(name, "gather_scatter.cu", replaces, err, ms, plain_ms, _bound(nbytes, 0), lib_ms))

    # P2: one hash level's corner rows, (T, 8) f32 table, 2.36M points
    n, t, w = bench_gather2.N, bench_gather2.T, 8
    table = torch.randn((t, w), generator=gen, device=dev)
    table_t = table.T.contiguous()
    idx = torch.randint(0, t, (n,), generator=gen, device=dev, dtype=torch.int32)
    idx64 = idx.long()
    nbytes = 4 * (t * w + n + n * w)
    gather_entry("row_gather", lambda: gs.row_gather(table, idx), lambda: gs.row_gather_ref(table, idx),
                 lambda: torch.index_select(table, 0, idx64), nbytes, "scripts/bench_gather.py:106")
    gather_entry("col_gather", lambda: gs.col_gather(table_t, idx), lambda: gs.col_gather_ref(table_t, idx),
                 lambda: torch.index_select(table_t, 1, idx64), nbytes, "scripts/bench_gather.py:127")
    # one point fewer (scalar stores), and every point on one row (one L2
    # sector a point: what the sectors cost the random draws)
    odd, same = idx[1:], torch.full_like(idx, t // 2)
    details["col_gather_variants"] = variant_ms(
        "col_gather", gs.col_gather, gs.col_gather_ref, lambda i: torch.index_select(table_t, 1, i.long()),
        table_t, {"odd_n": odd, "one_row": same})
    del table, table_t, idx, idx64, odd, same

    # P3/P6: one flagship level as an (N/128, 128) lane gather
    rows = n // 128
    tab = torch.randn((rows, 128), generator=gen, device=dev)
    idx = torch.randint(0, 128, (rows, 128), generator=gen, device=dev, dtype=torch.int32)
    idx64 = idx.long()
    gather_entry("lane_gather", lambda: gs.lane_gather(tab, idx), lambda: gs.lane_gather_ref(tab, idx),
                 lambda: torch.gather(tab, 1, idx64), 3 * 4 * rows * 128, "scripts/bench_honest.py:84")

    # P4: the slab lookups; the JSON line carries the largest slab
    for r in bench_dyngather.ROWS:
        tab = torch.randn((r, 128), generator=gen, device=dev)
        idx = torch.randint(0, r, (r, 128), generator=gen, device=dev, dtype=torch.int32)
        lane_idx = idx % 128
        for fn, ref in ((gs.sublane_gather, gs.sublane_gather_ref), (gs.lane_gather, gs.lane_gather_ref)):
            ix = idx if fn is gs.sublane_gather else lane_idx
            if not torch.equal(fn(tab, ix), ref(tab, ix)):
                raise AssertionError(f"{fn.__name__} disagrees with its plain version at rows={r}")
    idx64 = idx.long()
    gather_entry("sublane_gather", lambda: gs.sublane_gather(tab, idx), lambda: gs.sublane_gather_ref(tab, idx),
                 lambda: torch.gather(tab, 0, idx64), 3 * 4 * r * 128, "scripts/bench_dyngather.py:56")
    # the largest slab's parts: every index equal (lookups nearly free), an
    # empty kernel of the same grid (the launch floor)
    parts = variant_ms("sublane_gather", gs.sublane_gather, gs.sublane_gather_ref,
                       lambda i: torch.gather(tab, 0, i.long()), tab, {"all_equal": torch.full_like(idx, r // 2)})
    parts["empty_kernel"] = graph_ms(lambda: empty_grid(-(-r * 128 // 256), dev))
    details["sublane_gather_variants"] = parts
    print(f"sublane_gather at rows={r}: device ms all-equal {parts['all_equal']:.4f}, an empty kernel of its grid "
          f"{parts['empty_kernel']:.4f}", flush=True)
    # the edges: rows not a multiple of a block's, 136 and 4 columns, 8192
    # rows, a table view 4 bytes off a 16-byte boundary
    for er, ec, off in ((4099, 128, 0), (512, 136, 0), (512, 4, 0), (8192, 128, 0), (512, 128, 1)):
        e_tab = torch.randn((er * ec + off,), generator=gen, device=dev)[off:].view(er, ec)
        e_idx = torch.randint(0, er, (er, ec), generator=gen, device=dev, dtype=torch.int32)
        got = gs.sublane_gather(e_tab, e_idx)
        if not (torch.equal(got, gs.sublane_gather_ref(e_tab, e_idx))
                and torch.equal(got, torch.gather(e_tab, 0, e_idx.long()))):
            raise AssertionError(f"sublane_gather disagrees at ({er}, {ec}), a view {off} floats in")
    del got, e_tab, e_idx
    r, chunks = bench_dyngather.R, bench_dyngather.CHUNKS
    tab = torch.randn((r, 128), generator=gen, device=dev)
    idxs = torch.randint(0, r, (chunks, r, 128), generator=gen, device=dev, dtype=torch.int32)
    # int64 indices for both stages of the library call, made once, outside the timed calls
    idxs64, lane64 = idxs.long(), idxs.long() % 128

    def two_gathers():
        return torch.gather(torch.gather(tab.expand(chunks, -1, -1), 1, idxs64), 2, lane64)

    gather_entry("two_stage_gather", lambda: gs.two_stage_gather(tab, idxs),
                 lambda: gs.two_stage_gather_ref(tab, idxs), two_gathers, 4 * (r * 128 + 2 * idxs.numel()),
                 "scripts/bench_dyngather.py:93")
    # rows whose m are all distinct (no value read twice: the design's worst
    # case), as arange(128) and as a random permutation of it (which spreads
    # a row's lookups over the whole table), plus random multiples of 128;
    # and every index equal (one m a row, one sector a lookup)
    shift = 128 * torch.randint(0, r // 128, idxs.shape, generator=gen, device=dev, dtype=torch.int32)
    perm = torch.argsort(torch.rand(idxs.shape, generator=gen, device=dev), dim=-1).int()
    variants = {"all_distinct_m": torch.arange(128, device=dev, dtype=torch.int32) + shift,
                "permuted_m": perm + shift, "one_value": torch.full_like(idxs, r // 2)}
    details["two_stage_gather_variants"] = variant_ms(
        "two_stage_gather", gs.two_stage_gather, gs.two_stage_gather_ref,
        lambda i: torch.gather(torch.gather(tab.expand(chunks, -1, -1), 1, i.long()), 2, i.long() % 128), tab,
        variants)

    def lookups(ix):
        """Table values the kernel reads: the distinct m of each row, summed."""
        m = torch.sort(ix % 128, dim=-1).values
        return ix.shape[0] * ix.shape[1] + int((m[..., 1:] != m[..., :-1]).sum())

    details["two_stage_gather_lookups"] = {k: lookups(v) for k, v in {"uniform": idxs, **variants}.items()}
    print(f"two_stage_gather distinct lookups: {details['two_stage_gather_lookups']}", flush=True)
    del tab, idx, idx64, lane_idx, idxs, idxs64, lane64, shift, perm, variants

    # P5: the CP forward by direct lookups, on B1's flagship inputs
    out = cp_kernel.cp_fwd_gather(lines, pts, res, nf)
    err = float((out - cp_kernel.cp_fwd_gather_ref(lines, pts, res)).abs().max())
    err_b1 = float((out - cp_kernel.cp_fwd(lines, pts, res, nf)).abs().max())
    if not (err <= 1e-6 and err_b1 <= 1e-5):
        raise AssertionError(f"cp_fwd_gather disagrees: {err} vs its plain version, {err_b1} vs B1")
    del out
    ms = _event_ms(lambda: cp_kernel.cp_fwd_gather(lines, pts, res, nf), 200, 5)
    plain_ms = _event_ms(lambda: cp_kernel.cp_fwd_gather_ref(lines, pts, res), 3, 1)
    details["cp_fwd_gather_graph_ms"] = {"kernel": graph_ms(lambda: cp_kernel.cp_fwd_gather(lines, pts, res, nf))}
    entries.append(_entry("cp_fwd_gather", "cp_gather.cu", "scripts/bench_lane_gather.py:48", err, ms, plain_ms,
                          b1_bound, None))
    details["cp_fwd_gather_vs_b1"] = err_b1
    for e in entries:
        graph = details.get(f"{e['name']}_graph_ms", {})
        share = f", {e['bound_ms'] / graph['kernel']:.0%} of the bound" if graph else ""
        print(f"{e['name']}: {e['ms']:.4f} ms (plain {e['plain_ms']:.4f}, bound {e['bound_ms']:.4f} by "
              f"{e['bound_by']}, library {e['library_ms']}), max abs err {e['max_abs_err']:.3e}; "
              f"device ms by graph replay {graph}{share}", flush=True)
    return entries, details


def _probe_launches(wrappers):
    """{probe module: {wrapper name: launches}}: the launches each probe must
    make with its own constants at its default sizes (one checked call plus
    the timed calls of each kernel leg; a chained leg runs K iterations
    twice)."""
    from loner_tpu_torch.probes import (bench_dyngather, bench_gather, bench_gather2, bench_honest,
                                        bench_lane_gather, bench_pallas_scatter)

    expected = {
        bench_pallas_scatter: {"row_scatter_add": len(bench_pallas_scatter.VARIANTS) * (1 + bench_pallas_scatter.ITERS)},
        bench_gather: {"row_gather": 2 * (1 + bench_gather.ITERS), "col_gather": 1 + bench_gather.ITERS},
        bench_gather2: {"lane_gather": 2 * bench_gather2.K},
        bench_dyngather: {"sublane_gather": len(bench_dyngather.ROWS) * (1 + bench_dyngather.ITERS),
                          "lane_gather": len(bench_dyngather.ROWS) * (1 + bench_dyngather.ITERS),
                          "two_stage_gather": 1 + bench_dyngather.ITERS},
        bench_lane_gather: {"cp_fwd": 2 * bench_lane_gather.K + 1, "cp_fwd_gather": 2 * bench_lane_gather.K + 1},
        # lane; fwd, fieldbwd and step (B1); fieldbwd and step (B2); sampler and step (B3)
        bench_honest: {"lane_gather": 2 * bench_honest.K, "cp_fwd": 3 * 2 * bench_honest.K,
                       "cp_bwd": 2 * 2 * bench_honest.K, "pdf_sample": 2 * 2 * bench_honest.K},
    }
    return {m: {w.__name__: expected[m].get(w.__name__, 0) for w in wrappers} for m in expected}


def _run_probes(wrappers):
    """Run every probe's ``main`` on the card at its default sizes, with every
    wrapper's launch count set to 0 just before and read just after; check
    the launches against the probe's constants and each leg's numbers."""
    runs = {}
    for module, expected in _probe_launches(wrappers).items():
        name = module.__name__.rsplit(".", 1)[1]
        for w in wrappers:
            w.launches = 0
        t0 = time.perf_counter()
        result = module.main([])
        torch.cuda.synchronize()
        print(f"probe {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        launches = _check_launches(f"probe {name}", wrappers, expected)
        for leg, values in result["legs"].items():
            for key, v in values.items():
                bad = ((not isinstance(v, bool) and not math.isfinite(v))
                       or (key == "equal" and not v)
                       or (key in ("max_abs_err", "abs_err") and not v <= (1e-5 if "cp_fwd" in leg else 0.0))
                       or (key == "rel_err" and not v <= (1e-6 if "f32" in leg else 1e-2)))
                if bad:
                    raise AssertionError(f"probe {name}, leg {leg!r}: {key} = {v}")
        runs[name] = {"legs": result["legs"], "launches": launches}
        torch.cuda.empty_cache()
    return runs


def _online_slam(root: Path, out_dir: Path, wrappers, dev=torch.device("cuda", 0)) -> dict:
    """The port's LonerSLAM on the card with cfg/defaults.yaml (ray range the
    scene's (1, 40); motion compensation off: the synthetic scans are each
    taken from one pose, so compensating them adds motion they do not have)
    over the synthetic loop of 48 poses, scans of 32 x 512 returns padded to
    16384 and 1024 sky directions padded to the 4096 sky budget. Every
    launch count is set to 0 just before the run and read just after: B1-B3
    must launch once per train step the schedule ran, B4/B5 never. Fails on
    a tracking ATE of 0.3 m or more or a non-finite pose. Then one frame
    pair's ICP and one scan's motion compensation on the card against the
    CPU, and a threaded run of 12 frames checked for the output contract."""
    import numpy as np

    from loner_tpu_torch.config.build import build_slam_config
    from loner_tpu_torch.config.settings import load_settings
    from loner_tpu_torch.data import synthetic
    from loner_tpu_torch.data.scan import make_lidar_scan, sky_scan
    from loner_tpu_torch.geometry.motion import motion_compensate
    from loner_tpu_torch.geometry.world_cube import compute_world_cube
    from loner_tpu_torch.slam import LonerSLAM
    from loner_tpu_torch.tracking.icp import make_icp

    ray_range = (1.0, 40.0)
    overrides = {"data": {"ray_range": list(ray_range)}, "tracker": {"motion_compensation": {"enabled": False}}}
    settings = load_settings(str(root / "cfg" / "defaults.yaml"), overrides=overrides)
    scene = synthetic.Scene.default()
    poses, ts = synthetic.circular_trajectory(n_poses=48, radius=5.0, z=1.5, period=9.6)
    gt = np.linalg.inv(poses[0])[None] @ poses  # the tracker's frame: the first pose
    cube = compute_world_cube(poses, ray_range=ray_range, rebase_to_first_pose=True)
    n_sky_pad = build_slam_config(settings, cube.scale_factor).mapper.n_sky_pad
    scans = []
    for T, t0 in zip(poses, ts):
        dirs, dists, stamps, hit = synthetic.simulate_scan(scene, T, t0, n_channels=32, n_azimuth=512,
                                                           max_range=ray_range[1])
        scans.append((make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=16384),
                      sky_scan(dirs[~hit][:1024], ray_range[1] + 1.0, t0, pad_to=n_sky_pad)))

    def run(n_frames, single_threaded, run_dir):
        cfg = build_slam_config(settings, cube.scale_factor)
        cfg.single_threaded = single_threaded
        slam = LonerSLAM(cfg, cube, device=dev)
        est = [slam.process_scan(scan, t0, gt_pose=g, sky=sky)
               for (scan, sky), t0, g in zip(scans[:n_frames], ts, gt)]
        slam.stop(str(run_dir))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return slam, np.stack(est)

    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    slam, est = run(len(poses), True, out_dir / "slam")
    wall_s = time.perf_counter() - t0
    mapper = slam.mapper
    kfs = mapper.kf_manager.keyframes
    # the schedule's steps for each optimization pass (one per keyframe)
    expected_steps = _schedule_steps(mapper.cfg.schedule, len(kfs))
    # the hash-off train step: B1-B3 once per step, the hash kernels never
    launches = _check_launches("online SLAM", wrappers, {k: expected_steps for k in PATH_KERNELS})
    track_ms = np.asarray(slam.tracker.track_times) * 1e3
    windows = [{"ms": dt * 1e3, "iterations": n, "its_per_s": n / dt} for dt, n in mapper.window_timer.rows]
    ate = float(np.sqrt(np.mean(np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1) ** 2)))
    kf_opt = np.stack([mapper.optimized_pose(k) for k in kfs])
    kf_gt = np.stack([k.gt_pose for k in kfs])
    kf_tracked = np.stack([k.tracked_pose for k in kfs])
    kf_ate = float(np.sqrt(np.mean(np.linalg.norm(kf_opt[:, :3, 3] - kf_gt[:, :3, 3], axis=1) ** 2)))
    kf_tracked_ate = float(np.sqrt(np.mean(np.linalg.norm(kf_tracked[:, :3, 3] - kf_gt[:, :3, 3], axis=1) ** 2)))
    res = {
        "frames": len(est), "keyframes": [k.timestamp for k in kfs], "train_steps": mapper._host_step,
        "expected_steps": expected_steps, "launches": launches, "wall_s": wall_s,
        "track_ms_median": float(np.median(track_ms)), "track_ms_p90": float(np.percentile(track_ms, 90)),
        "track_ms_first": float(track_ms[0]), "windows": windows, "reference_its_per_s": 16.7,
        "tracking_ate_m": ate, "keyframe_ate_m": kf_ate, "keyframe_tracked_ate_m": kf_tracked_ate,
        "skipped_steps": int(mapper.state.skipped_steps),
    }
    print(f"online SLAM: {len(est)} frames, keyframes at {res['keyframes']}, {mapper._host_step} train steps, "
          f"{wall_s:.1f} s; tracking ms median {res['track_ms_median']:.2f} p90 {res['track_ms_p90']:.2f} "
          f"(first frame {res['track_ms_first']:.2f})", flush=True)
    print("online SLAM windows (ms, iterations, its/s; reference budget 16.7 its/s): " + "; ".join(
        f"{w['ms']:.1f}, {w['iterations']}, {w['its_per_s']:.2f}" for w in windows))
    print(f"online SLAM: tracking ATE {ate:.4f} m, keyframe ATE {kf_ate:.4f} m (tracked at the keyframes "
          f"{kf_tracked_ate:.4f} m)")
    if not (np.all(np.isfinite(est)) and np.all(np.isfinite(kf_opt))):
        raise AssertionError("online SLAM: a non-finite pose")
    if not ate < 0.3:
        raise AssertionError(f"online SLAM: tracking ATE {ate:.4f} m, at or over the 0.3 m gate")
    if mapper._host_step != expected_steps or res["skipped_steps"]:
        raise AssertionError(f"online SLAM: {mapper._host_step} steps ({res['skipped_steps']} skipped), "
                             f"expected {expected_steps}")
    for name in ("tracking_only", "estimated_trajectory", "keyframe_trajectory", "online_estimates"):
        if not np.all(np.isfinite(np.loadtxt(out_dir / "slam" / "trajectory" / f"{name}.txt"))):
            raise AssertionError(f"online SLAM: non-finite {name}.txt")

    # one frame pair's ICP, and one scan's motion compensation, card against CPU
    cpu = torch.device("cpu")
    (src, sv), (tgt, tv) = slam.tracker._extract_cloud(scans[1][0]), slam.tracker._extract_cloud(scans[0][0])
    icp_cfg = slam.cfg.tracker.icp
    args = [src, sv, tgt, tv, torch.eye(4, device=dev)]
    T_card, rmse_card, fit_card = make_icp(icp_cfg, dev)(*args)
    T_cpu, rmse_cpu, fit_cpu = make_icp(icp_cfg, cpu)(*(a.cpu() for a in args))
    icp_err = float((T_card.cpu() - T_cpu).abs().max())
    if dev.type == "cuda":
        # where a frame's ICP spends its time: device busy against wall
        icp = make_icp(icp_cfg, dev)
        wall = []
        for _ in range(6):
            t = time.perf_counter()
            icp(*args)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
        res["icp_profile"] = _profile(lambda: icp(*args), 5, sum(wall[1:]) / 5, out_dir / "icp_profile.txt", "ICP")
    scan = scans[3][0]
    mc_args = [torch.as_tensor(np.asarray(a, np.float32)) for a in (
        scan.ray_directions, scan.distances, scan.timestamps, gt[2], gt[3], ts[2], ts[3], gt[3])]
    d_card, r_card = motion_compensate(*(a.to(dev) for a in mc_args))
    d_cpu, r_cpu = motion_compensate(*mc_args)
    mc_err = max(float((d_card.cpu() - d_cpu).abs().max()), float((r_card.cpu() - r_cpu).abs().max()))
    print(f"ICP of frames 1 -> 0 on the card against the CPU: T max abs diff {icp_err:.3e} (bound 1e-4); "
          f"rmse {float(rmse_card):.6f} / {float(rmse_cpu):.6f}, fitness {float(fit_card):.4f} / "
          f"{float(fit_cpu):.4f}; motion compensation max abs diff {mc_err:.3e} (bound 1e-5)")
    if not (icp_err <= 1e-4 and mc_err <= 1e-5):
        raise AssertionError(f"card and CPU disagree: ICP {icp_err}, motion compensation {mc_err}")
    res.update(icp_card_vs_cpu=icp_err, motion_compensation_card_vs_cpu=mc_err)
    del slam, mapper

    # the threaded mode: 12 frames, the mapper on a worker thread
    t0 = time.perf_counter()
    tslam, test = run(12, False, out_dir / "slam_threaded")
    contract = ["trajectory/tracking_only.txt", "trajectory/estimated_trajectory.txt",
                "trajectory/keyframe_trajectory.txt", "trajectory/online_estimates.txt",
                "trajectory/groundtruth.txt", "track_times.csv", "map_times.csv", "timing.csv",
                "checkpoints/kf_poses.npz", f"checkpoints/ckpt_{tslam.mapper._host_step}/state.pt"]
    missing = [f for f in contract if not (out_dir / "slam_threaded" / f).exists()]
    tracked = np.loadtxt(out_dir / "slam_threaded" / "trajectory" / "tracking_only.txt")
    print(f"online SLAM, threaded: 12 frames, {len(tslam.mapper.kf_manager)} keyframe(s), "
          f"{tslam.mapper._host_step} steps, {time.perf_counter() - t0:.1f} s; output files missing: {missing}")
    if missing or tracked.shape != (12, 8) or not np.all(np.isfinite(tracked)) or not np.all(np.isfinite(test)):
        raise AssertionError(f"threaded SLAM: missing {missing}, tracking_only {tracked.shape}")
    if np.abs(test[:, :3, 3] - est[:12, :3, 3]).max() > 1e-3:
        raise AssertionError("threaded SLAM tracked other poses than the single-threaded run")
    res["threaded"] = {"steps": tslam.mapper._host_step, "contract": contract}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def _cli_drive(root: Path, out_dir: Path, wrappers) -> dict:
    """``python -m loner_tpu_torch.run_slam``, called in-process as a user
    runs it: a 36-pose synthetic loop of period 7.2 s at 32 x 512 returns
    written to disk, cfg/defaults.yaml as the baseline of a sequence file
    (ray range (1, 40), motion compensation off, scan and sky budgets
    16384 / 4096). Fails unless ate.yaml's rmse is under 0.35 m, every
    output file is there, and B1-B3 launched once per train step."""
    import numpy as np
    import yaml

    from loner_tpu_torch import run_slam
    from loner_tpu_torch.data.dataset import write_synthetic_dataset

    seq, run_dir = out_dir / "cli_seq", out_dir / "cli_run"
    t0 = time.perf_counter()
    write_synthetic_dataset(str(seq), n_poses=36, period=7.2, n_channels=32, n_azimuth=512)
    seq_yaml = out_dir / "cli_sequence.yaml"
    seq_yaml.write_text(yaml.safe_dump({
        "baseline": str(root / "cfg" / "defaults.yaml"),
        "changes": {"data": {"ray_range": [1, 40], "scan_points_budget": 16384, "sky_points_budget": 4096},
                    "tracker": {"motion_compensation": {"enabled": False}}},
    }))
    setup_s = time.perf_counter() - t0
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    ates = run_slam.main([str(seq_yaml), "--dataset", str(seq), "--out", str(run_dir)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    timing = np.atleast_2d(np.loadtxt(run_dir / "timing.csv", delimiter=",", skiprows=1))
    steps = int(timing[:, 1].sum())
    launches = _check_launches("CLI drive", wrappers, {k: steps for k in PATH_KERNELS})
    ate = yaml.safe_load((run_dir / "ate.yaml").read_text())
    contract = ["full_config.yaml", "full_config.pkl", "world_cube.yaml", "runtime.txt", "ate.yaml", "timing.csv",
                "track_times.csv", "map_times.csv", "checkpoints/kf_poses.npz", f"checkpoints/ckpt_{steps}/state.pt"]
    contract += [f"trajectory/{n}.txt" for n in ("tracking_only", "estimated_trajectory", "keyframe_trajectory",
                                                  "online_estimates", "groundtruth")]
    missing = [f for f in contract if not (run_dir / f).exists()]
    track_ms = np.loadtxt(run_dir / "track_times.csv") * 1e3
    res = {"sequence_write_s": setup_s, "wall_s": wall_s, "ate": ate, "train_steps": steps, "launches": launches,
           "windows_its_per_s": [float(x) for x in timing[:, 2]], "track_ms_median": float(np.median(track_ms)),
           "missing": missing}
    print(f"CLI drive (python -m loner_tpu_torch.run_slam): sequence written in {setup_s:.1f} s, run {wall_s:.1f} s; "
          f"ATE rmse {ate['rmse']:.4f} m over {ate['n']} poses (gate 0.35); {steps} train steps, windows "
          f"{res['windows_its_per_s']} its/s, tracking median {res['track_ms_median']:.2f} ms; missing {missing}",
          flush=True)
    if missing or ates != [ate["rmse"]]:
        raise AssertionError(f"CLI drive: output files missing {missing}, ATEs {ates}")
    if not ate["rmse"] < 0.35:
        raise AssertionError(f"CLI drive: ATE {ate['rmse']:.4f} m, at or over the 0.35 m gate")
    return res


def _forest_keyframes():
    """(keyframes, cube, ray range, seconds) of the offline FDT legs: the
    encoder experiment's forest (``exp_encoder_flagship.forest_keyframes``), an
    80-tree forest, 40 keyframes on two circles of 32 x 512 returns ray-cast
    on the host."""
    from loner_tpu_torch.experiments import exp_encoder_flagship as enc

    t0 = time.perf_counter()
    kfs, cube = enc.forest_keyframes()
    return kfs, cube, enc.RAY_RANGE, time.perf_counter() - t0


def _offline_cfg(cube, ray_range):
    """The offline FDT legs' mapper, the encoder experiment's ``triad_nohash``:
    window 16, 512 + 64 rays, 512 samples in two point chunks, MASK
    trunk-band rays, 1024 samples a test ray."""
    from loner_tpu_torch.experiments import exp_encoder_flagship as enc

    cfg = enc.mapper_config("triad_nohash", cube)
    if tuple(cfg.ray_range) != tuple(ray_range):
        raise AssertionError(f"offline legs: ray range {ray_range}, the experiment's {cfg.ray_range}")
    return cfg


def _offline_leg(out_dir: Path, wrappers, dev, forest) -> dict:
    """The offline FDT map optimization (``optimize_implicit_map``) at the
    triad-nohash leg of scripts/exp_encoder_flagship.py, through the port's
    experiment (``exp_encoder_flagship.run_encoder``), on ``forest``
    (:func:`_forest_keyframes`): an 80-tree forest,
    40 keyframes on two circles, ray range (2.5, 45), window 16, 512 + 64
    rays, 512 samples in two point chunks, MASK trunk-band rays,
    n_samples_test 1024, the exact occupancy update, at most 8 epochs with
    the held-out L1 early stop at 1.05 m. Fails on a non-finite L1 or a
    final L1 of 1.15 m or more, or launches other than the steps and eval
    renders imply: per train step B1 and B2 once per point chunk, B3 once;
    per eval render (6 held-out scans an epoch) B1 once per field chunk
    (NeRFConfig.point_chunks), B3 once. B1 and B3 are then held against
    their plain versions on the first inputs they met at each shape, which
    must include the window-16 step's and an eval render's."""
    from loner_tpu_torch.experiments import exp_encoder_flagship as enc
    from loner_tpu_torch.mapping import optimizer as opt
    from loner_tpu_torch.mapping.keyframe import stack_window
    from loner_tpu_torch.models import sampling
    from loner_tpu_torch.ops import cp_kernel

    kfs, cube, ray_range, setup_s = forest
    n_kfs = len(kfs)
    cfg = _offline_cfg(cube, ray_range)
    offline = enc.offline_config(8)
    print(f"offline FDT leg: forest of 80 trees, {n_kfs} scans ray-cast on the host in {setup_s:.1f} s", flush=True)

    cp_in, pdf_in = {}, {}
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _first_inputs(cp_kernel, "cp_fwd", cp_in), _first_inputs(sampling, "pdf_sample", pdf_in):
        record, result = enc.run_encoder(cfg, cube, kfs, offline, dev, log_fn=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    renders = offline.n_eval_scans * result.epochs_run
    chunks = cfg.nerf.point_chunks
    launches = _check_launches("offline FDT leg", wrappers, {
        "cp_fwd": cfg.train_point_chunks * result.iterations + chunks * renders,
        "cp_bwd": cfg.train_point_chunks * result.iterations,
        "pdf_sample": result.iterations + renders})
    train_s = result.wall_time_s - result.eval_time_s
    # B1 and B3 at this leg's shapes: B3 at the window-16 step's and the
    # eval render's, B1 at the step's point chunk and the render's
    rays, eval_rays = cfg.window_size * (cfg.rays_per_kf + cfg.sky_rays_per_kf), offline.eval_rays_per_scan
    met = _check_met_inputs("offline FDT leg", cp_in, pdf_in)
    want = {("cp_fwd", rays * cfg.n_samples_train // cfg.train_point_chunks),
            ("cp_fwd", eval_rays * cfg.n_samples_test // chunks),
            ("pdf_sample", rays, cfg.n_samples_train // 2), ("pdf_sample", eval_rays, cfg.n_samples_test // 2)}
    seen = {("cp_fwd", r["points"]) if r["kernel"] == "cp_fwd" else ("pdf_sample", r["rays"], r["draws"]) for r in met}
    if not want <= seen:
        raise AssertionError(f"offline FDT leg: kernel inputs met {sorted(seen)}, expected at least {sorted(want)}")
    del cp_in, pdf_in

    # where a window-16 step's time goes: synchronized plain and
    # occupancy-update steps on one window of the final state, then a profile
    step = opt.make_train_step(cfg._replace(occ=cfg.occ._replace(estimator="exact")), cube, dev)
    window = stack_window(kfs[:16], n_sky_pad=1024, device=dev)
    flags = opt.TrainStepFlags(freeze_sigma=False, freeze_rgb=True, freeze_poses=True, do_occ_update=False)
    mask = torch.zeros(cfg.max_keyframes, device=dev)
    times = {}
    state = result.state
    for kind, occ in [("step", False)] * 4 + [("occ_step", True)] * 3:
        t = time.perf_counter()
        state, _ = step(state, window, flags._replace(do_occ_update=occ), mask, 0)
        torch.cuda.synchronize()
        times.setdefault(kind, []).append((time.perf_counter() - t) * 1e3)
    step_ms = {k: sum(v[1:]) / len(v[1:]) for k, v in times.items()}
    prof = _profile(_steps(step, state, window, flags, mask), 3, step_ms["step"], out_dir / "offline_step_profile.txt")
    res = {"l1_history_m": result.l1_history, "epochs": result.epochs_run, "iterations": result.iterations,
           "setup_s": setup_s, "wall_s": result.wall_time_s, "train_s": train_s, "eval_s": result.eval_time_s,
           "step_ms": step_ms, "step_profile": prof, "peak_mem_gib": peak_gib, "launches": launches,
           "kernels_on_met_inputs": met, "experiment_record": record,
           "eval_renders": renders, "gate_m": 1.05, "jax_side_m": 1.002}
    print(f"offline FDT leg: L1 history {[round(x, 4) for x in result.l1_history]} m over {result.epochs_run} epochs, "
          f"{result.iterations} iterations; set-up {setup_s:.1f} s, training {train_s:.1f} s, eval "
          f"{result.eval_time_s:.1f} s ({renders} renders); window-16 step {step_ms['step']:.2f} ms, with the exact "
          f"occupancy update {step_ms['occ_step']:.2f} ms (host clock, synchronized), device busy "
          f"{prof['busy_ms']:.3f} ms a step; peak memory {peak_gib:.2f} GiB. Final L1 "
          f"{result.l1_history[-1]:.4f} m against the 1.05 m gate and the JAX side's 1.002 m "
          f"(ENCODER_EXP_r05.json, triad_nohash; a quality number)", flush=True)
    if not all(math.isfinite(x) for x in result.l1_history) or not result.l1_history[-1] < 1.15:
        raise AssertionError(f"offline FDT leg: L1 history {result.l1_history}, final at or over 1.15 m")
    if int(result.state.skipped_steps):
        raise AssertionError(f"offline FDT leg: {int(result.state.skipped_steps)} steps skipped")
    del result, state, step, window
    torch.cuda.empty_cache()
    return res


def _encoder_experiment_leg(out_dir: Path, wrappers, dev, forest) -> dict:
    """Leg 3j: ``python -m loner_tpu_torch.experiments.exp_encoder_flagship
    --encoders triad:hash=1,fused --max-epochs 1`` in-process at full width
    (its forest: 80 trees, 40 scans of 32 x 512 returns; window 16, 512 + 64
    rays, 512 samples in two point chunks), every launch count set to 0
    just before and read just after. The poses are frozen offline, so no
    step takes a point gradient and B5 never launches. Per train step B3
    once, B4 once per point chunk, and with the triad's hash level B1 and B2
    once per point chunk too; per eval render (6 held-out scans an epoch) B3
    once, B4 (and with the triad B1) once per field chunk
    (``NeRFConfig.point_chunks``). Fails on a non-finite L1 or other
    launches; then B1-B4 are held against their plain versions on the first
    inputs they met at each shape, which must include the window-16 step's
    and an eval render's. Last, where a window-16 step of
    each field's time goes: 4 synchronized steps and a profile of 3 more
    (``offline_step_profile_<field>.txt`` in the output directory) from a fresh state on
    ``forest``'s (:func:`_forest_keyframes`) first 16 keyframes."""
    import numpy as np

    from loner_tpu_torch.experiments import exp_encoder_flagship as enc
    from loner_tpu_torch.geometry import se3
    from loner_tpu_torch.mapping import optimizer as opt
    from loner_tpu_torch.mapping.keyframe import stack_window
    from loner_tpu_torch.models import sampling
    from loner_tpu_torch.models.nerf import NeRFConfig
    from loner_tpu_torch.ops import cp_kernel
    from loner_tpu_torch.ops import fused_encoder as fe

    t0 = time.perf_counter()
    cp_in, bwd_in, pdf_in, interp_in = {}, {}, {}, {}
    for w in wrappers:
        w.launches = 0
    with _first_inputs(cp_kernel, "cp_fwd", cp_in), _first_inputs(cp_kernel, "cp_bwd", bwd_in), \
            _first_inputs(sampling, "pdf_sample", pdf_in), _first_inputs(fe, "interp_fwd", interp_in):
        payload = enc.main(["--encoders", "triad:hash=1,fused", "--max-epochs", "1",
                            "--out", str(out_dir / "exp_encoder_3j.json")])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    offline, chunks, train_chunks = enc.offline_config(1), NeRFConfig().point_chunks, 2
    expected = {k: 0 for k in ("cp_fwd", "cp_bwd", "pdf_sample", "interp_fwd", "interp_dpts")}
    for spec, rec in payload["results"].items():
        steps, renders = rec["iterations"], offline.n_eval_scans * rec["epochs"]
        field = train_chunks * steps + chunks * renders  # field passes: train chunks, eval chunks
        expected["pdf_sample"] += steps + renders
        expected["interp_fwd"] += field
        if spec.startswith("triad"):
            expected["cp_fwd"] += field
            expected["cp_bwd"] += train_chunks * steps
        if not (rec["epochs"] == 1 and all(math.isfinite(x) for x in rec["l1_history_m"])):
            raise AssertionError(f"leg 3j {spec}: {rec}")
    launches = _check_launches("leg 3j (encoder experiment)", wrappers, expected)
    met = _check_met_inputs("leg 3j", cp_in, pdf_in, bwd_in, interp_in)
    rays = 16 * 576
    want = {("cp_fwd", rays * 512 // train_chunks), ("cp_fwd", 1024 * 1024 // chunks),
            ("interp_fwd", rays * 512 // train_chunks), ("interp_fwd", 1024 * 1024 // chunks),
            ("cp_bwd", rays * 512 // train_chunks), ("pdf_sample", rays), ("pdf_sample", 1024)}
    seen = {(r["kernel"], r["rays"] if r["kernel"] == "pdf_sample" else r["points"]) for r in met}
    if not want <= seen:
        raise AssertionError(f"leg 3j: kernel inputs met {sorted(seen)}, expected at least {sorted(want)}")
    del cp_in, bwd_in, pdf_in, interp_in
    torch.cuda.empty_cache()

    kfs, cube = forest[0], forest[1]
    window = stack_window(kfs[:16], n_sky_pad=1024, device=dev)
    pose6 = se3.matrix_to_pose(torch.as_tensor(np.stack([k.gt_pose for k in kfs[:16]]), dtype=torch.float32))
    flags = opt.TrainStepFlags(freeze_sigma=False, freeze_rgb=True, freeze_poses=True, do_occ_update=False)
    steps = {}
    for spec in payload["results"]:
        cfg = enc.mapper_config(spec, cube)
        cfg = cfg._replace(occ=cfg.occ._replace(estimator="exact"))  # the offline loop's
        state = opt.init_mapper_state(torch.Generator(device=dev).manual_seed(8), cfg, dev)
        poses = state.poses.clone()
        poses[:16] = pose6.to(dev)
        state = state._replace(poses=poses)
        step, mask = opt.make_train_step(cfg, cube, dev), torch.zeros(cfg.max_keyframes, device=dev)
        times = []
        for _ in range(4):
            t = time.perf_counter()
            state, _ = step(state, window, flags, mask, 0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        wall = sum(times[1:]) / 3
        name = spec.replace(":", "_").replace("=", "")
        steps[spec] = {"wall_ms": wall, "wall_ms_all": times,
                       "profile": _profile(_steps(step, state, window, flags, mask), 3, wall,
                                           out_dir / f"offline_step_profile_{name}.txt")}
        del step, state
        torch.cuda.empty_cache()
    print(f"leg 3j: {time.perf_counter() - t0:.1f} s; " + "; ".join(
        f"{k}: L1 {[round(x, 4) for x in r['l1_history_m']]} m, {r['iterations']} iterations, training "
        f"{r['train_ms_per_step']:.2f} ms a step, wall {r['wall_time_s']:.1f} s; a window-16 step "
        f"{steps[k]['wall_ms']:.2f} ms, device busy {steps[k]['profile']['busy_ms']:.3f} ms"
        for k, r in payload["results"].items()), flush=True)
    return {"wall_s": wall_s, "record": payload, "launches": launches, "kernels_on_met_inputs": met,
            "window16_steps": steps}


def _bench(wrappers) -> dict:
    """``python -m loner_tpu_torch.bench`` in-process at its defaults (the
    flagship): its JSON line goes out on its own line; fails unless both
    rates are finite, joint is at most 1.05x frozen after the re-measure,
    and B1-B3 launched once per train step it ran."""
    from loner_tpu_torch import bench

    for w in wrappers:
        w.launches = 0
    res = bench.main([])
    torch.cuda.synchronize()
    res["launches"] = _check_launches("bench", wrappers, {k: res["train_steps"] for k in PATH_KERNELS})
    joint, frozen = res["joint_its_per_s"], res["frozen_its_per_s"]
    if not (math.isfinite(joint) and math.isfinite(frozen) and joint <= frozen * 1.05):
        raise AssertionError(f"bench: joint {joint} it/s, frozen {frozen} it/s")
    torch.cuda.empty_cache()
    return res


def _schedule_steps(schedule, n_passes: int) -> int:
    """The train steps of ``n_passes`` optimization passes of a keyframe
    schedule."""
    from loner_tpu_torch.mapping.mapper import phases_for_pass

    return sum(p.num_iterations for i in range(1, n_passes + 1) for p in phases_for_pass(schedule, i))


def _loop_closure_leg(out_dir: Path, wrappers, dev) -> dict:
    """Loop closure at the reference operating point: the online half of
    scripts/exp_quality_flagship.py through the port's experiment
    (``exp_quality_flagship.run_online``, which runs ``run_slam.run_trial``).
    One 31 m lap at 10 Hz (126 scans, radius 5 m, period 12.6 s, 32 x 512
    returns, noise 0.01) written by ``write_synthetic_dataset``,
    cfg/defaults.yaml with ray range (1, 40), scan budget 16384, motion
    compensation off, loop closure on and TEMPORAL keyframes 0.75 s apart
    (QUALITY_r05.json's ``keyframe_spacing_s``; the script's 1.5 s is the
    experiment's default). Every launch count is set
    to 0 just before the run and read just after: B1-B3 once per train step,
    the steps those of the schedule. Fails on no loop closure, or an
    estimated ATE at or over the tracking-only ATE or 0.1 m. Then the
    refinement's pose-graph solve again on the CPU from the same factors:
    the poses within 1e-4 of the card's."""
    import numpy as np

    from loner_tpu_torch.config.build import build_schedule
    from loner_tpu_torch.experiments import exp_quality_flagship as quality
    from loner_tpu_torch.mapping import loop_closure

    lc_dir = out_dir / "lc"
    seq, run_dir = lc_dir / "seq", lc_dir / "run"
    spacing = {"mapper": {"keyframe_manager": {"keyframe_selection": {"temporal": {"time_diff_seconds": 0.75}}}}}
    settings = quality.online_settings(overrides=spacing)

    # the refinement's solve, recorded with its inputs
    solve, solves = loop_closure.solve_pose_graph, []

    def recording_solve(poses6, factors, **kw):
        out = solve(poses6, factors, **kw)
        solves.append((poses6.clone(), factors, kw, out[0].clone()))
        return out

    for w in wrappers:
        w.launches = 0
    loop_closure.solve_pose_graph = recording_solve
    try:
        t0 = time.perf_counter()
        online = quality.run_online(str(lc_dir), 126, dev, overrides=spacing)
        torch.cuda.synchronize()
        wall_s = online["wall_time_s"]
        setup_s = time.perf_counter() - t0 - wall_s  # the sequence written to disk
    finally:
        loop_closure.solve_pose_graph = solve
    timing = np.atleast_2d(np.loadtxt(run_dir / "timing.csv", delimiter=",", skiprows=1))
    steps = int(timing[:, 1].sum())
    n_kfs = len(np.atleast_2d(np.loadtxt(run_dir / "trajectory" / "keyframe_trajectory.txt")))
    expected_steps = _schedule_steps(build_schedule(settings), n_kfs)
    launches = _check_launches("loop closure leg", wrappers, {k: steps for k in PATH_KERNELS})
    ate_track, ate_est, ba = online["ate_tracking_only_m"], online["ate_estimated_m"], online["ba"]
    track_ms = np.loadtxt(run_dir / "track_times.csv") * 1e3

    # the same solve on the CPU, from the same factors and priors
    if len(solves) != 1:
        raise AssertionError(f"loop closure leg: {len(solves)} pose-graph solves, expected 1")
    p6, factors, kw, refined_card = solves[0]
    refined_cpu, cost_cpu = solve(p6.cpu(), factors, **kw)
    pg_err = float((refined_card.cpu() - refined_cpu).abs().max())
    res = {"sequence_write_s": setup_s, "wall_s": wall_s, "scans": online["n_scans"], "keyframes": n_kfs,
           "experiment_record": online,
           "train_steps": steps, "expected_steps": expected_steps, "launches": launches,
           "ate_tracking_only_m": ate_track, "ate_estimated_m": float(ate_est), "ba_info": ba,
           "windows_its_per_s": [float(x) for x in timing[:, 2]], "track_ms_median": float(np.median(track_ms)),
           "pose_graph_card_vs_cpu": pg_err, "pose_graph_keyframes": int(p6.shape[0]),
           "jax_quality_r05": {"ate_tracking_only_m": 0.1455, "ate_estimated_m": 0.0298},
           "pose_graph_inputs": (p6, factors, kw)}  # for leg 3i; not written to the JSON file
    print(f"loop closure leg: {online['n_scans']} scans written in {setup_s:.1f} s, run {wall_s:.1f} s; "
          f"{n_kfs} keyframes, {steps} train steps (schedule {expected_steps}); tracking-only ATE "
          f"{ate_track:.4f} m, estimated ATE {float(ate_est):.4f} m (the JAX package's run on a TPU v5e, QUALITY_r05.json: 0.1455 / 0.0298 m, a "
          f"quality figure); ba_info {ba}; windows {[round(x, 2) for x in res['windows_its_per_s']]} its/s, "
          f"tracking median {res['track_ms_median']:.2f} ms; pose graph card against CPU: max abs diff "
          f"{pg_err:.3e} over {int(p6.shape[0])} poses (bound 1e-4)", flush=True)
    if steps != expected_steps:
        raise AssertionError(f"loop closure leg: {steps} train steps, the schedule gives {expected_steps}")
    if not ba or ba["n_loop_closures"] < 1:
        raise AssertionError(f"loop closure leg: no loop closure ({ba})")
    if not (math.isfinite(ate_est) and ate_est < ate_track and ate_est < 0.1):
        raise AssertionError(f"loop closure leg: estimated ATE {ate_est:.4f} m against tracking-only "
                             f"{ate_track:.4f} m (gates: under both it and 0.1 m)")
    if not pg_err <= 1e-4:
        raise AssertionError(f"loop closure leg: the pose graph on the card and the CPU differ by {pg_err}")
    # the sequence (about 40 MB) and the state checkpoints are deleted:
    # chiprun_out/ keeps small files (the CLI drive keeps a full run directory)
    shutil.rmtree(seq)
    shutil.rmtree(run_dir / "checkpoints")
    torch.cuda.empty_cache()
    return res


def _camera_card_vs_cpu(mcfg, cube, state, win, n_rays: int, dev) -> dict:
    """One camera step on the card against the CPU from one state with the
    same draws (made on the CPU), with the MLP in bf16 (the leg's) and in
    f32. The step builds its rays and OGM samples on its own device
    (``camera_rays_and_samples``), and there the devices part: the rays lie
    within an ulp, but the OGM samples of about a third of the rays move
    by up to a few 1e-4 (cube units), and the field turns that into loss
    differences of up to 1.37e-5 relative (f32 MLP) and gradient
    differences of up to 1.1e-2 of their largest entry (bf16) between two
    whole steps (NVIDIA H100 80GB HBM3, 700.00 W, PERF.md). So each part is
    held on its own:

    - the card's rays and samples, built twice, bit-equal; against the
      CPU's, every ray coordinate within 4.8e-7 (4 ulps at 1) and no
      validity flip (the samples' differences are reported; B3 itself is
      held against its plain version on the step's inputs in the leg);
    - "step": the card's whole step against the CPU's field part of the
      step (``camera_loss_and_grads``: render, camera loss, intensity
      gradients) on the card's rays and samples;
    - "field": the field part on both devices on the CPU's rays and
      samples.

    Every intensity gradient within 2^-8 of its largest entry, every loss
    within 1e-5 relative but the whole bf16 step's, 5e-4. The two whole
    steps, each on its own rays and samples, are reported only."""
    from loner_tpu_torch.mapping import camera_optimizer as cam
    from loner_tpu_torch.mapping.optimizer import tree_leaves, tree_map

    cpu = torch.device("cpu")
    draws = cam.draw_camera_step(mcfg, win, n_rays, torch.Generator().manual_seed(2), cpu)
    draws_card = tree_map(lambda t: t.to(dev), draws)
    cube_c, state_c, win_c = cube.to(cpu), tree_map(lambda t: t.to(cpu), state), cam.CameraWindow(*(t.to(cpu)
                                                                                                    for t in win))
    built = {"card": cam.camera_rays_and_samples(mcfg, cube, win, state.occ_grid, draws_card),
             "cpu": cam.camera_rays_and_samples(mcfg, cube_c, win_c, state_c.occ_grid, draws)}
    again = cam.camera_rays_and_samples(mcfg, cube, win, state.occ_grid, draws_card)
    (b_card, _, z_card), (b_cpu, _, z_cpu) = built["card"], built["cpu"]
    dz = (z_card.cpu() - z_cpu).abs().amax(dim=1)
    rays = {"deterministic": all(torch.equal(x, y) for x, y in zip([*again[0], *again[1:]],
                                                                     [*b_card, *built["card"][1:]])),
            "ray_max_abs": max(float((getattr(b_card, f).cpu() - getattr(b_cpu, f)).abs().max())
                               for f in ("origins", "directions", "viewdirs", "near", "far")),
            "valid_flips": int((b_card.valid.cpu() != b_cpu.valid).sum()), "sample_max_abs": float(dz.max()),
            "rays_with_samples_moved_over_1e-5": int((dz > 1e-5).sum())}

    def field(cfg, d, st, src):
        b, target, z = src
        loss, _, grads = cam.camera_loss_and_grads(cfg, st.params, type(b)(*(t.to(d) for t in b)), target.to(d),
                                                   z.to(d), draws.enc_key.to(d), draws.enc_key_intensity.to(d))
        return float(loss), grads

    def compare(card, cpu_side):
        (l_card, g_card), (l_cpu, g_cpu) = card, cpu_side
        g_err = max(float((a.cpu() - b.cpu()).abs().max()) for a, b in zip(g_card, g_cpu))
        g_scale = max(float(b.abs().max()) for b in g_cpu)
        return {"loss_card": l_card, "loss_cpu": l_cpu, "loss_rel": abs(l_card - l_cpu) / abs(l_cpu),
                "grad_max_abs": g_err, "grad_scale": g_scale, "grad_share": g_err / g_scale}

    rows, own_built = {}, {}
    for dtype in ("bfloat16", "float32"):
        cfg = mcfg._replace(nerf=mcfg.nerf._replace(compute_dtype=dtype))
        steps = {}
        for name, (d, c, st, w, dr) in {"card": (dev, cube, state, win, draws_card),
                                        "cpu": (cpu, cube_c, state_c, win_c, draws)}.items():
            _, aux = cam.make_camera_train_step(cfg, c, n_rays, device=d)(st, w, dr)
            steps[name] = float(aux["loss"]), tree_leaves(aux["grads"]["intensity"])
        rows[f"step, {dtype} MLP"] = compare(steps["card"], field(cfg, cpu, state_c, built["card"]))
        rows[f"field, {dtype} MLP"] = compare(field(cfg, dev, state, built["cpu"]), field(cfg, cpu, state_c,
                                                                                        built["cpu"]))
        own_built[f"step, {dtype} MLP"] = compare(steps["card"], steps["cpu"])
    print(f"camera leg, one camera step on the card against the CPU: the card's rays and samples bit-equal when "
          f"built again {rays['deterministic']}; against the CPU's rays within {rays['ray_max_abs']:.3e} (bound "
          f"4.8e-7), {rays['valid_flips']} validity flips; samples within {rays['sample_max_abs']:.3e} (reported; "
          f"{rays['rays_with_samples_moved_over_1e-5']} of {n_rays} rays moved over 1e-5); the step on the "
          f"card's rays and samples, the field on the CPU's (loss bound 1e-5 relative, the whole bf16 step's 5e-4; "
          f"gradients 2^-8 of their largest entry): " + "; ".join(
              f"{k}: loss {r['loss_card']:.7f} / {r['loss_cpu']:.7f} (relative {r['loss_rel']:.3e}), gradients "
              f"max abs diff {r['grad_max_abs']:.3e} of {r['grad_scale']:.3e}" for k, r in rows.items())
          + "; reported only, each whole step on its own rays and samples: " + "; ".join(
              f"{k}: loss relative {r['loss_rel']:.3e}, gradients {r['grad_share']:.3e} of their largest entry"
              for k, r in own_built.items()), flush=True)
    loss_bound = {k: 5e-4 if k == "step, bfloat16 MLP" else 1e-5 for k in rows}
    bad = {k: r for k, r in rows.items() if not (r["loss_rel"] <= loss_bound[k] and r["grad_share"] <= 2.0**-8)}
    if not (rays["deterministic"] and rays["ray_max_abs"] <= 4.8e-7 and rays["valid_flips"] == 0):
        bad["rays and samples"] = rays
    if bad:
        raise AssertionError(f"camera leg: card and CPU camera steps differ: {bad}")
    return {**rows, "rays_and_samples": rays, "whole_steps_each_on_its_own_rays": own_built}


def _camera_leg(root: Path, out_dir: Path, wrappers, dev) -> dict:
    """The camera phase at full width: LonerSLAM from cfg/defaults.yaml
    (ray range (1, 40), motion compensation off; its field of 3 colours, SH
    degree 4 and a 64 x 4 intensity MLP, with the MLP in bf16) on the
    48-pose loop of phase 3c, with ``OnlineCameraConfig(enabled=True,
    iterations_per_window=20, n_rays=1024)``. One 640 x 360 image (the HPK
    camera's size) after each scan, stamped inside its interval, rendered
    by ``render_intensity_image`` with ``write_synthetic_images``' intrinsics
    and extrinsics and tiled to 3 channels. Every launch count is set to 0
    just before the run and read just after: per lidar step B1-B3 once, per
    camera step B1 twice per point chunk (sigma and intensity), B2 once per
    chunk (the intensity lines), B3 once. Fails on fewer than 3 keyframes
    with images, a skipped (non-finite) step, or a trained intensity branch
    whose masked camera L1 is not under 0.8x a fresh branch's on the same
    rays and samples. Then a camera step's time and profile
    (chiprun_out/camera_step_profile.txt), B1-B3 held against their plain
    versions on one camera step's inputs, and one camera step on the card
    against the CPU from one state with the same draws
    (``_camera_card_vs_cpu``)."""
    import numpy as np

    from loner_tpu_torch.config.build import build_slam_config
    from loner_tpu_torch.config.settings import load_settings
    from loner_tpu_torch.data import synthetic
    from loner_tpu_torch.data.scan import make_lidar_scan, sky_scan
    from loner_tpu_torch.geometry.world_cube import compute_world_cube
    from loner_tpu_torch.mapping import camera_optimizer as cam
    from loner_tpu_torch.mapping.mapper import OnlineCameraConfig
    from loner_tpu_torch.models import losses, nerf, rendering, sampling
    from loner_tpu_torch.ops import cp_kernel
    from loner_tpu_torch.slam import LonerSLAM

    ray_range, height, width, n_rays = (1.0, 40.0), 360, 640, 1024
    settings = load_settings(str(root / "cfg" / "defaults.yaml"), overrides={
        "data": {"ray_range": list(ray_range)}, "tracker": {"motion_compensation": {"enabled": False}}})
    scene = synthetic.Scene.default()
    poses, ts = synthetic.circular_trajectory(n_poses=48, radius=5.0, z=1.5, period=9.6)
    gt = np.linalg.inv(poses[0])[None] @ poses
    cube = compute_world_cube(poses, ray_range=ray_range, rebase_to_first_pose=True)
    # write_synthetic_images' camera: looking along +x of the lidar
    K = np.array([[width / 2, 0, width / 2], [0, width / 2, height / 2], [0, 0, 1.0]])
    t_lc = np.eye(4)
    t_lc[:3, :3] = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    cfg = build_slam_config(settings, cube.scale_factor)
    mcfg = cfg.mapper.mapper._replace(nerf=cfg.mapper.mapper.nerf._replace(compute_dtype="bfloat16"))
    cfg.mapper.mapper = mcfg
    cfg.mapper.camera = OnlineCameraConfig(enabled=True, K=K, lidar_to_camera=t_lc, iterations_per_window=20,
                                           n_rays=n_rays)
    t0 = time.perf_counter()
    frames = []
    for T, t in zip(poses, ts):
        dirs, dists, stamps, hit = synthetic.simulate_scan(scene, T, t, n_channels=32, n_azimuth=512,
                                                           max_range=ray_range[1])
        img, _ = synthetic.render_intensity_image(scene, T @ t_lc, K, height, width, ray_range[1])
        frames.append((make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=16384),
                       sky_scan(dirs[~hit][:1024], ray_range[1] + 1.0, t, pad_to=cfg.mapper.n_sky_pad),
                       np.repeat(img, 3, axis=-1), float(np.median(stamps[hit]))))
    setup_s = time.perf_counter() - t0
    print(f"camera leg: {len(frames)} scans and {height} x {width} images ray-cast on the host in {setup_s:.1f} s",
          flush=True)

    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    slam = LonerSLAM(cfg, cube, device=dev)
    for (scan, sky, img, t_mid), t, g in zip(frames, ts, gt):
        slam.process_scan(scan, t, gt_pose=g, sky=sky)
        slam.process_image(img, t_mid)
    slam.stop(str(out_dir / "camera_slam"))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    mapper = slam.mapper
    kfs = mapper.kf_manager.keyframes
    lidar_steps = mapper._host_step
    cam_steps = int(mapper.state.global_step) - lidar_steps
    expected_lidar = _schedule_steps(cfg.mapper.schedule, len(kfs))
    # every image arrives after its scan's pass: every pass but the first has
    # an image in its window
    expected_cam = cfg.mapper.camera.iterations_per_window * (len(kfs) - 1)
    n = n_rays * mcfg.n_samples_train
    chunks = mcfg.nerf.point_chunks if mcfg.nerf.point_chunks > 1 and n % mcfg.nerf.point_chunks == 0 else 1
    launches = _check_launches("camera leg", wrappers, {
        "cp_fwd": lidar_steps * mcfg.train_point_chunks + cam_steps * 2 * chunks,
        "cp_bwd": lidar_steps * mcfg.train_point_chunks + cam_steps * chunks,
        "pdf_sample": lidar_steps + cam_steps})
    attach = json.loads((out_dir / "camera_slam" / "camera_attach.json").read_text())
    n_img = sum(1 for k in kfs if k.image is not None)
    windows = [{"ms": dt * 1e3, "iterations": it, "its_per_s": it / dt} for dt, it in mapper.window_timer.rows]
    print(f"camera leg: {len(frames)} frames in {wall_s:.1f} s; keyframes at {[k.timestamp for k in kfs]}, "
          f"{n_img} with images; images attached {attach['attached']}, dropped {attach['dropped']}; "
          f"{lidar_steps} lidar steps (schedule {expected_lidar}), {cam_steps} camera steps (expected {expected_cam}) "
          f"of {n_rays} rays x {mcfg.n_samples_train} samples in {chunks} point chunks", flush=True)
    if n_img < 3 or lidar_steps != expected_lidar or cam_steps != expected_cam or int(mapper.state.skipped_steps):
        raise AssertionError(f"camera leg: {n_img} keyframes with images, {lidar_steps} lidar and {cam_steps} "
                             f"camera steps, {int(mapper.state.skipped_steps)} skipped")

    # the trained intensity branch against a fresh one, on the same rays and samples
    state = mapper.state
    img_kfs = [k for k in kfs if k.image is not None][:cfg.mapper.keyframe_manager.window_size]
    win = cam.stack_camera_window(np.stack([k.image for k in img_kfs]), np.ones((len(img_kfs), height, width), bool),
                                  np.stack([mapper.optimized_pose(k) @ t_lc for k in img_kfs]), K, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    n_eval = 2048
    bi, yi, xi = (torch.randint(0, m, (n_eval,), generator=gen, device=dev) for m in (len(img_kfs), height, width))
    with torch.no_grad():
        bundle, target = cam._sample_camera_rays(win, mapper.cube, mcfg, bi, yi, xi)
        z = sampling.occ_grid_sampler_z_vals(bundle, state.occ_grid, mcfg.n_samples_train, 0.0, None, torch.rand(
            (n_eval, mcfg.n_samples_train // 2), generator=gen, device=dev))

        def cam_l1(params):
            render = rendering.render_rays(params, bundle, z, mcfg.nerf, sigma_only=False)
            return float(losses.compute_camera_loss(render, target, bundle.valid, mcfg.loss)[1]["cam_l1"])

        fresh = nerf.init_nerf(torch.Generator(device=dev).manual_seed(123), mcfg.nerf, dev)["intensity"]
        l1_trained = cam_l1(state.params)
        l1_fresh = cam_l1({"sigma": state.params["sigma"], "intensity": fresh})
    print(f"camera leg: masked camera L1 {l1_trained:.4f} trained, {l1_fresh:.4f} fresh "
          f"(ratio {l1_trained / l1_fresh:.3f}, gate 0.8)", flush=True)
    if not (math.isfinite(l1_trained) and l1_trained < 0.8 * l1_fresh):
        raise AssertionError(f"camera leg: trained L1 {l1_trained} not under 0.8x the fresh {l1_fresh}")

    # a camera step: host-clock ms after synchronize, then a profile
    step = cam.make_camera_train_step(mcfg, mapper.cube, n_rays, device=dev,
                                      generator=torch.Generator(device=dev).manual_seed(1))
    box, times, step_losses = {"state": state}, [], []

    def run_once():
        box["state"], aux = step(box["state"], win)
        return aux

    for _ in range(6):
        t = time.perf_counter()
        aux = run_once()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        step_losses.append(float(aux["loss"]))
    step_ms = sum(times[1:]) / len(times[1:])
    if not all(math.isfinite(x) for x in step_losses):
        raise AssertionError(f"camera leg: non-finite camera loss {step_losses}")
    prof = _profile(run_once, 5, step_ms, out_dir / "camera_step_profile.txt", "camera step")
    print(f"camera leg: a camera step {step_ms:.3f} ms (host clock, synchronized; first {times[0]:.1f} ms), "
          f"device busy {prof['busy_ms']:.3f} ms; losses {step_losses}", flush=True)

    # B1-B3 on the inputs one camera step gives them
    cp_in, bwd_in, pdf_in = {}, {}, {}
    with _first_inputs(cp_kernel, "cp_fwd", cp_in), _first_inputs(cp_kernel, "cp_bwd", bwd_in), \
            _first_inputs(sampling, "pdf_sample", pdf_in):
        step(box["state"], win)
    met = _check_met_inputs("camera leg", cp_in, pdf_in, bwd_in)
    del cp_in, bwd_in, pdf_in

    # one camera step on the card and on the CPU from one state, the same draws
    versus = _camera_card_vs_cpu(mcfg, mapper.cube, box["state"], win, n_rays, dev)
    res = {"setup_s": setup_s, "wall_s": wall_s, "image_size": [height, width], "keyframes": [k.timestamp for k in kfs],
           "keyframes_with_images": n_img, "attach": attach, "lidar_steps": lidar_steps, "camera_steps": cam_steps,
           "point_chunks": chunks, "launches": launches, "windows": windows, "l1_trained": l1_trained,
           "l1_fresh": l1_fresh, "camera_step_ms": step_ms, "camera_step_ms_all": times, "camera_step_profile": prof,
           "kernels_on_met_inputs": met, "card_vs_cpu": versus}
    del slam, mapper, state, box, win
    shutil.rmtree(out_dir / "camera_slam" / "checkpoints")
    torch.cuda.empty_cache()
    return res


def _field_launches(n_points: int, point_chunks: int) -> int:
    """B1 launches of one render chunk's field pass of one branch: one per
    point chunk where they divide the points, else one."""
    return point_chunks if point_chunks > 1 and n_points % point_chunks == 0 else 1


# A render chunk of 1024 rays at 2048 samples, card against CPU: each device
# sums 2048 samples' terms and transmittance factors in another order, and in
# the whole render also builds its own rays and OGM samples, ulps apart.
# Fifteen readings of each, five poses in each of three full runs (NVIDIA
# H100 80GB HBM3, 700.00 W): the whole render 7.79e-6 to 2.020e-5 relative,
# from the same rays and samples 1.91e-6 to 6.868e-6. Bounds: four times the
# largest of the fifteen.
CHUNK_BOUND = 4 * 2.020e-5
SAME_SAMPLES_BOUND = 4 * 6.868e-6


def _map_tools_leg(root: Path, out_dir: Path, wrappers, dev) -> dict:
    """3g, the map tools and the debug dumps as a user runs them, on the CLI
    drive's run directory (chiprun_out/cli_run: cfg/defaults.yaml, 1100
    steps over the 36-pose loop at 32 x 512 returns) and its sequence:

    - ``render_map lidar`` and ``render_map mesh`` (resolution 128, level
      0.1) over trajectory/estimated_trajectory.txt with ``--skip-step 4``
      (9 poses), called in-process as ``main(argv)``;
    - ``render_camera_image`` at 640 x 360 with the intensity branch and
      the peak-consistency map, and once with the adjusted compositing;
    - ``compute_metrics traj`` (equal to ate.yaml's rmse within 1e-9) and
      ``compute_metrics map`` (the rendered cloud against the world points of
      the sequence's own scans at the 9 poses: accuracy, completion,
      F-score), ``summarize_results`` over chiprun_out/ (its cli_run row
      equal to ate.yaml);
    - ``SyntheticSensorService.from_run_dir`` at the last of the 9 poses
      (equal to ``render_lidar_scan`` there) and one ``SensorClient`` round
      trip on 127.0.0.1;
    - the quality gate: the median |rendered - recorded depth| of the
      virtual scan at the last of the 9 poses under 1.15 m;
    - B1 and B3 against their plain versions on the first inputs they met
      in the lidar render, and a render chunk of 1024 rays at the yaml's
      2048 samples on the card against the CPU from one state and the same
      uniforms at five poses: the whole render (``CHUNK_BOUND``) and from
      the CPU's rays and samples (``SAME_SAMPLES_BOUND``), depth relative;
    - ``run_slam`` over the first 12 scans of the CLI drive's sequence with
      ``debug.global_enabled`` and all four draw flags (``_debug_run``).

    Every launch count is set to 0 just before each part and read just
    after: per render chunk of N rays and S samples B1 once per field point
    chunk and branch (intensity too when colours are rendered), B3 once
    (OGM); B2, B4 and B5 never."""
    import numpy as np
    import yaml
    from scipy.spatial import cKDTree

    from loner_tpu_torch import compute_metrics, render_map, summarize_results
    from loner_tpu_torch.analysis.renderer import render_camera_image, render_lidar_scan
    from loner_tpu_torch.data import synthetic
    from loner_tpu_torch.data.dataset import SequenceDataset
    from loner_tpu_torch.geometry.rays import build_lidar_rays
    from loner_tpu_torch.mapping.optimizer import tree_map
    from loner_tpu_torch.models import sampling
    from loner_tpu_torch.models.rendering import render_rays
    from loner_tpu_torch.ops import cp_kernel
    from loner_tpu_torch.runtime.run_io import load_run
    from loner_tpu_torch.runtime.trajectory_logger import dump_tum, load_tum
    from loner_tpu_torch.sim.synthetic_sensors import SensorClient, SensorServer, SyntheticSensorService

    run_dir, seq_dir, leg_dir = out_dir / "cli_run", out_dir / "cli_seq", out_dir / "map_tools"
    leg_dir.mkdir(exist_ok=True)
    traj = str(run_dir / "trajectory" / "estimated_trajectory.txt")
    poses, ts = load_tum(traj)
    selected = np.arange(len(poses))[::4]
    cfg, cube, state = load_run(str(run_dir), device=dev)
    ogm = cfg.samples_strategy == "OGM"
    pc = cfg.nerf.point_chunks
    n_scan, n_mesh, chunk = 32 * 512, 32 * 256, 16384

    def render_launches(n_rays: int, n_samples: int, branches: int = 1) -> dict:
        sizes = [min(chunk, n_rays - s) for s in range(0, n_rays, chunk)]
        return {"cp_fwd": sum(branches * _field_launches(m * n_samples, pc) for m in sizes),
                "pdf_sample": len(sizes) if ogm else 0}

    def add(*ds):
        return {k: sum(d.get(k, 0) for d in ds) for k in PATH_KERNELS}

    parts, launches = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def part(name, expected, fn):
        for w in wrappers:
            w.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = {"s": time.perf_counter() - t0}
        launches[name] = _check_launches(f"map tools leg, {name}", wrappers, expected)
        return out

    # render_map lidar, with B1 and B3 recorded on the first inputs they meet
    cp_in, pdf_in = {}, {}
    cloud_path = leg_dir / "cloud.pcd"
    with _first_inputs(cp_kernel, "cp_fwd", cp_in), _first_inputs(sampling, "pdf_sample", pdf_in):
        lidar = part("render_map lidar", add(*[render_launches(n_scan, cfg.n_samples_test)] * len(selected)),
                     lambda: render_map.main(["lidar", "--run", str(run_dir), "--poses", traj, "--skip-step", "4",
                                              "--out", str(cloud_path)]))
    met = _check_met_inputs("map tools leg", cp_in, pdf_in)
    want = {("cp_fwd", n_scan * cfg.n_samples_test // pc), ("pdf_sample", n_scan, cfg.n_samples_test // 2)}
    seen = {("cp_fwd", r["points"]) if r["kernel"] == "cp_fwd" else ("pdf_sample", r["rays"], r["draws"]) for r in met}
    if not want <= seen:
        raise AssertionError(f"map tools leg: kernel inputs met {sorted(seen)}, expected at least {sorted(want)}")
    del cp_in, pdf_in

    mesh = part("render_map mesh", add(*[render_launches(n_mesh, cfg.n_samples_train)] * len(selected)),
                lambda: render_map.main(["mesh", "--run", str(run_dir), "--poses", traj, "--skip-step", "4",
                                         "--resolution", "128", "--level", "0.1", "--out", str(leg_dir / "mesh.ply")]))

    # one virtual scan and the camera images, timed; the colours take the
    # intensity branch too (B1 for its lines)
    pose = poses[selected[-1]]
    dataset = SequenceDataset(str(seq_dir))
    scan_ts = np.asarray([dataset.load_scan(i)[1] for i in range(len(dataset))])
    scan_idx = [int(np.argmin(np.abs(scan_ts - t))) for t in ts[selected]]  # the scans at the 9 poses
    scan = part("virtual scan", render_launches(n_scan, cfg.n_samples_test),
                lambda: render_lidar_scan(cfg, cube, state, pose))
    height, width = 360, 640
    K = np.array([[width / 2, 0, width / 2], [0, width / 2, height / 2], [0, 0, 1.0]])
    images = {}
    for name, kw in (("camera image", dict(peak_consistency=True)), ("camera image, adjusted",
                                                                     dict(render_strategy="adjusted"))):
        images[name] = part(name, render_launches(height * width, cfg.n_samples_test, 2),
                            lambda: render_camera_image(cfg, cube, state, pose, K, height, width, rgb=True, **kw))
        img = images[name]
        if not all(np.all(np.isfinite(v)) for v in img.values()) or img["rgb"].shape != (height, width, cfg.nerf.num_colors):
            raise AssertionError(f"map tools leg: {name}: non-finite or misshapen maps")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # the quality gate: the virtual scan against the recorded scan at its pose
    rec, _ = dataset.load_scan(scan_idx[-1])
    rec_dirs = np.asarray(rec.ray_directions)[np.asarray(rec.valid)]
    rec_dist = np.asarray(rec.distances)[np.asarray(rec.valid)]
    d_match, idx = cKDTree(scan["directions"]).query(rec_dirs)
    if not d_match.max() < 1e-5:
        raise AssertionError(f"map tools leg: recorded directions off the virtual scan's by {d_match.max()}")
    depth_err = np.abs(scan["depth"][idx] - rec_dist)
    median_err = float(np.median(depth_err))

    # the metrics: the trajectory against the sequence's ground truth from
    # its first pose (what ate.yaml holds) and against the logger's
    # groundtruth.txt (interpolated at the scans' stamps), the cloud against
    # the scans' world points
    ate = yaml.safe_load((run_dir / "ate.yaml").read_text())
    gt_rel = np.linalg.inv(dataset.gt_poses[0])[None] @ dataset.gt_poses
    dump_tum(gt_rel, dataset.gt_times, str(leg_dir / "gt_rel.txt"))
    traj_m = compute_metrics.main(["traj", "--est", traj, "--gt", str(leg_dir / "gt_rel.txt")])
    traj_logged = compute_metrics.main(["traj", "--est", traj, "--gt", str(run_dir / "trajectory" / "groundtruth.txt")])
    world = []
    for i in scan_idx:
        s_i, _ = dataset.load_scan(i)
        v = np.asarray(s_i.valid)
        pts = np.asarray(s_i.ray_directions)[v] * np.asarray(s_i.distances)[v, None]
        world.append(pts @ gt_rel[i, :3, :3].T + gt_rel[i, :3, 3])
    np.save(leg_dir / "scans_world.npy", np.concatenate(world))
    map_m = compute_metrics.main(["map", "--est", str(cloud_path), "--gt", str(leg_dir / "scans_world.npy")])
    summary = summarize_results.main([str(out_dir)])

    # the simulator: the service at the last pose, and one loopback round trip
    def serve():
        svc = SyntheticSensorService.from_run_dir(str(run_dir), device=dev)
        server = SensorServer(svc).start()
        client = SensorClient(*server.address)
        try:
            return svc.lidar_scan(pose), client.lidar(pose)
        finally:
            client.close()
            server.stop()

    sim, resp = part("sensor service", add(*[render_launches(n_scan, cfg.n_samples_test)] * 2), serve)
    sim_err = float(np.max(np.abs(sim["depth"] - scan["depth"])))
    keep_diff = int(np.sum(sim["keep"] != scan["keep"]))

    # one render chunk of 1024 rays at full samples, the card against the
    # CPU from one state and the same uniforms, at five of the poses: the
    # whole render (each device builds its rays and samples) and the field
    # and compositing from the CPU's rays and samples
    dirs = synthetic.spinning_lidar_directions(32, 32)
    cpu_state, cpu_cube = tree_map(lambda x: x.cpu(), state), cube.to("cpu")

    def rel(card, cpu):  # metric depths, relative to at least 1 m
        return float(torch.max(torch.abs(card - cpu) / torch.clamp(torch.abs(cpu), min=1.0)))

    chunk_err = {"whole": [], "same_samples": []}
    for k, i in enumerate(selected[:5]):
        u = torch.rand((len(dirs), cfg.n_samples_test // 2), generator=torch.Generator().manual_seed(k))
        depth = {name: torch.as_tensor(render_lidar_scan(cfg, cube, st, poses[i], n_channels=32, n_azimuth=32,
                                                         u_pdf=u)["depth"]) for name, st in (("card", state),
                                                                                             ("cpu", cpu_state))}
        chunk_err["whole"].append(rel(depth["card"], depth["cpu"]))
        with torch.no_grad():
            b = build_lidar_rays(torch.as_tensor(dirs, dtype=torch.float32), torch.zeros(len(dirs)),
                                 torch.as_tensor(poses[i], dtype=torch.float32), cpu_cube, cfg.ray_range)
            z = sampling.occ_grid_sampler_z_vals(b, cpu_state.occ_grid, cfg.n_samples_test, 0.0, None, u)
            d_cpu = render_rays(cpu_state.params, b, z, cfg.nerf).depth
            d_card = render_rays(state.params, type(b)(*(t.to(dev) for t in b)), z.to(dev), cfg.nerf).depth.cpu()
        chunk_err["same_samples"].append(rel(d_card * cfg.world_scale, d_cpu * cfg.world_scale))
    del cpu_state

    debug = _debug_run(root, out_dir, wrappers, dev)
    res = {"poses": selected.tolist(), "parts": parts, "launches": launches, "peak_mem_gib": peak_gib,
           "cloud_points": lidar["points"], "mesh": mesh, "scan_ms": parts["virtual scan"]["s"] * 1e3,
           "image_ms": {k: parts[k]["s"] * 1e3 for k in images}, "median_depth_err_m": median_err,
           "depth_err_percentiles_m": [float(x) for x in np.percentile(depth_err, [10, 50, 90])],
           "kept_share": float(scan["keep"].mean()), "traj": traj_m, "traj_groundtruth_txt": traj_logged,
           "ate_yaml": ate, "map": map_m,
           "summary_cli_run": summary.get("cli_run"), "sensor_vs_render": sim_err, "sensor_keep_diff": keep_diff,
           "sensor_response_points": resp["depth_summary"]["n_points"], "chunk_card_vs_cpu": chunk_err,
           "kernels_on_met_inputs": met, "debug_run": debug}
    print(f"map tools leg: render_map lidar {parts['render_map lidar']['s']:.2f} s for {len(selected)} scans "
          f"({lidar['points']} points); a virtual scan {res['scan_ms']:.1f} ms, a 640 x 360 image "
          f"{res['image_ms']['camera image']:.1f} ms (adjusted {res['image_ms']['camera image, adjusted']:.1f} ms), "
          f"host clock, synchronized; mesh {mesh['vertices']} vertices, {mesh['faces']} faces in "
          f"{parts['render_map mesh']['s']:.2f} s (render {mesh['timings']['render_s']:.2f}, splat "
          f"{mesh['timings']['splat_s']:.3f}, surface nets {mesh['timings']['surface_nets_s']:.2f}); peak memory "
          f"{peak_gib:.2f} GiB; median depth error at pose {int(selected[-1])} {median_err:.4f} m (gate 1.15), "
          f"kept {res['kept_share']:.3f}; ATE {traj_m['ate']['rmse']!r} m (ate.yaml {ate['rmse']!r}; against "
          f"groundtruth.txt {traj_logged['ate']['rmse']!r}); map "
          f"accuracy {map_m['accuracy']:.4f} m, completion {map_m['completion']:.4f} m, F-score "
          f"{map_m['f_score']:.4f}; sensor service against the render {sim_err:.3e} (keep differs on {keep_diff}), "
          f"{resp['depth_summary']['n_points']} points over the loopback; a 1024-ray chunk at "
          f"{cfg.n_samples_test} samples, card against CPU, depth relative at five poses: whole render "
          f"{['%.3e' % x for x in chunk_err['whole']]} (bound {CHUNK_BOUND:.3e}), from the same rays and samples "
          f"{['%.3e' % x for x in chunk_err['same_samples']]} (bound {SAME_SAMPLES_BOUND:.3e})", flush=True)
    if not median_err < 1.15:
        raise AssertionError(f"map tools leg: median depth error {median_err:.4f} m, at or over 1.15 m")
    if abs(traj_m["ate"]["rmse"] - ate["rmse"]) > 1e-9:
        raise AssertionError(f"map tools leg: compute_metrics ATE {traj_m['ate']['rmse']} against ate.yaml {ate['rmse']}")
    if summary.get("cli_run", {}).get("ate_rmse", (None,))[0] != ate["rmse"]:
        raise AssertionError(f"map tools leg: summarize_results' cli_run row {summary.get('cli_run')}")
    if not (sim_err <= 1e-6 * 40 and keep_diff == 0 and resp["depth_summary"]["n_points"] == int(sim["keep"].sum())):
        raise AssertionError(f"map tools leg: the sensor service differs from the render: {sim_err}, {keep_diff}")
    if not (max(chunk_err["whole"]) <= CHUNK_BOUND and max(chunk_err["same_samples"]) <= SAME_SAMPLES_BOUND):
        raise AssertionError(f"map tools leg: a render chunk on the card and the CPU differ by {chunk_err}")
    if not (mesh["vertices"] > 0 and mesh["faces"] > 0 and lidar["points"] > 0):
        raise AssertionError(f"map tools leg: empty cloud or mesh: {lidar}, {mesh}")
    if not all(math.isfinite(map_m[k]) for k in ("accuracy", "completion", "f_score")):
        raise AssertionError(f"map tools leg: map metrics {map_m}")
    for f in ("cloud.pcd", "mesh.ply", "scans_world.npy", "gt_rel.txt"):
        (leg_dir / f).unlink()
    del state
    torch.cuda.empty_cache()
    return res


def _debug_run(root: Path, out_dir: Path, wrappers, dev) -> dict:
    """``run_slam.run_trial`` over the first 12 scans of the CLI drive's
    sequence (chiprun_out/cli_seq: the 36-pose loop of period 7.2 s, 10
    degrees and 0.87 m a frame, 32 x 512 returns), cfg/defaults.yaml as
    there, with ``debug.global_enabled`` and the four draw flags on. Every
    launch count is set to 0 just before and read just after: B1-B3 once
    per train step, and B1 (once per train point chunk) and B3 once more per
    window, for its probe. Fails on an ATE of 0.35 m or more (the CLI
    drive's gate: the dumps must come from a run that tracked), or unless
    every file tests/test_debug_dumps.py::test_debug_dumps_land_in_run_dir
    expects is under debug/: each registration's ICP clouds, each window's
    ray and sample clouds and loss distribution. The run directory is
    deleted after the check (a window's sample cloud holds every sample of
    a train step)."""
    import glob

    import numpy as np

    from loner_tpu_torch import run_slam
    from loner_tpu_torch.config.build import build_mapper_config
    from loner_tpu_torch.config.settings import load_settings
    from loner_tpu_torch.data.dataset import SequenceDataset
    from loner_tpu_torch.runtime.debug_dump import read_pcd

    run_dir = out_dir / "debug_run"
    settings = load_settings(str(root / "cfg" / "defaults.yaml"), overrides={
        "data": {"ray_range": [1, 40], "scan_points_budget": 16384, "sky_points_budget": 4096},
        "tracker": {"motion_compensation": {"enabled": False}},
        "debug": {"global_enabled": True, "flags": {"draw_icp_clouds": True, "draw_rays": True,
                                                    "draw_samples": True, "draw_loss_distribution": True}},
    })
    dataset = SequenceDataset(str(out_dir / "cli_seq"), pad_to=16384)
    dataset.files = dataset.files[:12]
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    ate = run_slam.run_trial(settings, dataset, str(run_dir), use_gt=False, device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    timing = np.atleast_2d(np.loadtxt(run_dir / "timing.csv", delimiter=",", skiprows=1))
    steps, windows = int(timing[:, 1].sum()), len(timing)
    tpc = build_mapper_config(settings, 1.0).train_point_chunks
    launches = _check_launches("map tools leg, debug run", wrappers, {
        "cp_fwd": tpc * (steps + windows), "cp_bwd": tpc * steps, "pdf_sample": steps + windows})
    dbg = run_dir / "debug"
    frames = sorted(glob.glob(str(dbg / "frame_*")))
    missing = [f"{f}/{n}" for f in frames for n in ("icp_input.pcd", "icp_aligned.pcd", "icp_target.pcd")
               if not os.path.exists(os.path.join(f, n))]
    kf_dirs = sorted(glob.glob(str(dbg / "keyframe_*")))
    missing += [f"{d}/{n}" for d in kf_dirs for n in ("ray_origins.pcd", "ray_endpoints.pcd", "sample_points.pcd",
                                                       "loss_distribution.npz")
                if not os.path.exists(os.path.join(d, n))]
    if len(frames) != len(dataset) - 1 or len(kf_dirs) != windows or missing:
        raise AssertionError(f"debug run: {len(frames)} frame dumps for {len(dataset)} scans, {len(kf_dirs)} window "
                             f"dumps for {windows} windows, missing {missing}")
    rays = read_pcd(os.path.join(kf_dirs[0], "ray_endpoints.pcd"))
    z = np.load(os.path.join(kf_dirs[0], "loss_distribution.npz"))
    n_samples = sum(1 for _ in open(os.path.join(kf_dirs[0], "sample_points.pcd"))) - 11
    ok = (rays.shape[1] == 4 and np.linalg.norm(rays[:, :3], axis=1).max() < 100.0 and n_samples > 100
          and {"depth_err_m", "js", "los", "valid"} <= set(z.files)
          and np.isfinite(z["depth_err_m"][z["valid"] > 0]).all())
    res = {"wall_s": wall_s, "scans": len(dataset), "ate_rmse": ate, "train_steps": steps, "windows": windows, "launches": launches,
           "frame_dumps": len(frames), "window_dumps": len(kf_dirs), "endpoints": len(rays),
           "sample_points": n_samples, "loss_distribution_png": os.path.exists(os.path.join(kf_dirs[0],
                                                                                           "loss_distribution.png"))}
    print(f"map tools leg, debug run: {len(dataset)} scans in {wall_s:.1f} s, ATE rmse {ate:.4f} m (gate 0.35), "
          f"{steps} train steps in {windows} "
          f"windows; {len(frames)} ICP cloud dumps, {len(kf_dirs)} window dumps ({len(rays)} ray endpoints, "
          f"{n_samples} sample points, png {res['loss_distribution_png']})", flush=True)
    if not ok:
        raise AssertionError(f"debug run: the window dump is malformed: {res}")
    if not ate < 0.35:
        raise AssertionError(f"debug run: ATE {ate:.4f} m, at or over the 0.35 m gate")
    shutil.rmtree(run_dir)
    return res


ENCODERS = ("exact", "packed", "cell")  # the alternate hash encoders of leg 3h
HARVESTER_BOX = ((4.0, 0.0, -1.0), (3.0, 3.0, 2.0))  # a machine 2.5-5.5 m ahead of the sensor (centre, size)


def _corner_ties(w: torch.Tensor, u: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """(L, N) bool: the (level, point) pairs whose corner draw ``u >
    cumsum(w)`` (w (L, 8, N), u (L, N)) turns on a uniform within ``tol`` of
    the CDF, which two devices summing in other orders may decide an ulp
    apart."""
    cdf = torch.cumsum(w.double(), dim=1)
    return torch.any((cdf - u.double()[:, None, :]).abs() <= tol, dim=1)


def _encoders_card_vs_cpu(pts: torch.Tensor) -> dict:
    """Each alternate encoder and backward mode at the flagship's sigma
    config (16 levels x 2 features, 2^18 vertices; CellHash 2^16 cells) on
    one keyframe's sampled points (576 rays x 512 samples), the same O(1)
    table, cotangent and corner uniforms on the card and the CPU: the forward
    within 1e-6 and the point gradient within 1e-5 of their largest entry;
    the table gradient, summed by atomics on the card in a varying order
    (up to thousands of terms an entry at the coarse levels), within 1e-5
    normwise (its largest error against its largest entry, which reaches
    1e-5, is reported). The tied (level, point)
    pairs of a corner-sampled mode get a zero cotangent on both devices.
    The card's fwd + bwd ms of each mode beside."""
    from loner_tpu_torch.models.hash_encoding import HashEncodingConfig, hash_encode_t
    from loner_tpu_torch.models.nerf import cell_config_from
    from loner_tpu_torch.ops import cell_hash as ch
    from loner_tpu_torch.ops import hash_encode_fast as hf

    dev = pts.device
    pts_cpu = pts.cpu()
    enc = HashEncodingConfig()
    l, n = enc.n_levels, pts.shape[1]
    gen = torch.Generator().manual_seed(11)
    hash_table = torch.rand((l, 2, enc.table_size), generator=gen) * 2 - 1
    c_exact, c_l1 = cell_config_from(enc, "exact"), cell_config_from(enc, "level1")
    cell_table = torch.rand((l, c_exact.table_size, 16), generator=gen) * 2 - 1
    u = torch.rand((l, n), generator=gen)

    def level1_ties(p):  # (1, N): the points whose chosen level's draw ties
        choice = ch._jitter_level_choice(p, l)
        scaled = p * torch.as_tensor(c_l1.level_scales().astype("float32"))[choice][None] + 0.5
        return _corner_ties(ch._trilinear_w(scaled - torch.floor(scaled))[None], u[:1])

    modes = {  # name -> (table, encode(table, pts, u), tied (L, N) pairs or (1, N) points, or None)
        "exact": (hash_table, lambda t, p, u: hash_encode_t(t, p, enc), None),
        "packed": (hash_table, lambda t, p, u: hf.hash_encode_packed_t(t, p, enc), None),
        "packed_corner": (hash_table, lambda t, p, u: hf.hash_encode_packed_t(t, p, enc, u=u),
                          _corner_ties(hf._fused_indices(pts_cpu, enc)[1], u)),
        "cell_exact": (cell_table, lambda t, p, u: ch.cell_hash_encode_t(t, p, c_exact), None),
        "cell_level1": (cell_table, lambda t, p, u: ch.cell_hash_encode_t(t, p, c_l1), None),
        "cell_level1_corner": (cell_table, lambda t, p, u: ch.cell_hash_encode_t(t, p, c_l1, u=u),
                               level1_ties(pts_cpu)),
    }
    rows = {}
    for name, (table, fn, ties) in modes.items():
        g = torch.randn((l, 2, n), generator=gen)
        if ties is not None:
            g = torch.where(ties[:, None, :], torch.zeros(()), g)
        g = g.reshape(2 * l, n)
        # the CPU once; the card three times (its scatters' atomics sum in
        # a varying order): the largest error of the three is held
        errs = {"forward": 0.0, "d_table": 0.0, "d_pts": 0.0, "d_table_normwise": 0.0}
        ref = None
        for d in (torch.device("cpu"), dev, dev, dev):
            t = table.to(d).clone().requires_grad_(True)
            p = pts_cpu.to(d).clone().requires_grad_(True)
            out = fn(t, p, u.to(d))
            torch.sum(out * g.to(d)).backward()
            got = [x.detach().cpu() for x in (out, t.grad, p.grad)]
            del t, p, out
            if ref is None:
                ref = got
                continue
            for k, a, b in zip(errs, got, ref):
                errs[k] = max(errs[k], float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
            errs["d_table_normwise"] = max(errs["d_table_normwise"], _rel(got[1], ref[1]))
        del ref, got
        t_card, p_card = table.to(dev).clone().requires_grad_(True), pts.detach().clone().requires_grad_(True)
        g_card, u_card = g.to(dev), u.to(dev)

        def fwd_bwd():
            torch.sum(fn(t_card, p_card, u_card) * g_card).backward()

        ms = _event_ms(fwd_bwd, 3, 1)
        rows[name] = {"max_err_share": errs, "tied": 0 if ties is None else int(ties.sum()), "card_fwd_bwd_ms": ms,
                      "ok": errs["forward"] <= 1e-6 and errs["d_table_normwise"] <= 1e-5 and errs["d_pts"] <= 1e-5}
        del t_card, p_card, g_card, u_card
        torch.cuda.empty_cache()
    print("leg 3h, the encoders on the card against the CPU (" + f"{n} points; max abs error / largest entry, "
          "d_table also normwise): "
          + "; ".join(f"{k}: fwd {r['max_err_share']['forward']:.2e}, d_table {r['max_err_share']['d_table']:.2e} "
                      f"({r['max_err_share']['d_table_normwise']:.2e} normwise), "
                      f"d_pts {r['max_err_share']['d_pts']:.2e}, tied {r['tied']}, fwd+bwd "
                      f"{r['card_fwd_bwd_ms']:.2f} ms" for k, r in rows.items()), flush=True)
    bad = {k: r for k, r in rows.items() if not r["ok"]}
    if bad:
        raise AssertionError(f"leg 3h: an encoder on the card and the CPU differ: {bad}")
    return rows


def _cell_offline(forest, wrappers, dev) -> dict:
    """The offline FDT leg of 3d on its keyframes with the CellHash field
    (scripts/exp_encoder_flagship.py's "cell" encoder), cut to 3 epochs: no
    skipped step, the last epoch's held-out L1 under 0.8x the first's, B3
    once per step and eval render and no other kernel."""
    from loner_tpu_torch.mapping.offline import OfflineConfig, optimize_implicit_map

    kfs, cube, ray_range, _ = forest
    cfg = _offline_cfg(cube, ray_range)
    cfg = cfg._replace(nerf=cfg.nerf._replace(encoding_impl="cell"))
    offline = OfflineConfig(window_size=16, iterations_per_window=32, max_epochs=3, n_eval_scans=6,
                            eval_rays_per_scan=1024)
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    result = optimize_implicit_map(cfg, cube, kfs, offline, device=dev, log_fn=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    renders = offline.n_eval_scans * result.epochs_run
    launches = _check_launches("leg 3h, cell offline", wrappers, {"pdf_sample": result.iterations + renders})
    l1 = result.l1_history
    res = {"l1_history_m": l1, "epochs": result.epochs_run, "iterations": result.iterations,
           "train_s": result.wall_time_s - result.eval_time_s, "eval_s": result.eval_time_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
           "skipped_steps": int(result.state.skipped_steps)}
    print(f"leg 3h, cell offline: L1 history {[round(x, 4) for x in l1]} m over {result.epochs_run} epochs, "
          f"{result.iterations} steps; training {res['train_s']:.1f} s, eval {res['eval_s']:.1f} s; peak memory "
          f"{res['peak_mem_gib']:.2f} GiB", flush=True)
    if res["skipped_steps"] or not all(math.isfinite(x) for x in l1) or not l1[-1] < 0.8 * l1[0]:
        raise AssertionError(f"leg 3h, cell offline: L1 history {l1}, {res['skipped_steps']} steps skipped "
                             "(gate: the last under 0.8x the first, none skipped)")
    del result
    torch.cuda.empty_cache()
    return res


def _native_prep(out_dir: Path) -> dict:
    """The data prep's host library: built with g++ (it must build and load),
    each of its five functions against its numpy path on one Ouster-size
    sweep (128 x 1024 returns, BagConversionConfig's topic /os_cloud_node/points)
    with both paths timed, and ``scan_from_arrays`` with the harvester box."""
    import numpy as np

    from loner_tpu_torch.data import rosbag_convert as rb
    from loner_tpu_torch.data import synthetic
    from loner_tpu_torch.runtime import native

    found = (native._lib_dir() / native._LIB_NAME).exists()  # built by an earlier run in this checkout
    t0 = time.perf_counter()
    native.build_native()
    build_s = time.perf_counter() - t0
    (out_dir / "native_build.log").write_text(native.build_log)
    if not native.has_native():
        raise AssertionError(f"leg 3h: the native library did not build or load: {native.build_log}")
    scene = synthetic.Scene.default()
    pose = synthetic.circular_trajectory(n_poses=4, radius=6.0)[0][0]
    dirs, dists, stamps, hit = synthetic.simulate_scan(scene, pose, 0.0, n_channels=128, n_azimuth=1024,
                                                       max_range=60.0, rng=np.random.default_rng(3), noise_std=0.01)
    ranges = np.where(hit, dists, 0.0).astype(np.float32)  # an Ouster reports 0 for no return
    pts = dirs * ranges[:, None]
    cases = {
        "extract_cloud": (pts, stamps, hit, 0.9, 16384),
        "voxel_downsample": (pts[hit], 0.2),
        "box_filter": (pts, hit, *HARVESTER_BOX),
        "range_filter": (ranges, hit, 1.0, 40.0),
        "spherical_occupancy": (dirs, hit, 1024, 128, -math.pi / 6, math.pi / 2),
    }
    rows = {}
    for name, args in cases.items():
        lib_fn, np_fn = getattr(native, name), getattr(native, f"{name}_np")
        lib, ref = lib_fn(*args), np_fn(*args)
        equal = all(np.array_equal(a, b) for a, b in zip(lib if isinstance(lib, tuple) else (lib,),
                                                          ref if isinstance(ref, tuple) else (ref,)))

        def wall_ms(fn, reps=5):
            times = []
            for _ in range(reps):
                t = time.perf_counter()
                fn(*args)
                times.append((time.perf_counter() - t) * 1e3)
            return float(np.median(times))

        rows[name] = {"equal": equal, "library_ms": wall_ms(lib_fn), "numpy_ms": wall_ms(np_fn)}
    t = time.perf_counter()
    times = rb.fusion_portable_times(len(pts), 1024, 0.0)
    dirs_out, dist_out, t_out = rb.scan_from_arrays(pts.astype(np.float64), times, rb.BagConversionConfig(
        remove_box_center=HARVESTER_BOX[0], remove_box_size=HARVESTER_BOX[1]))
    scan_ms = (time.perf_counter() - t) * 1e3
    in_box = int((hit & ~native.box_filter_np(pts, hit, *HARVESTER_BOX)).sum())
    res = {"build_s": build_s, "found_built": found, "points": len(pts), "returns": int(hit.sum()), "functions": rows,
           "scan_from_arrays": {"kept": len(dist_out), "in_box": in_box, "ms": scan_ms}}
    print(f"leg 3h, data prep: native library {'found built' if found else 'built'} in {build_s:.2f} s; on a "
          f"128 x 1024 sweep ({int(hit.sum())} "
          "returns), library ms / numpy ms: " + ", ".join(
              f"{k} {r['library_ms']:.3f} / {r['numpy_ms']:.3f} ({'equal' if r['equal'] else 'DIFFER'})"
              for k, r in rows.items())
          + f"; scan_from_arrays with the harvester box kept {len(dist_out)} of {int(hit.sum())} returns "
          f"({in_box} in the box) in {scan_ms:.1f} ms", flush=True)
    if not all(r["equal"] for r in rows.values()):
        raise AssertionError(f"leg 3h: the native library and the numpy path differ: {rows}")
    if not (len(dist_out) == int(hit.sum()) - in_box and np.all(np.diff(t_out) >= 0)
            and np.allclose(np.linalg.norm(dirs_out, axis=1), 1.0, atol=1e-5) and dist_out.min() >= 0.3):
        raise AssertionError("leg 3h: scan_from_arrays kept the wrong returns")
    return res


def _encoders_reduced(dev, joint) -> dict:
    """Phase 4 for the alternate encoders: one reduced-depth step on the card
    and the CPU, as the FusedHash one (tables scaled to 0.1, the L2
    selection). Their finest cells are as fine as FusedHash's, so the whole
    step is reported and the field from the same rays and samples held."""
    from loner_tpu_torch.flagship import flagship
    from loner_tpu_torch.mapping import optimizer as opt
    from loner_tpu_torch.models.nerf import NeRFConfig

    reduced = {}
    for k in ENCODERS:
        hc = opt.MapperConfig(nerf=NeRFConfig(encoding_impl=k, compute_dtype="float32"))
        hc = hc._replace(loss=hc.loss._replace(loss_selection="L2_JS"))
        reduced[k] = _card_vs_cpu(opt, flagship, hc, dev, joint, 1e-4, f"{k}, float32 MLP, L2_JS",
                                  whole_step_gated=False, hash_scale=1e3)
    return reduced


def _encoders_leg(out_dir: Path, wrappers, dev, forest, flags) -> dict:
    """3h: the three alternate encoders ("exact", "packed", "cell") at full
    width, and the data prep. Per encoder, flagship train steps (joint,
    pose-frozen, occupancy-update) with every launch count set to 0 just
    before and read just after (B3 once per step, B1, B2, B4, B5 never), a
    profile of three joint steps (chiprun_out/step_profile_<encoder>.txt),
    the peak memory; B3 against its plain version on the inputs it met;
    each encoder and backward mode on the card against the CPU; the cell
    field trained offline on 3d's forest; the native library."""
    from loner_tpu_torch.flagship import flagship
    from loner_tpu_torch.mapping import optimizer as opt
    from loner_tpu_torch.models import sampling
    from loner_tpu_torch.models.nerf import NeRFConfig

    joint, frozen, occ = flags
    plan = [("joint", joint)] * 3 + [("frozen", frozen)] * 2 + [("occ_update", occ)] * 2
    steps, pdf_in, pts, part_s = {}, {}, None, {}
    t0 = time.perf_counter()
    with _first_inputs(sampling, "pdf_sample", pdf_in):
        for impl in ENCODERS:
            cfg, cube, state, window = flagship(device=dev, cfg=opt.MapperConfig(nerf=NeRFConfig(encoding_impl=impl)))
            step, state, mask, rec = _drive(f"leg 3h, {impl}", opt, cfg, cube, state, window, plan, wrappers,
                                            {"pdf_sample": len(plan)})
            rec["profile"] = _profile(_steps(step, state, window, joint, mask), 3, rec["step_ms"]["joint"],
                                      out_dir / f"step_profile_{impl}.txt")
            steps[impl] = rec
            if pts is None:  # one keyframe's sampled points (576 rays x 512 samples), in [0, 1]
                d = opt.draw_step(cfg, window, torch.Generator(device=dev).manual_seed(5), dev)
                with torch.no_grad():
                    b = opt.build_window_rays(state.poses, window, cube.to(dev), cfg, d.ray_idx, d.sky_idx)
                    z = sampling.occ_grid_sampler_z_vals(b, state.occ_grid, cfg.n_samples_train, cfg.perturb,
                                                         d.u_strat, d.u_pdf)
                    p = (b.origins.T[:, :, None] + b.directions.T[:, :, None] * z[None]).reshape(3, -1)
                    pts = ((p[:, : p.shape[1] // cfg.window_size] + 1.0) / 2.0).contiguous()
            del step, state, window
            torch.cuda.empty_cache()
    met = _check_met_inputs("leg 3h", {}, pdf_in)
    del pdf_in
    print("leg 3h, flagship steps: " + "; ".join(
        f"{k}: joint {r['step_ms']['joint']:.2f} ms wall, device busy {r['profile']['busy_ms']:.2f} ms, idle share "
        f"{r['profile']['idle_share']:.3f}, peak {r['peak_mem_gib']:.2f} GiB" for k, r in steps.items()), flush=True)
    part_s["steps"] = time.perf_counter() - t0
    encoders = _encoders_card_vs_cpu(pts)
    del pts
    torch.cuda.empty_cache()
    part_s["card_vs_cpu"] = time.perf_counter() - t0 - sum(part_s.values())
    cell_offline = _cell_offline(forest, wrappers, dev)
    part_s["cell_offline"] = time.perf_counter() - t0 - sum(part_s.values())
    native = _native_prep(out_dir)
    part_s["native"] = time.perf_counter() - t0 - sum(part_s.values())
    print(f"leg 3h: {sum(part_s.values()):.1f} s (" + ", ".join(f"{k} {v:.1f} s" for k, v in part_s.items()) + ")",
          flush=True)
    return {"steps": steps, "b3_on_met_inputs": met, "card_vs_cpu": encoders, "cell_offline": cell_offline,
            "native": native, "seconds": part_s}


def _pad_factors(factors, multiple: int):
    """``factors`` padded with weight-0 factors (0 -> 0) to a multiple of
    ``multiple``: the mesh form splits them evenly, and a weight-0 factor
    adds nothing."""
    from loner_tpu_torch.parallel.pose_graph import PoseGraphFactors

    pad = -factors.i.shape[0] % multiple
    return PoseGraphFactors(*(torch.cat([t, torch.zeros((pad,) + t.shape[1:], dtype=t.dtype, device=t.device)])
                              for t in factors))


def _lap_pose_graph():
    """The pose graph of leg 3e's keyframes when 3e did not run (``--only
    3i``): its lap (radius 5 m, period 12.6 s, 126 scans) at 16 keyframes
    0.75 s apart, the odometry of a drifted track and one loop factor of
    the true first-to-last transform, as tests/test_pose_graph.py builds its
    distributed case."""
    import numpy as np

    from loner_tpu_torch.data import synthetic
    from loner_tpu_torch.geometry import se3
    from loner_tpu_torch.parallel.pose_graph import make_factors, odometry_factors_from_tracking

    poses, _ = synthetic.circular_trajectory(n_poses=126, radius=5.0, period=12.6)
    gt = np.linalg.inv(poses[0])[None] @ poses[::8][:16]
    rng = np.random.default_rng(3)
    drift = [np.eye(4)]
    for _ in range(15):
        d = se3.pose_to_matrix(torch.as_tensor(rng.normal(0, 0.01, 6), dtype=torch.float32)).double().numpy()
        drift.append(drift[-1] @ d)
    est = np.stack([g @ d for g, d in zip(gt, drift)])
    edges = odometry_factors_from_tracking(est) + [(0, 15, np.linalg.inv(gt[0]) @ gt[15], 10.0)]
    p6 = torch.stack([se3.matrix_to_pose(torch.as_tensor(e, dtype=torch.float32)) for e in est])
    return p6, make_factors(edges), {"n_iters": 5}


def _parallel_leg(root: Path, out_dir: Path, wrappers, dev, forest, pose_graph=None) -> dict:
    """Leg 3i, the multi-device layer on one card: meshes of cuda:0 repeated
    (one controller, a device listed n times). Each part sets every launch
    count to 0 just before and reads it just after, and holds its sharded
    result against the single-device one on the same draws: the loss 1e-6
    relative, gradients normwise within the CPU tests' 1e-5 (f32 MLP) or
    1e-4 (the flagship's bf16 MLP: its weights round to bf16 once, before
    the shards' copies, so the shards' weight gradients sum in f32 and the
    sum rounds once, as in the single step; a rounding flip of one weight's
    gradient, from summing in another order, reads about 5e-5) plus the
    spread of two single-device runs
    (B2's and the table scatter's atomics sum in a varying order;
    reported). Parts: the flagship hash-off DP step over 1, 2, 4 and 8
    shards, 5 joint steps each (wall ms, device busy ms from a profile of 5
    more, peak memory; B1-B3 n a step), the same over 8 shards with an f32
    MLP, and the non-dividing case, a 3-keyframe window over 2 shards (whole
    on the first: B1-B3 once a step; the mapper itself never builds such a
    window, its windows repeat keyframes up to the window size); the hash-on
    triad flagship DP x TP at (2, 2) and (4, 2), a joint and a pose-frozen
    step (B1-B4 once a step per data row, B5 per data row with pose
    gradients; the 2^16-cell table in 2 slabs; wall ms of 4 warm steps and
    peak memory, device busy ms of the joint step, each beside the single
    hash-on step's); 3h's flagships of the "exact", "packed" and "cell"
    encoders (16 levels x 2 features, 2^18-entry tables; cell's default
    level1 gradient) under DP x TP (2, 2), a joint and a pose-frozen step
    each (B3 once a step per data row, the other kernels never; cell's
    (16, 65536, 16) table in two (16, 32768, 16) slabs, the exact and
    packed (16, 2, 2^18) masters whole on cuda:0; wall ms of 2 warm steps
    and peak memory, device busy ms of one joint step, each beside the
    single step's); EP over 4 submaps of 10 of 3d's forest
    keyframes at the offline widths (512 + 64 rays, 512 samples in 2
    chunks, MASK), 3 iterations, against each submap trained alone with the
    JAX package's drift bounds (B1, B2 twice a step, B3 once; each
    iteration's wall beside the 4 submaps' sequential steps'); the pose
    graph of 3e's keyframes (``pose_graph``; without it, the lap's graph of
    :func:`_lap_pose_graph`) over 8 devices against one (1e-4, cost 1e-5);
    the camera step under a 2-device mesh against none (loss 1e-6, the
    intensity gradients 1e-5 plus the spread; every leaf on cuda:0);
    LonerSLAM with the tracker on device 0 and the mapper's mesh [0, 0]
    over the online cell's first 12 scans (tracking ATE under 0.3 m;
    B1-B3 twice a step: each window of 8 splits in two); and
    ``dryrun_multichip(8)`` (B1-B5 8 in DP, 4 in DP x TP, whose 2^10-cell
    table stays whole)."""
    import dataclasses

    import numpy as np

    from loner_tpu_torch.flagship import flagship
    from loner_tpu_torch.geometry import se3
    from loner_tpu_torch.mapping import camera_optimizer as cam
    from loner_tpu_torch.mapping import optimizer as opt
    from loner_tpu_torch.mapping.keyframe import stack_window
    from loner_tpu_torch.models.nerf import NeRFConfig
    from loner_tpu_torch.multichip import dryrun_multichip
    from loner_tpu_torch.ops.fused_encoder import TableSlabs
    from loner_tpu_torch.ops.triad_field import TriadConfig
    from loner_tpu_torch.parallel import pose_graph as pg
    from loner_tpu_torch.parallel import submaps_parallel as sp
    from loner_tpu_torch.parallel import tp
    from loner_tpu_torch.parallel.sharding import Mesh, make_sharded_train_step

    t_leg = time.perf_counter()
    names = [w.__name__ for w in wrappers]
    BF16 = 1e-4  # a bf16 rounding flip of one weight's gradient reads about 5e-5

    def mesh(n, model=None):
        devs = np.empty(n, dtype=object)
        devs[:] = [dev] * n
        return Mesh(devs if model is None else devs.reshape(n // model, model),
                    ("data",) if model is None else ("data", "model"))

    def counted(name, expected, fn):
        for w in wrappers:
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, _check_launches(f"3i {name}", wrappers, expected)

    def grads_of(aux):
        return tp.gather_mapper_state({"sigma": aux["grads"]["sigma"], "poses": aux["grads"]["poses"]})

    def held(name, ref, ref2, got, tol):
        """``got`` (loss, grads) against ``ref``; ``ref2`` a second run of the
        reference, whose difference from it is the atomics' spread."""
        loss_err = abs(float(got["loss"]) / float(ref["loss"]) - 1)
        spread = _rel(grads_of(ref2), grads_of(ref))
        err = _rel(grads_of(got), grads_of(ref))
        row = {"loss_rel_err": loss_err, "grad_rel_err": err, "single_spread": spread, "bound": tol + spread}
        print(f"3i {name}: loss {loss_err:.3e} relative (bound 1e-6), gradients {err:.3e} normwise "
              f"(bound {tol:.0e} + the single step's run-to-run spread {spread:.3e})", flush=True)
        if not (loss_err <= 1e-6 and err <= tol + spread):
            raise AssertionError(f"3i {name}: sharded step against the single one: {row}")
        return row

    res = {}
    joint = opt.TrainStepFlags(freeze_sigma=False, freeze_rgb=True, freeze_poses=False, do_occ_update=False)
    frozen = joint._replace(freeze_poses=True)

    # ---- DP: the flagship hash-off step over 1, 2, 4, 8 shards ------------
    cfg, cube, state, window = flagship(device=dev)
    mask = torch.ones(cfg.max_keyframes, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    draws = [opt.draw_step(cfg, window, gen, dev) for _ in range(5)]
    single = opt.make_train_step(cfg, cube, dev)
    ref = [single(state, window, joint, mask, 0, draws[0])[1] for _ in range(2)]
    dp = {}
    for n in (1, 2, 4, 8):
        step = single if n == 1 else make_sharded_train_step(cfg, cube, mesh(n))
        torch.cuda.reset_peak_memory_stats()
        times = []

        def run_steps():
            st, auxes = state, []
            for it, d in enumerate(draws):
                t = time.perf_counter()
                st, aux = step(st, window, joint, mask, it, d)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
                auxes.append(aux)
            return auxes

        auxes, launches = counted(f"DP over {n}", {k: 5 * n for k in PATH_KERNELS}, run_steps)
        losses = [float(a["loss"]) for a in auxes]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"3i DP over {n}: non-finite loss {losses}")
        wall = sum(times[1:]) / len(times[1:])
        row = {"wall_ms": wall, "wall_ms_all": times, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launches, "losses": losses, "held": held(f"DP over {n}", ref[0], ref[1], auxes[0], BF16)}
        row["profile"] = _profile(_steps(step, state, window, joint, mask), 5, wall,
                                  out_dir / f"step_profile_dp{n}.txt")
        print(f"3i DP over {n}: {wall:.3f} ms a joint step (host clock), device busy {row['profile']['busy_ms']:.3f} "
              f"ms, peak {row['peak_mem_gib']:.2f} GiB", flush=True)
        dp[n] = row
    res["dp"] = dp
    fcfg = cfg._replace(nerf=cfg.nerf._replace(compute_dtype="float32"))
    fref = [opt.make_train_step(fcfg, cube, dev)(state, window, joint, mask, 0, draws[0])[1] for _ in range(2)]
    (_, faux), f_launches = counted("DP over 8, f32 MLP", {k: 8 for k in PATH_KERNELS},
                                    lambda: make_sharded_train_step(fcfg, cube, mesh(8))(state, window, joint, mask, 0,
                                                                                         draws[0]))
    res["dp_8_f32"] = {"launches": f_launches, "held": held("DP over 8, f32 MLP", fref[0], fref[1], faux, 1e-5)}
    del fref, faux
    w3 = type(window)(*(t[:3] for t in window))
    d3 = opt.draw_step(cfg._replace(window_size=3), w3, gen, dev)
    cfg3 = cfg._replace(window_size=3)
    ref3 = [opt.make_train_step(cfg3, cube, dev)(state, w3, joint, mask, 0, d3)[1] for _ in range(2)]
    (_, aux3), launches3 = counted("3 keyframes over 2", {k: 1 for k in PATH_KERNELS},
                                   lambda: make_sharded_train_step(cfg3, cube, mesh(2))(state, w3, joint, mask, 0, d3))
    res["window3_over_2"] = {"launches": launches3, "held": held("3 keyframes over 2", ref3[0], ref3[1], aux3, BF16)}
    del state, window, draws, ref, ref3, aux3, auxes
    torch.cuda.empty_cache()

    # ---- DP x TP: the hash-on triad flagship -------------------------------
    hcfg, hcube, hstate, hwindow = flagship(device=dev, cfg=opt.MapperConfig(nerf=NeRFConfig(
        triad=TriadConfig(hash_levels=1))))
    hdraws = opt.draw_step(hcfg, hwindow, gen, dev)
    hsingle = opt.make_train_step(hcfg, hcube, dev)

    def warm(name, step, flags, profiled, inputs=None, n_warm=4, n_profiled=3):
        """Wall ms of ``n_warm`` warm calls of ``step`` on ``inputs`` (state,
        window, draws; the hash-on window's when None) (host clock,
        synchronised), the peak memory since the last reset, and, for
        ``profiled``, device busy ms over ``n_profiled`` more."""
        st, win, dr = inputs or (hstate, hwindow, hdraws)
        m = torch.ones(st.poses.shape[0], device=dev)
        times = []
        for _ in range(n_warm):
            t = time.perf_counter()
            step(st, win, flags, m, 0, dr)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        row = {"wall_ms": sum(times) / len(times), "wall_ms_all": times,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        if profiled:
            row["profile"] = _profile(lambda: step(st, win, flags, m, 0, dr), n_profiled, row["wall_ms"],
                                      out_dir / f"step_profile_{name}.txt")
        busy = f", device busy {row['profile']['busy_ms']:.3f} ms" if profiled else ""
        print(f"3i {name}: {row['wall_ms']:.3f} ms a warm step (host clock){busy}, peak "
              f"{row['peak_mem_gib']:.2f} GiB", flush=True)
        return row

    dptp, hash_single = {}, {}
    for flags, kind in ((joint, "joint"), (frozen, "frozen")):
        torch.cuda.reset_peak_memory_stats()
        href = [hsingle(hstate, hwindow, flags, mask, 0, hdraws)[1] for _ in range(2)]
        hash_single[kind] = warm(f"hash_on_single_{kind}", hsingle, flags, kind == "joint")
        for shape in ((2, 2), (4, 2)):
            n_data = shape[0]
            step = tp.make_tp_train_step(hcfg, hcube, mesh(shape[0] * shape[1], shape[1]))
            expected = {**{k: n_data for k in PATH_KERNELS}, "interp_fwd": n_data,
                        "interp_dpts": n_data if kind == "joint" else 0}
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            (new, aux), launches = counted(f"DP x TP {shape} {kind}", expected,
                                           lambda: step(hstate, hwindow, flags, mask, 0, hdraws))
            wall = (time.perf_counter() - t) * 1e3
            slabs = new.params["sigma"]["table"]["hash"]
            if [tuple(s.shape) for s in slabs] != [(1, 32768, 128)] * shape[1]:
                raise AssertionError(f"3i DP x TP {shape}: table slabs {[tuple(s.shape) for s in slabs]}")
            dptp[f"{shape[0]}x{shape[1]}_{kind}"] = {
                "launches": launches, "wall_ms_first": wall,
                **warm(f"dp_tp_{shape[0]}x{shape[1]}_{kind}", step, flags, kind == "joint"),
                "held": held(f"DP x TP {shape} {kind}", href[0], href[1], aux, BF16)}
    res["dp_tp"], res["hash_on_single"] = dptp, hash_single
    del hstate, hwindow, hdraws, href, new, aux, slabs
    torch.cuda.empty_cache()

    # ---- DP x TP (2, 2) under the alternate encoders: 3h's flagships -------
    enc_tp = {}
    for impl in ("exact", "packed", "cell"):
        ecfg, ecube, estate, ewindow = flagship(device=dev, cfg=opt.MapperConfig(nerf=NeRFConfig(encoding_impl=impl)))
        edraws = opt.draw_step(ecfg, ewindow, gen, dev)
        emask = torch.ones(ecfg.max_keyframes, device=dev)
        esingle = opt.make_train_step(ecfg, ecube, dev)
        estep = tp.make_tp_train_step(ecfg, ecube, mesh(4, 2))
        for flags, kind in ((joint, "joint"), (frozen, "frozen")):
            torch.cuda.reset_peak_memory_stats()
            eref = [esingle(estate, ewindow, flags, emask, 0, edraws)[1] for _ in range(2)]
            single_row = warm(f"single_{impl}", esingle, flags, kind == "joint", (estate, ewindow, edraws), 2, 1)
            torch.cuda.reset_peak_memory_stats()
            (new, aux), launches = counted(f"DP x TP (2, 2) {impl} {kind}", {"pdf_sample": 2},
                                           lambda: estep(estate, ewindow, flags, emask, 0, edraws))
            table = new.params["sigma"]["table"]
            if impl == "cell":  # (16, 65536, 16) in two slabs along the cells
                ok = isinstance(table, TableSlabs) and [tuple(t.shape) for t in table] == [(16, 32768, 16)] * 2
            else:  # the (16, 2, 2^18) master stays whole on the first device
                ok = not isinstance(table, TableSlabs) and table.device == dev and tuple(table.shape) == (16, 2, 1 << 18)
            if not ok:
                raise AssertionError(f"3i DP x TP (2, 2) {impl}: sigma table {table}")
            enc_tp[f"{impl}_{kind}"] = {
                "launches": launches, "single": single_row,
                **warm(f"dp_tp_{impl}", estep, flags, kind == "joint", (estate, ewindow, edraws), 2, 1),
                "held": held(f"DP x TP (2, 2) {impl} {kind}", eref[0], eref[1], aux, BF16)}
            del eref, new, aux, table
        del ecfg, ecube, estate, ewindow, edraws, esingle, estep
        torch.cuda.empty_cache()
    res["dp_tp_encoders"] = enc_tp

    # ---- EP: 4 submaps of the forest at the offline widths ----------------
    kfs, fcube, ray_range, _ = forest
    ecfg = _offline_cfg(fcube, ray_range)._replace(window_size=10)
    # each submap's keyframes index its own pose rows 0..9
    wins = [stack_window([dataclasses.replace(k, pose_index=k.pose_index - 10 * s) for k in kfs[10 * s:10 * s + 10]],
                         n_sky_pad=1024, device=dev) for s in range(4)]
    states = []
    for s in range(4):
        st = opt.init_mapper_state(torch.Generator(device=dev).manual_seed(20 + s), ecfg, dev)
        poses = st.poses.clone()
        poses[:10] = se3.matrix_to_pose(torch.as_tensor(np.stack([k.gt_pose for k in kfs[10 * s:10 * s + 10]]),
                                                            dtype=torch.float32, device=dev))
        states.append(st._replace(poses=poses))
    ep_flags = frozen._replace(do_occ_update=True)
    emask = torch.zeros(ecfg.max_keyframes, device=dev)
    edraws = [[opt.draw_step(ecfg, wins[s], gen, dev) for _ in range(3)] for s in range(4)]
    seq_step = opt.make_train_step(ecfg, fcube, dev)
    seq, seq_times = [], [0.0] * 3  # the sequential steps' wall, summed over the submaps per iteration
    for s in range(4):
        st = states[s]
        for it in range(3):
            t = time.perf_counter()
            st, _ = seq_step(st, wins[s], ep_flags, emask, it, edraws[s][it])
            torch.cuda.synchronize()
            seq_times[it] += (time.perf_counter() - t) * 1e3
        seq.append(st)
    par_step = sp.make_submap_parallel_step(ecfg, fcube, mesh(4))
    stacked, win = sp.stack_states(states), sp.stack_windows(wins)

    def run_ep():
        st, times = stacked, []
        for it in range(3):
            t = time.perf_counter()
            st, aux = par_step(st, win, ep_flags, emask, it, [edraws[s][it] for s in range(4)])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return st, aux, times

    torch.cuda.reset_peak_memory_stats()
    (stacked, eaux, ep_times), ep_launches = counted("EP 4 submaps", {"cp_fwd": 24, "cp_bwd": 24, "pdf_sample": 12},
                                                     run_ep)
    drift = []
    for s, par in enumerate(sp.unstack_states(stacked, 4)):
        for a, b in zip(opt.tree_leaves(seq[s].params), opt.tree_leaves(par.params)):
            diff = (a - b).abs()
            drift.append((float((diff > 5e-5).float().mean()), float(diff.max())))
    res["ep"] = {"launches": ep_launches, "iteration_ms": ep_times, "sequential_iteration_ms": seq_times,
                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "losses": [float(x) for x in eaux["loss"]], "drift_share_max": max(d[0] for d in drift),
                 "drift_abs_max": max(d[1] for d in drift)}
    print(f"3i EP: iterations {['%.1f' % t for t in ep_times]} ms (the 4 submaps' steps one after another: "
          f"{['%.1f' % t for t in seq_times]} ms), losses {res['ep']['losses']}, drift against "
          f"sequential: share over 5e-5 {res['ep']['drift_share_max']:.2e} (bound 1e-3), max "
          f"{res['ep']['drift_abs_max']:.2e} (bound 0.03)", flush=True)
    if not (res["ep"]["drift_share_max"] < 1e-3 and res["ep"]["drift_abs_max"] < 3 * ecfg.lr_sigma):
        raise AssertionError(f"3i EP: submaps drift from their sequential training: {res['ep']}")
    del states, stacked, seq, wins, win, edraws
    torch.cuda.empty_cache()

    # ---- the pose graph over 8 devices -------------------------------------
    p6, factors, kw = pose_graph if pose_graph is not None else _lap_pose_graph()
    kw = {k: v for k, v in kw.items() if k != "mesh"}  # 3e's refinement solves on one device
    factors = _pad_factors(factors, 8)
    p6 = p6.to(dev)
    one, cost1 = pg.solve_pose_graph(p6, factors, **kw)
    (eight, cost8), _ = counted("pose graph over 8", {}, lambda: pg.solve_pose_graph(p6, factors, mesh=mesh(8), **kw))
    pg_err, cost_err = float((eight - one).abs().max()), abs(float(cost8) / float(cost1) - 1)
    res["pose_graph"] = {"keyframes": int(p6.shape[0]), "factors": int(factors.i.shape[0]), "max_abs_err": pg_err,
                         "cost_rel_err": cost_err, "from_leg_3e": pose_graph is not None}
    print(f"3i pose graph: {res['pose_graph']} (bounds 1e-4, 1e-5)", flush=True)
    if not (pg_err <= 1e-4 and cost_err <= 1e-5 and eight.device == dev):
        raise AssertionError(f"3i pose graph over 8 devices against one: {res['pose_graph']}")

    # ---- the camera step under a 2-device mesh ----------------------------
    ccfg, ccube, cstate, _ = flagship(device=dev)
    rng = np.random.default_rng(4)
    imgs = rng.uniform(size=(2, 360, 640, 3)).astype(np.float32)
    K = np.array([[400.0, 0, 320], [0, 400.0, 180], [0, 0, 1]])
    cam_poses = np.stack([np.eye(4), np.eye(4)])
    cwin = cam.stack_camera_window(imgs, np.ones(imgs.shape[:3], bool), cam_poses, K, device=dev)
    cdraws = cam.draw_camera_step(ccfg, cwin, 1024, gen, dev)
    cref = [cam.make_camera_train_step(ccfg, ccube, 1024, device=dev)(cstate, cwin, cdraws) for _ in range(2)]
    (cnew, caux), _ = counted("camera step, mesh of 2", {"cp_fwd": 2 * ccfg.nerf.point_chunks,
                                                         "cp_bwd": ccfg.nerf.point_chunks, "pdf_sample": 1},
                              lambda: cam.make_camera_train_step(ccfg, ccube, 1024, mesh=mesh(2))(cstate, cwin, cdraws))
    c_loss = abs(float(caux["loss"]) / float(cref[0][1]["loss"]) - 1)
    c_spread = _rel(cref[1][1]["grads"], cref[0][1]["grads"])
    c_err = _rel(caux["grads"], cref[0][1]["grads"])
    on_card = all(t.device == dev for t in opt.tree_leaves(cnew))
    res["camera"] = {"loss_rel_err": c_loss, "grad_rel_err": c_err, "single_spread": c_spread,
                     "leaves_on_first_device": on_card}
    print(f"3i camera step, mesh of 2 against none: {res['camera']}", flush=True)
    if not (c_loss <= 1e-6 and c_err <= 1e-5 + c_spread and on_card):
        raise AssertionError(f"3i camera step under a mesh: {res['camera']}")
    del ccfg, cstate, cwin, cref, cnew, caux
    torch.cuda.empty_cache()

    # ---- LonerSLAM: the tracker on device 0, the mapper's mesh [0, 0] ------
    res["slam_split"] = _split_slam(root, out_dir, wrappers, dev)

    # ---- the dry run ------------------------------------------------------
    # every kernel once a shard: 8 in DP, 4 data rows in DP x TP
    losses, dry_launches = counted("dryrun_multichip(8)", {k: 8 + 4 for k in names},
                                   lambda: dryrun_multichip(8, devices=[dev] * 8))
    res["dryrun"] = {"losses": losses, "launches": dry_launches}
    res["wall_s"] = time.perf_counter() - t_leg
    res["launches"] = {**{f"dp_{n}": r["launches"] for n, r in dp.items()}, "dp_8_f32": f_launches,
                       "window3_over_2": launches3, **{f"dp_tp_{k}": v["launches"] for k, v in dptp.items()},
                       **{f"dp_tp_{k}": v["launches"] for k, v in enc_tp.items()}, "ep": ep_launches, "slam_split": res["slam_split"]["launches"], "dryrun": dry_launches}
    print(f"leg 3i: {res['wall_s']:.1f} s", flush=True)
    return res


def _split_slam(root: Path, out_dir: Path, wrappers, dev) -> dict:
    """LonerSLAM from cfg/defaults.yaml as in 3c over the first 12 scans of
    its loop, with ``tracker.device_index`` 0 and
    ``mapper.mesh_device_indices`` [0, 0]: the tracker on cuda:0, the
    mapper's steps over a mesh of cuda:0 twice (each window of 8 keyframes,
    repeated while fewer exist, in two blocks of 4). Tracking ATE under 0.3
    m; B1-B3 twice a train step."""
    import numpy as np

    from loner_tpu_torch.analysis.metrics import ate_rmse
    from loner_tpu_torch.config.build import build_slam_config
    from loner_tpu_torch.config.settings import load_settings
    from loner_tpu_torch.data import synthetic
    from loner_tpu_torch.data.scan import make_lidar_scan, sky_scan
    from loner_tpu_torch.geometry.world_cube import compute_world_cube
    from loner_tpu_torch.slam import LonerSLAM

    ray_range = (1.0, 40.0)
    settings = load_settings(str(root / "cfg" / "defaults.yaml"), overrides={
        "data": {"ray_range": list(ray_range)}, "tracker": {"motion_compensation": {"enabled": False}}})
    scene = synthetic.Scene.default()
    poses, ts = synthetic.circular_trajectory(n_poses=48, radius=5.0, z=1.5, period=9.6)
    gt = np.linalg.inv(poses[0])[None] @ poses
    cube = compute_world_cube(poses, ray_range=ray_range, rebase_to_first_pose=True)
    cfg = build_slam_config(settings, cube.scale_factor)
    cfg.tracker.device_index = 0
    cfg.mapper.mesh_device_indices = [0, 0]
    scans = []
    for T, t0 in zip(poses[:12], ts):
        dirs, dists, stamps, hit = synthetic.simulate_scan(scene, T, t0, n_channels=32, n_azimuth=512,
                                                           max_range=ray_range[1])
        scans.append((make_lidar_scan(dirs[hit], dists[hit], stamps[hit], pad_to=16384),
                      sky_scan(dirs[~hit][:1024], ray_range[1] + 1.0, t0, pad_to=cfg.mapper.n_sky_pad)))
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    slam = LonerSLAM(cfg, cube, device=dev)
    est = np.stack([slam.process_scan(scan, t, gt_pose=g, sky=sky) for (scan, sky), t, g in zip(scans, ts, gt)])
    run_dir = out_dir / "slam_split"
    slam.stop(str(run_dir))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    steps = slam.mapper._host_step
    # every window holds window_size keyframes (repeated while fewer exist):
    # the mesh splits each one when it divides it
    n_mesh = slam.mapper.mesh.size
    shards = n_mesh if cfg.mapper.mapper.window_size % n_mesh == 0 else 1
    launches = _check_launches("3i split SLAM", wrappers, {k: steps * shards for k in PATH_KERNELS})
    ate = float(np.sqrt(np.mean(np.linalg.norm(est[:, :3, 3] - gt[:12, :3, 3], axis=1) ** 2)))
    mesh_devs = [str(d) for d in slam.mapper.mesh.devices.ravel()]
    res = {"wall_s": wall_s, "train_steps": steps, "launches": launches, "ate_tracking_m": ate,
           "tracker_device": str(slam.tracker.device), "mapper_mesh": mesh_devs,
           "track_ms_median": float(np.median(slam.tracker.track_times)) * 1e3}
    print(f"3i split SLAM: {res}", flush=True)
    if not (ate < 0.3 and np.all(np.isfinite(est))):
        raise AssertionError(f"3i split SLAM: tracking ATE {ate:.4f} m (gate 0.3 m)")
    shutil.rmtree(run_dir / "checkpoints")
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card visible; nothing was run")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from loner_tpu_torch.flagship import flagship
    from loner_tpu_torch.mapping import optimizer as opt
    from loner_tpu_torch.models.nerf import NeRFConfig, fused_config_from
    from loner_tpu_torch.ops import cp_kernel, kernels, pdf_kernel
    from loner_tpu_torch.ops import fused_encoder as fe
    from loner_tpu_torch.ops import gather_scatter as gs
    from loner_tpu_torch.ops.pdf_kernel import build_cdf
    from loner_tpu_torch.ops.triad_field import TriadConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    kernels.load()
    print(f"kernel library built and loaded in {time.perf_counter() - t0:.2f} s")
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernels_build.log").write_text(kernels.build_log)
    if sys.argv[1:] == ["--only", "3h"]:  # leg 3h alone: no kernel line and no device line
        joint = opt.TrainStepFlags(freeze_sigma=False, freeze_rgb=True, freeze_poses=False, do_occ_update=False)
        wrappers = (cp_kernel.cp_fwd, cp_kernel.cp_bwd, pdf_kernel.pdf_sample, fe.interp_fwd, fe.interp_dpts)
        leg = _encoders_leg(out_dir, wrappers, dev, _forest_keyframes(),
                            (joint, joint._replace(freeze_poses=True), joint._replace(do_occ_update=True)))
        leg["reduced_step"] = _encoders_reduced(dev, joint)
        (out_dir / "chip_smoke_3h.json").write_text(json.dumps(leg, indent=1))
        print("leg 3h passed")
        return
    if sys.argv[1:] == ["--only", "3i"]:  # leg 3i alone: no kernel line and no device line
        wrappers = (cp_kernel.cp_fwd, cp_kernel.cp_bwd, pdf_kernel.pdf_sample, fe.interp_fwd, fe.interp_dpts)
        leg = _parallel_leg(Path(__file__).resolve().parent, out_dir, wrappers, dev, _forest_keyframes())
        (out_dir / "chip_smoke_3i.json").write_text(json.dumps(leg, indent=1))
        print("leg 3i passed")
        return
    if sys.argv[1:] == ["--only", "3j"]:  # leg 3j alone: no kernel line and no device line
        wrappers = (cp_kernel.cp_fwd, cp_kernel.cp_bwd, pdf_kernel.pdf_sample, fe.interp_fwd, fe.interp_dpts)
        leg = _encoder_experiment_leg(out_dir, wrappers, dev, _forest_keyframes())
        (out_dir / "chip_smoke_3j.json").write_text(json.dumps(leg, indent=1))
        print("leg 3j passed")
        return
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]} (none, --only 3h, 3i or 3j)")

    # the two hash-on fields: the triad's fat-row level (TriadConfig(hash_levels=1))
    # and the 16-level FusedHash (NeRFConfig(encoding_impl="fused"))
    hash_cfgs = {
        "triad_hash": opt.MapperConfig(nerf=NeRFConfig(triad=TriadConfig(hash_levels=1))),
        "fused": opt.MapperConfig(nerf=NeRFConfig(encoding_impl="fused")),
    }

    def encoder_config(mcfg):
        nerf = mcfg.nerf._replace(encoding_slot_period=mcfg.n_samples_train)
        if nerf.encoding_impl == "fused":
            return fused_config_from(nerf, nerf.pos_encoding_sigma)
        return nerf._triad_for(nerf.pos_encoding_sigma).hash_config(nerf.encoding_slot_period)

    # ---- flagship inputs for the kernel checks --------------------------
    cfg, cube, state, window = flagship(device=dev)
    triad = cfg.nerf._triad_for(cfg.nerf.pos_encoding_sigma)
    res, nf = triad.cp_resolutions, triad.cp_features
    gen = torch.Generator(device=dev).manual_seed(1)
    draws = opt.draw_step(cfg, window, gen, dev)
    with torch.no_grad():
        bundle = opt.build_window_rays(state.poses, window, cube.to(dev), cfg, draws.ray_idx, draws.sky_idx)
        z = opt.sampling.occ_grid_sampler_z_vals(bundle, state.occ_grid, cfg.n_samples_train, cfg.perturb,
                                                 draws.u_strat, draws.u_pdf)
        pts = (bundle.origins.T[:, :, None] + bundle.directions.T[:, :, None] * z[None]).reshape(3, -1)
        pts = ((pts + 1.0) / 2.0).contiguous()
        half = cfg.n_samples_train // 2
        zs = opt.sampling.stratified_z_vals(bundle.near, bundle.far, half, cfg.perturb, draws.u_strat)
        probs = opt.sampling.occupancy_probs_t(
            state.occ_grid, bundle.origins.T[:, :, None] + bundle.directions.T[:, :, None] * zs[None])
        bins = (0.5 * (zs[:, :-1] + zs[:, 1:])).contiguous()
        cdf = build_cdf(probs[:, 1:-1]).contiguous()
        u = draws.u_pdf.contiguous()
    lines = state.params["sigma"]["table"]["cp"].contiguous()
    n = pts.shape[1]
    g = torch.randn((len(res) * nf, n), generator=gen, device=dev)
    print(f"flagship: {n} field points, lines {tuple(lines.shape)}, pdf {tuple(cdf.shape)} x {u.shape[1]} draws")

    report = []

    # B1
    out = cp_kernel.cp_fwd(lines, pts, res, nf)
    ref = cp_kernel.cp_encode_ref(lines, pts, res)
    err = float((out - ref).abs().max())
    if not err <= 1e-5 * max(1.0, float(ref.abs().max())):
        raise AssertionError(f"cp_fwd disagrees with its plain version: max abs err {err}")
    del out, ref
    b1_ms = _event_ms(lambda: cp_kernel.cp_fwd(lines, pts, res, nf), 20)
    b1_plain = _event_ms(lambda: cp_kernel.cp_encode_ref(lines, pts, res), 3, 1)
    # per output: 3 lerps (sub, 2 mul, add) + 2 mul; bytes: pts in, features out
    b1_bound = _bound(n * 3 * 4 + lines.numel() * 4 + len(res) * nf * n * 4, len(res) * nf * n * 14)
    report.append(dict(name="cp_fwd", route="cuda", source="loner_tpu_torch/csrc/cp_kernel.cu",
                       replaces="loner_tpu/ops/cp_kernel.py:168", max_abs_err=err, ms=b1_ms, plain_ms=b1_plain,
                       bound_ms=b1_bound[0], bound_by=b1_bound[1], library_ms=None))

    device_ms = {"cp_fwd": graph_ms(lambda: cp_kernel.cp_fwd(lines, pts, res, nf))}

    # B2 (f32, the main path's mode), plus the bf16 knob's agreement, on the
    # flagship's ray-ordered points and on a fixed permutation of the same
    # points and gradients (every warp then meets 32 cells: the worst case)
    perm = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    orders = {"ray": (pts, g), "permuted": (pts[:, perm].contiguous(), g[:, perm].contiguous())}
    del perm
    errs = {}
    for order, (p_o, g_o) in orders.items():
        for mm in ("f32", "bf16"):
            dl, dp = cp_kernel.cp_bwd(lines, p_o, g_o, res, nf, mm)
            dl_ref, dp_ref = cp_kernel.cp_bwd_ref(lines, p_o, g_o, res, nf, mm)
            e_dl, e_dp = float((dl - dl_ref).abs().max()), float((dp - dp_ref).abs().max())
            # dlines sums 2.36M terms by atomics in a varying order: bound it
            # against its largest entry; dpts is per point (16 terms per level)
            if not e_dl <= 1e-4 * float(dl_ref.abs().max()):
                raise AssertionError(f"cp_bwd({mm}, {order}) dlines disagrees: {e_dl} vs scale "
                                     f"{float(dl_ref.abs().max())}")
            if not torch.allclose(dp, dp_ref, rtol=1e-4, atol=1e-4):
                raise AssertionError(f"cp_bwd({mm}, {order}) dpts disagrees: max abs err {e_dp}")
            errs[order, mm] = max(e_dl, e_dp)
            print(f"cp_bwd {mm}, {order} points: dlines err {e_dl:.3e} (scale {float(dl_ref.abs().max()):.3e}), "
                  f"dpts err {e_dp:.3e}")
            del dl, dp, dl_ref, dp_ref
    b2_ms = _event_ms(lambda: cp_kernel.cp_bwd(lines, pts, g, res, nf), 10)
    b2_plain = _event_ms(lambda: cp_kernel.cp_bwd_ref(lines, pts, g, res, nf), 3, 1)
    p_o, g_o = orders.pop("permuted")
    device_ms["cp_bwd"] = graph_ms(lambda: cp_kernel.cp_bwd(lines, pts, g, res, nf))
    device_ms["cp_bwd_permuted"] = graph_ms(lambda: cp_kernel.cp_bwd(lines, p_o, g_o, res, nf))
    del p_o, g_o, orders
    # the port's yardstick for B2: 3x faster than the first design's 1.95 ms
    # (its target is 0.395 ms, half its byte bound)
    print(f"cp_bwd device ms by graph replay: {device_ms['cp_bwd']:.4f} ray-ordered, "
          f"{device_ms['cp_bwd_permuted']:.4f} permuted (limit 0.65, target 0.395)")
    if not device_ms["cp_bwd"] <= 0.65:
        raise AssertionError(f"cp_bwd takes {device_ms['cp_bwd']:.4f} ms on ray-ordered points, over 0.65")
    # per (point, level, feature): 3 lerps (12) + per axis 9 (g*fb*fc, dpts
    # term, two weighted adds); bytes: pts + g in, dpts out
    b2_bound = _bound(n * 3 * 4 * 2 + len(res) * nf * n * 4 + 2 * lines.numel() * 4, len(res) * nf * n * 39)
    report.append(dict(name="cp_bwd", route="cuda", source="loner_tpu_torch/csrc/cp_kernel.cu",
                       replaces="loner_tpu/ops/cp_kernel.py:180", max_abs_err=errs["ray", "f32"], ms=b2_ms,
                       plain_ms=b2_plain, bound_ms=b2_bound[0], bound_by=b2_bound[1], library_ms=None))

    # B3
    out = pdf_kernel.pdf_sample(bins, cdf, u)
    ref = pdf_kernel.pdf_sample_ref(bins, cdf, u)
    err = float((out - ref).abs().max())
    if not err <= 1e-6:
        raise AssertionError(f"pdf_sample disagrees with its plain version: max abs err {err}")

    def library():
        inds = torch.searchsorted(cdf, u, right=True)
        below = torch.clamp(inds - 1, min=0)
        above = torch.clamp(inds, max=cdf.shape[1] - 1)
        c0, c1 = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
        b0, b1 = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
        den = c1 - c0
        den = torch.where(den < 1e-5, torch.ones_like(den), den)
        return b0 + (u - c0) / den * (b1 - b0)

    if not torch.equal(library(), ref):
        raise AssertionError("the searchsorted yardstick computes another function")
    b3_ms = _event_ms(lambda: pdf_kernel.pdf_sample(bins, cdf, u), 50)
    b3_plain = _event_ms(lambda: pdf_kernel.pdf_sample_ref(bins, cdf, u), 5, 1)
    b3_lib = _event_ms(library, 50)
    b3_graph = {"kernel": graph_ms(lambda: pdf_kernel.pdf_sample(bins, cdf, u)), "library": graph_ms(library)}
    print(f"pdf_sample: device ms by graph replay {b3_graph}")
    nr, m1 = cdf.shape
    # bytes: bins, cdf, u in, samples out; ops: ~log2(M+1) compares + 6 per draw
    b3_bound = _bound(4 * nr * (2 * m1 + 2 * u.shape[1]), nr * u.shape[1] * (math.log2(m1) + 6))
    report.append(dict(name="pdf_sample", route="cuda", source="loner_tpu_torch/csrc/pdf_kernel.cu",
                       replaces="loner_tpu/ops/pdf_kernel.py:45", max_abs_err=err, ms=b3_ms, plain_ms=b3_plain,
                       bound_ms=b3_bound[0], bound_by=b3_bound[1], library_ms=b3_lib))
    del g, bins, cdf, u, out, ref, bundle, z, probs, zs

    # P1-P6: the probes' kernels at their scripts' default shapes (P5 on B1's
    # flagship inputs); their JSON entries follow B1-B5's
    probe_entries, probe_kernels = _check_probe_kernels(gs, cp_kernel, lines, pts, res, nf, b1_bound)
    del lines

    # B4, B5 at both hash-on shapes, on the same sampled points; the JSON
    # line carries the triad's (the profiled hash-on path's) shapes
    fused_shapes = {k: _check_fused_kernels(fe, encoder_config(c), pts, gen, k) for k, c in hash_cfgs.items()}
    main_shapes = fused_shapes["triad_hash"]
    for name, src, kind in (("interp_fwd", "loner_tpu/ops/fused_encoder.py:210", "fwd"),
                            ("interp_dpts", "loner_tpu/ops/fused_encoder.py:248", "dpts")):
        r = main_shapes
        report.append(dict(name=name, route="cuda", source="loner_tpu_torch/csrc/fused_encoder.cu", replaces=src,
                           max_abs_err=max(s[f"{kind}_err"] for s in fused_shapes.values()), ms=r[f"{kind}_ms"],
                           plain_ms=r[f"{kind}_plain_ms"], bound_ms=r[f"{kind}_bound"][0],
                           bound_by=r[f"{kind}_bound"][1], library_ms=None))
        for shape, s in fused_shapes.items():
            device_ms[f"{name}_{shape}"] = s[f"{kind}_graph_ms"]
    print("device ms by CUDA-graph replay: " + ", ".join(f"{k} {v:.4f}" for k, v in device_ms.items()))
    del pts
    torch.cuda.empty_cache()
    for r in report:
        print(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}, library {r['library_ms']}), max abs err {r['max_abs_err']:.3e}")

    # ---- the main paths: flagship train steps ----------------------------
    joint = opt.TrainStepFlags(freeze_sigma=False, freeze_rgb=True, freeze_poses=False, do_occ_update=False)
    frozen = joint._replace(freeze_poses=True)
    occ = joint._replace(do_occ_update=True)
    wrappers = (cp_kernel.cp_fwd, cp_kernel.cp_bwd, pdf_kernel.pdf_sample, fe.interp_fwd, fe.interp_dpts)
    plan = [("joint", joint)] * 6 + [("frozen", frozen)] * 4 + [("occ_update", occ)] * 2
    n_steps, n_pose = len(plan), sum(1 for _, f in plan if not f.freeze_poses)
    paths = {}

    # the default hash-off triad: B1-B3 once per step
    step, state, mask, paths["hash_off"] = _drive(
        "hash-off triad", opt, cfg, cube, state, window, plan, wrappers,
        {"cp_fwd": n_steps, "cp_bwd": n_steps, "pdf_sample": n_steps, "interp_fwd": 0, "interp_dpts": 0})
    for r in report[:3]:
        r["launches"] = paths["hash_off"]["launches"][r["name"]]
    _profile(_steps(step, state, window, joint, mask), 5, paths["hash_off"]["step_ms"]["joint"],
             out_dir / "step_profile.txt")
    del step, state, window
    torch.cuda.empty_cache()

    # the triad with its hash level: B1-B4 once per step, B5 once per step
    # with pose gradients (a pose-frozen step needs no point gradient)
    hcfg, hcube, hstate, hwindow = flagship(device=dev, cfg=hash_cfgs["triad_hash"])
    step, hstate, mask, paths["triad_hash"] = _drive(
        "hash-on triad", opt, hcfg, hcube, hstate, hwindow, plan, wrappers,
        {"cp_fwd": n_steps, "cp_bwd": n_steps, "pdf_sample": n_steps, "interp_fwd": n_steps, "interp_dpts": n_pose})
    for r in report[3:]:
        r["launches"] = paths["triad_hash"]["launches"][r["name"]]
    _profile(_steps(step, hstate, hwindow, joint, mask), 5, paths["triad_hash"]["step_ms"]["joint"],
             out_dir / "step_profile_hash.txt")
    del step, hstate, hwindow
    torch.cuda.empty_cache()

    # the 16-level FusedHash field: no CP term; B3, B4 once per step, B5 per
    # step with pose gradients
    fplan = [("joint", joint)] * 4 + [("frozen", frozen)] * 3
    fcfg, fcube, fstate, fwindow = flagship(device=dev, cfg=hash_cfgs["fused"])
    step, fstate, mask, paths["fused"] = _drive(
        "fused", opt, fcfg, fcube, fstate, fwindow, fplan, wrappers,
        {"cp_fwd": 0, "cp_bwd": 0, "pdf_sample": len(fplan), "interp_fwd": len(fplan),
         "interp_dpts": sum(1 for _, f in fplan if not f.freeze_poses)})
    _profile(_steps(step, fstate, fwindow, joint, mask), 5, paths["fused"]["step_ms"]["joint"],
             out_dir / "step_profile_fused.txt")
    del step, fstate, fwindow
    torch.cuda.empty_cache()

    # ---- the probes: each probe script's port at its default sizes -------
    probe_wrappers = wrappers + (cp_kernel.cp_fwd_gather, gs.row_scatter_add, gs.row_gather, gs.col_gather,
                                 gs.lane_gather, gs.sublane_gather, gs.two_stage_gather)
    probes = _run_probes(probe_wrappers)
    for r in probe_entries:
        r["launches"] = sum(p["launches"][r["name"]] for p in probes.values())
    report += probe_entries

    # ---- the online SLAM loop: cfg/defaults.yaml on the synthetic loop ----
    slam = _online_slam(Path(__file__).resolve().parent, out_dir, wrappers)
    for r in report[:3]:
        r["slam_launches"] = slam["launches"][r["name"]]

    # ---- the users' drivers: run_slam over an on-disk sequence, the offline
    # FDT optimization, and the port of bench.py ----------------------------
    cli = _cli_drive(Path(__file__).resolve().parent, out_dir, wrappers)
    forest = _forest_keyframes()
    offline = _offline_leg(out_dir, wrappers, dev, forest)
    bench_res = _bench(wrappers)
    for r in report[:3]:
        r.update(cli_launches=cli["launches"][r["name"]], offline_launches=offline["launches"][r["name"]],
                 bench_launches=bench_res["launches"][r["name"]])

    # ---- 3j: the encoder experiment at full width, the hash-on encoders -------
    encoder_exp = _encoder_experiment_leg(out_dir, wrappers, dev, forest)
    for r in report[:5]:
        r["exp_encoder_launches"] = encoder_exp["launches"][r["name"]]

    # ---- 3e: loop closure at the reference operating point; 3f: the
    # camera phase at full width ---------------------------------------------
    root = Path(__file__).resolve().parent
    loop = _loop_closure_leg(out_dir, wrappers, dev)
    pose_graph = loop.pop("pose_graph_inputs")
    camera = _camera_leg(root, out_dir, wrappers, dev)
    for r in report[:3]:
        r.update(loop_closure_launches=loop["launches"][r["name"]], camera_launches=camera["launches"][r["name"]])

    # ---- 3g: the map tools and the debug dumps on the CLI drive's run -------
    map_tools = _map_tools_leg(root, out_dir, wrappers, dev)
    for r in report[:3]:
        r.update(map_tools_launches={part: n[r["name"]] for part, n in map_tools["launches"].items()},
                 debug_run_launches=map_tools["debug_run"]["launches"][r["name"]])

    # ---- 3h: the alternate encoders at full width, and the data prep -------
    encoders = _encoders_leg(out_dir, wrappers, dev, forest, (joint, frozen, occ))
    report[2]["encoders_launches"] = {**{k: v["launches"]["pdf_sample"] for k, v in encoders["steps"].items()},
                                      "cell_offline": encoders["cell_offline"]["launches"]["pdf_sample"]}

    # ---- 3i: the multi-device layer on meshes of cuda:0 ---------------------
    parallel = _parallel_leg(root, out_dir, wrappers, dev, forest, pose_graph)
    del forest, pose_graph
    for r in report:
        r["parallel_launches"] = {part: n.get(r["name"], 0) for part, n in parallel["launches"].items()}

    # ---- reduced depth: the card's step against the CPU's ----------------
    # f32 sums run in other orders on the two devices (bound 1e-4); with the
    # bf16 MLP an operand on a rounding boundary can also round one bf16 ulp
    # (2^-8) apart, which bounds the normwise gradient difference
    reduced = {}
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2.0**-8)):
        reduced[dtype] = _card_vs_cpu(opt, flagship, cfg._replace(nerf=cfg.nerf._replace(compute_dtype=dtype)),
                                      dev, joint, tol, f"hash off, {dtype} MLP")
    # The hash tables are scaled from their init (1e-4) to 0.1: at init the
    # FusedHash field is near zero everywhere. Where sigma is that small,
    # alpha = 1 - exp(-delta*sigma) is exactly 0 on one device and one ulp on
    # the other, so the FusedHash comparison uses the L2 selection, smooth at
    # 0 (the L1 loss |w - w_gt| is not differentiable there).
    # Its finest level has 2^19 cells across the cube, 32 f32 ulps of a
    # coordinate each, so the ulps by which the two devices' rays differ move
    # points across cell borders, where the cell-local feature and its point
    # gradient jump: its whole step is reported, not held; its field is held
    # from the same rays and samples.
    for k, hc in hash_cfgs.items():
        hc = hc._replace(nerf=hc.nerf._replace(compute_dtype="float32"))
        if k == "fused":
            hc = hc._replace(loss=hc.loss._replace(loss_selection="L2_JS"))
        reduced[k] = _card_vs_cpu(opt, flagship, hc, dev, joint, 1e-4, f"{k}, float32 MLP, {hc.loss.loss_selection}",
                                  whole_step_gated=k != "fused", hash_scale=1e3)
    reduced.update(_encoders_reduced(dev, joint))

    summary = {"card": smi, "paths": paths, "online_slam": slam, "cli_drive": cli, "offline_fdt": offline,
               "bench": bench_res, "encoder_experiment": encoder_exp, "loop_closure": loop, "camera": camera, "map_tools": map_tools,
               "encoders": encoders, "parallel": parallel, "reduced_step": reduced, "fused_kernel_shapes": fused_shapes,
               "pdf_sample_graph_ms": b3_graph, "device_ms": device_ms, "probe_kernels": probe_kernels, "probes": probes,
               "kernels": report}
    (out_dir / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
