"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds."""
from __future__ import annotations

import copy
from pathlib import Path

from benchmark.harness import load_cell

CHECKOUT = Path(__file__).resolve().parents[2]


def tiny_cell(name: str):
    cell = load_cell(CHECKOUT, name)
    cell.config = copy.deepcopy(cell.config)
    cell.mix = copy.deepcopy(cell.mix)
    cell.mix["sensor"].update(channels=8, azimuth=64, scan_points=384, sky_points=64)
    if "lap" in cell.mix:
        cell.mix["lap"]["keyframes"] = 4
    for c in cell.mix.get("circles", []):
        c["poses"] = 3
    if "offline" in cell.mix:
        cell.mix["offline"].update(window_size=2, iterations_per_window=3, n_eval_scans=2, eval_rays_per_scan=32)
        cell.mix["forest"]["trees"] = 12
    cell.mix.update({k: v for k, v in (("chunk_rays", 128), ("check_chunks", 2), ("trace_requests", 1))
                     if k in cell.mix})
    t = cell.config["train"]
    t.update(window_size=3, rays_per_kf=32, sky_rays_per_kf=8, n_samples_train=64, n_samples_test=64,
             occ_voxels=16, occ_every=2, burn_in_iterations=4, iterations_per_keyframe=3)
    f = cell.config["field"]
    if f["encoder"] == "fused":
        f.update(hash_levels=4, hash_log2_entries=12, hash_log2_cells=10)
    return cell
