"""The comparison that decides ``correct`` for a training cell.

Numbers, each held to a limit of its own (``limits/<cell>.json``; a number
the limits do not name is printed, not held):

* ``loss_gap``: the largest relative gap between the program's loss and the
  reference's over the compared steps.
* ``grad_gap``: per parameter leaf, the gap between the norms of the
  program's and the reference's first gradient (as the optimizer gets it),
  over the reference's norm of that leaf or of its group's median leaf,
  whichever is larger; the worst leaf. Groups: the sigma leaves (first
  step), the occupancy grid (its first update).
* ``change_gap``: the same for each leaf's change (sigma leaves after three
  steps, the grid at its first update). A leaf whose reference gradient is
  under a thousandth of its group's median leaf's moves under Adam by
  round-off alone and is left out.
* ``pose_grad_gap``: the same for the poses' first gradient (the first
  joint step).
* ``pose_change_gap``, ``pose_moment_gap``: the same for the poses' change
  and their first Adam moment after three joint steps. Adam's first steps
  move each pose component by about the learning rate whatever its
  gradient's size, so a component whose gradient is near nought turns
  rounding into a visible change, and the gradients of the steps after it
  follow: both swing from seed to seed.
* ``pose_rows_gap``: the number of keyframe poses that one side moved over
  the three joint steps and the other left as they were (exact: 0).

A reading the program does not have (a step it skipped) reads infinite.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

from benchmark.reference.train import Readings

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "pose_grad_gap", "pose_change_gap", "pose_moment_gap",
           "pose_rows_gap")


def _group(name: str) -> str:
    return name.split(".")[0]


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], ref_grads: Dict[str, float], skip_small: bool) -> dict:
    groups: Dict[str, list] = {}
    for name, r in ref.items():
        groups.setdefault(_group(name), []).append(r)
    grad_groups: Dict[str, list] = {}
    for name, g in ref_grads.items():
        grad_groups.setdefault(_group(name), []).append(g)
    gaps = {}
    for name, r in ref.items():
        if skip_small and name in ref_grads:
            med_g = statistics.median(grad_groups[_group(name)])
            if ref_grads[name] < 1e-3 * med_g:
                continue
        base = max(r, statistics.median(groups[_group(name)]))
        p = prog.get(name)
        if p is None or not math.isfinite(p):
            gaps[name] = math.inf
        elif base == 0:  # nothing moves in the reference: the program must not move either
            gaps[name] = 0.0 if p == 0 else math.inf
        else:
            gaps[name] = abs(p - r) / base
    return gaps


def compare(prog: Readings, ref: Readings) -> Dict[str, float]:
    """The numbers, and each leaf's gap under ``"<number>.<leaf>"``."""
    loss = {}
    for i, r in ref.losses.items():
        p = prog.losses.get(i)
        loss[f"step{i}"] = math.inf if p is None or not math.isfinite(p) else abs(p - r) / max(abs(r), 1e-30)
    def split(d):
        return {k: v for k, v in d.items() if k != "poses"}, {k: v for k, v in d.items() if k == "poses"}

    grads, pose_grads = split(ref.grads)
    changes, pose_changes = split(ref.changes)
    parts = {
        "loss_gap": loss,
        "grad_gap": _leaf_gaps(prog.grads, grads, ref.grads, skip_small=False),
        "change_gap": _leaf_gaps(prog.changes, changes, ref.grads, skip_small=True),
        "pose_grad_gap": _leaf_gaps(prog.grads, pose_grads, ref.grads, skip_small=False),
        "pose_change_gap": _leaf_gaps(prog.changes, pose_changes, ref.grads, skip_small=False),
        "pose_moment_gap": _leaf_gaps(prog.moments, ref.moments, ref.grads, skip_small=False),
    }
    parts["pose_rows_gap"] = {leaf: float(len(set(rows) ^ set(prog.moved[leaf]))) if leaf in prog.moved else math.inf
                              for leaf, rows in ref.moved.items()}
    out = {k: max(v.values()) for k, v in parts.items() if v}
    for k, v in parts.items():
        out.update({f"{k}.{leaf}": g for leaf, g in v.items()})
    return out


def verdict(numbers: Dict[str, float], limits: Optional[dict]) -> bool:
    """True when there are limits and every number they name is within its
    limit."""
    return bool(limits) and all(numbers.get(k, math.inf) <= v for k, v in limits.items())
