"""The flags of the cfg ``debug:`` block's visual dumps.

A copy of ``DebugFlags`` from ``loner_tpu/runtime/debug_dump.py``, the
configuration only: the dumps themselves (ICP clouds, ray and sample clouds,
loss histograms) are not ported, and the tracker and mapper raise
``NotImplementedError`` when a flag would turn one on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

DRAW_FLAGS = ("draw_icp_clouds", "draw_rays", "draw_samples", "draw_loss_distribution")


@dataclass
class DebugFlags:
    global_enabled: bool = False
    draw_icp_clouds: bool = False
    draw_rays: bool = False
    draw_samples: bool = False
    draw_loss_distribution: bool = False
    dump_dir: Optional[str] = None

    def requested(self, names=DRAW_FLAGS) -> list:
        """The flags of ``names`` that ask for a dump (with ``global_enabled``)."""
        return [n for n in names if self.global_enabled and getattr(self, n)]
