"""The repo's quality experiments: the ports of ``scripts/exp_encoder_flagship.py``
and ``scripts/exp_quality_flagship.py``, one module of the same name each,
run as ``python -m loner_tpu_torch.experiments.<name>``.

Each takes its script's flags, with ``--device`` (default ``cuda``) in place
of ``--cpu``, writes a JSON record with its script's keys (``"platform"``:
the card's name and power limit, or ``cpu``), and returns the record from
``main(argv)``. ``--small`` runs a harness check at tiny shapes.
"""
import subprocess

import torch


def platform(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
        return out[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"
