"""Percent of the card's dense peak for the configuration's compute dtype
that the measured window's virtual scans reach: the FLOPs a scan requires
(``roofline/counts.py``: the MLP's forward GEMMs and the encoder's
interpolation at every sample), over the window's time (as ``step_mfu``
over train steps)."""
from benchmark.metrics.step_mfu import read  # noqa: F401
