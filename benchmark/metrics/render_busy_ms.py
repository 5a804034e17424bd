"""Device milliseconds a virtual scan keeps the card busy: the union of the
device's intervals in the traced stretch, over its scans (as
``step_busy_ms`` over train steps)."""
from benchmark.metrics.step_busy_ms import read  # noqa: F401
