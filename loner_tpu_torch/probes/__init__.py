"""Memory-primitive probes: the ports of the Pallas probe scripts in
``scripts/`` (``bench_pallas_scatter``, ``bench_gather``, ``bench_gather2``,
``bench_dyngather``, ``bench_lane_gather``, ``bench_honest``), one module of
the same name each, run as ``python -m loner_tpu_torch.probes.<name>``.

Each times the script's legs on the card (``--device cpu`` runs them on the
CPU at small sizes, with the kernels' plain versions), prints one line per
leg and returns the legs from ``main(argv)``: ``ms`` per call (or per
chained iteration), an error against the leg's plain counterpart where the
script computes one, and the kernel launches. Every exception propagates.
"""
