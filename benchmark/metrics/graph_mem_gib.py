"""GiB of device memory that the train step's CUDA graphs hold: their pool,
where a captured step's activations and outputs live from capture to
capture, and their static input buffers; the most that one step's graphs
held in the run (``loner_tpu_torch/mapping/step_graph.py``'s
``peak_held_bytes``). ``peak_mem_gib.map`` reads what is allocated in the
window, which leaves this memory out, since a replay allocates only its
outputs' copies. None where the program has no graphs of its step or
captured none."""


def read(ctx):
    try:
        from loner_tpu_torch.mapping.step_graph import peak_held_bytes
    except ImportError:
        return None
    return peak_held_bytes / 2**30 if peak_held_bytes > 0 else None
