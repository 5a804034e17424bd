"""B3, the OGM sampler's inverse-CDF kernel: counted, with no roofline yet."""

TRACE_NAME = "pdf_sample_kernel"
COUNTER = "loner_tpu_torch.ops.pdf_kernel:pdf_sample"
