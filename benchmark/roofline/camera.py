"""Operations of one camera step (``mapping/camera_optimizer.py``) of the
decoupled field, from shapes: what the step requires, not what it runs.

For ``n`` points: the sigma grid's interpolation (B4) and the sigma MLP's
forward, with no gradient; the intensity grid's interpolation and its
exact table gradient; the SH basis of the view direction; the colour MLP's
forward and its two backward GEMMs (the weights' and the inputs'
gradients, each as many operations as the forward). The pose-frozen step
takes no point gradient (B5)."""
from __future__ import annotations

from benchmark.reference.encoders.fused_rgb import intensity_grid
from benchmark.roofline.counts import mlp_forward_flops
from benchmark.roofline.kernels import hash_fwd, rgb_dtable

# the multiplies and adds of the 16 real SH functions of degree 4 from a
# unit direction (reference/camera.py sh_basis): the six products of two
# coordinates, then 3, 8 and 25 for the bands l = 1, 2, 3
SH4_FLOPS = 6 + 3 + 8 + 25


def colour_mlp_forward_flops(n: int, field: dict) -> float:
    grid = intensity_grid(field)
    dims = ([grid["hash_levels"] * grid["hash_features"] + field["sh_degree"] ** 2]
            + [field["intensity_hidden_dim"]] * field["intensity_hidden_layers"] + [field["num_colors"]])
    return 2.0 * n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def sh_flops(n: int, field: dict) -> float:
    if field["sh_degree"] != 4:
        raise ValueError(f"sh_degree {field['sh_degree']}: counted for degree 4 only")
    return float(SH4_FLOPS * n)


def camera_step_flops(n: int, field: dict) -> float:
    sigma_interp = hash_fwd.counts(n, *hash_fwd.shape(field))[1]
    grid = intensity_grid(field)
    lv, f = grid["hash_levels"], grid["hash_features"]
    intensity = hash_fwd.counts(n, lv, f)[1] + rgb_dtable.counts(n, *rgb_dtable.shape(field))[1]
    return (sigma_interp + mlp_forward_flops(n, field) + intensity + sh_flops(n, field)
            + 3.0 * colour_mlp_forward_flops(n, field))
