"""Training losses: the lidar loss (truncated-Gaussian line-of-sight
targets, the JS-divergence dynamic tolerance, depth MSE and opacity) and the
camera phase's L1 intensity loss.

The port of ``loner_tpu/models/losses.py`` (``LossConfig``,
``get_weights_gt``, the KL/JS helpers, ``compute_lidar_loss``,
``compute_camera_loss``). Every
reduction is mask-aware, so padded and invalid rays drop out.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class LossConfig(NamedTuple):
    loss_selection: str = "L1_JS"  # L1_LOS | L2_LOS | L1_JS | L2_JS
    min_js_score: float = 1.0
    max_js_score: float = 10.0
    js_alpha: float = 1.0
    decay_los_lambda: bool = False
    los_lambda: float = 1000.0
    min_los_lambda: float = 10.0
    los_lambda_decay_rate: float = 0.001
    los_lambda_decay_steps: float = 15000.0
    decay_depth_eps: bool = True
    depth_eps: float = 3.0
    min_depth_eps: float = 0.5
    depth_eps_decay_rate: float = 0.95
    depth_eps_decay_steps: float = 1.0
    depthloss_lambda: float = 0.005
    cam_lambda: float = 1.0  # the camera loss's weight


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    count = torch.clamp(torch.sum(m), min=1.0)
    return torch.sum(x * m) / count


def get_weights_gt(sampled_depth: torch.Tensor, gt_depth: torch.Tensor, eps) -> torch.Tensor:
    """Truncated-Gaussian target weights around the measured depth:
    sigma = eps/9, support clipped to +-eps, rows normalised."""
    sigma = eps / 9.0
    x = (sampled_depth - gt_depth) / sigma
    pdf = (1.0 / math.sqrt(2.0 * math.pi)) * torch.exp(-0.5 * x * x) / sigma
    # cdf(9) - cdf(-9), kept for parity with the reference formula
    denom = 0.5 * (1 + math.erf(9.0 / math.sqrt(2.0))) - 0.5 * (1 + math.erf(-9.0 / math.sqrt(2.0)))
    w = pdf / denom
    # a step function: its gradient is zero (torch.heaviside has no autograd)
    zero = torch.zeros_like(sampled_depth)
    inside = torch.heaviside((sampled_depth - (gt_depth - eps)).detach(), zero) * torch.heaviside(
        ((gt_depth + eps) - sampled_depth).detach(), zero
    )
    w = w * inside
    return w / (torch.sum(w, dim=1, keepdim=True) + 1e-6)


def kl_divergence_gaussians(mean1, std1, mean2, std2):
    var1 = std1 * std1
    var2 = std2 * std2
    return torch.log(std2 / std1) + (var1 + (mean1 - mean2) ** 2) / (2.0 * var2) - 0.5


def js_divergence_gaussians(mean1, std1, mean2, std2):
    """JS divergence of two Gaussians by the mixture-moment approximation."""
    mean_m = 0.5 * (mean1 + mean2)
    std_m = 0.5 * torch.sqrt(std1**2 + std2**2)
    return 0.5 * kl_divergence_gaussians(mean1, std1, mean_m, std_m) + 0.5 * kl_divergence_gaussians(
        mean2, std2, mean_m, std_m
    )


def _floor(x, lo: float):
    return torch.clamp(x, min=lo) if isinstance(x, torch.Tensor) else max(x, lo)


# Python numbers stay Python numbers here: a host scalar copied to the card
# would make every step wait for the device.
def los_lambda_at_step(cfg: LossConfig, global_step):
    """The LOS weight; ``global_step`` is a number or a float tensor."""
    if not cfg.decay_los_lambda:
        return cfg.los_lambda
    lam = cfg.los_lambda * cfg.los_lambda_decay_rate ** ((global_step + 1.0) / cfg.los_lambda_decay_steps)
    return _floor(lam, cfg.min_los_lambda)


def depth_eps_at_iteration(cfg: LossConfig, iteration):
    """The LOS-loss depth tolerance; ``iteration`` is a number or a float tensor."""
    if not cfg.decay_depth_eps:
        return cfg.depth_eps
    eps = cfg.depth_eps * cfg.depth_eps_decay_rate ** (iteration / cfg.depth_eps_decay_steps)
    return _floor(eps, cfg.min_depth_eps)


def compute_lidar_loss(render, bundle, scale_factor: float, cfg: LossConfig, global_step, iteration,
                       return_per_ray: bool = False) -> Tuple[torch.Tensor, dict]:
    """(scalar loss, aux dict): depth MSE + LOS/JS + opacity, mask-aware.
    ``global_step`` and ``iteration`` drive the optional decays.
    ``return_per_ray`` (the debug probe's) adds the per-ray vectors before
    their means as ``aux["per_ray"]``."""
    valid = bundle.valid
    depth_gt_cube = bundle.depth
    transparent = depth_gt_cube > bundle.far
    opaque = (depth_gt_cube > 0) & (~transparent) & valid

    z_metric = render.z_vals * scale_factor
    depth_gt_metric = (depth_gt_cube * scale_factor)[:, None]
    w_pred = render.weights

    w_sum = torch.sum(w_pred, dim=1) + 1e-10
    mean = torch.sum(z_metric * w_pred, dim=1) / w_sum
    var = torch.sum((z_metric - mean[:, None]) ** 2 * w_pred, dim=1) / w_sum + 1e-10
    std = torch.sqrt(var)

    eps_min = cfg.min_depth_eps
    js = js_divergence_gaussians(depth_gt_metric[:, 0], eps_min / 3.0, mean, std)

    depth_pred_metric = render.depth * scale_factor
    depth_mse = _masked_mean((depth_pred_metric - depth_gt_metric[:, 0]) ** 2, opaque)

    if cfg.loss_selection in ("L1_JS", "L2_JS"):
        js_c = torch.where(js < cfg.min_js_score, torch.zeros_like(js), js)
        js_c = torch.where(js_c > cfg.max_js_score, torch.full_like(js_c, cfg.max_js_score), js_c)
        eps = (eps_min * (1.0 + cfg.js_alpha * js_c)).detach()[:, None]
    elif cfg.loss_selection in ("L1_LOS", "L2_LOS"):
        eps = depth_eps_at_iteration(cfg, iteration)
    else:
        raise ValueError(f"Unknown loss selection {cfg.loss_selection}")

    w_gt = get_weights_gt(z_metric, depth_gt_metric, eps)
    w_gt = torch.where(opaque[:, None], w_gt, torch.zeros_like(w_gt))

    err = w_pred - w_gt
    per_elem = torch.abs(err) if cfg.loss_selection in ("L1_JS", "L1_LOS") else err * err
    los_loss = _masked_mean(torch.mean(per_elem, dim=1), valid)
    opacity_loss = _masked_mean(torch.abs(render.opacity - 1.0), opaque)

    lam = los_lambda_at_step(cfg, global_step)
    loss = cfg.depthloss_lambda * depth_mse + lam * los_loss + opacity_loss

    eps_mean = _masked_mean(eps[:, 0], valid) if isinstance(eps, torch.Tensor) and eps.dim() == 2 else eps
    aux = {
        "depth_mse": depth_mse,
        "los_loss": los_loss,
        "opacity_loss": opacity_loss,
        "los_lambda": lam,
        "depth_eps": eps_mean,
        "js_mean": _masked_mean(js, valid),
        "pred_depth_std": _masked_mean(std, valid),
        "n_opaque": torch.sum(opaque.to(torch.float32)),
        "n_valid": torch.sum(valid.to(torch.float32)),
    }
    if return_per_ray:
        aux["per_ray"] = {
            "depth_err_m": depth_pred_metric - depth_gt_metric[:, 0],
            "js": js,
            "los": torch.mean(per_elem, dim=1),
            "valid": valid,
            "opaque": opaque,
        }
    return loss, aux


def compute_camera_loss(render, intensities_gt: torch.Tensor, valid: torch.Tensor, cfg: LossConfig):
    """The masked L1 intensity loss, scaled by ``cam_lambda``; (loss, aux)."""
    err = torch.abs(render.rgb - intensities_gt)
    loss = cfg.cam_lambda * _masked_mean(torch.mean(err, dim=-1), valid)
    return loss, {"cam_l1": loss}
