"""iDDPM Gaussian diffusion: the q process, the learned-range variance, the
variational bound and the training losses.

Port of the training half of pixart_sigma_tpu/diffusion/gaussian.py, with
the same channel-last layout ([B, H, W, C]; the learned-variance head is the
second half of the last axis), for what the trainer runs: an epsilon or x0
prediction, the learned-range variance (or none) and the MSE (+ VB) loss.
The KL losses, the fixed variances, the SNR-switching objective and Min-SNR
weighting, the masked-token losses and the sampling loops are not ported
(the port samples with DPM-Solver, `diffusion/dpm_solver.py`).
"""

from __future__ import annotations

import enum
import math
from typing import Any, Callable, Dict, Optional

import torch

from pixart_sigma_tpu_torch.diffusion.likelihood import (
    discretized_gaussian_log_likelihood,
    mean_flat,
    normal_kl,
)
from pixart_sigma_tpu_torch.diffusion.schedules import ScheduleCoefficients, extract

ModelFn = Callable[..., torch.Tensor]


class ModelMeanType(enum.Enum):
    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


class LossType(enum.Enum):
    MSE = enum.auto()
    RESCALED_MSE = enum.auto()
    KL = enum.auto()
    RESCALED_KL = enum.auto()


class GaussianDiffusion:
    """Schedule coefficients + the diffusion's configuration."""

    def __init__(
        self,
        coef: ScheduleCoefficients,
        model_mean_type: ModelMeanType = ModelMeanType.EPSILON,
        model_var_type: Optional[ModelVarType] = ModelVarType.LEARNED_RANGE,
        loss_type: LossType = LossType.MSE,
    ):
        if model_mean_type not in (ModelMeanType.EPSILON, ModelMeanType.START_X):
            raise NotImplementedError(f"{model_mean_type} is not ported")
        if model_var_type not in (None, ModelVarType.LEARNED_RANGE):
            raise NotImplementedError(f"{model_var_type} is not ported")
        if loss_type not in (LossType.MSE, LossType.RESCALED_MSE):
            raise NotImplementedError(f"{loss_type} is not ported")
        self.coef = coef
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.loss_type = loss_type

    @property
    def num_timesteps(self) -> int:
        return self.coef.num_timesteps

    def q_sample(self, x_start, t, noise):
        """Diffuse x_start to timestep t given unit Gaussian noise."""
        c, nd = self.coef, x_start.ndim
        return (extract(c.sqrt_alphas_cumprod, t, nd) * x_start
                + extract(c.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        """Mean, variance and log-variance of q(x_{t-1} | x_t, x_0)."""
        c, nd = self.coef, x_t.ndim
        mean = (extract(c.posterior_mean_coef1, t, nd) * x_start
                + extract(c.posterior_mean_coef2, t, nd) * x_t)
        return (mean, extract(c.posterior_variance, t, nd),
                extract(c.posterior_log_variance_clipped, t, nd))

    def predict_xstart_from_eps(self, x_t, t, eps):
        c, nd = self.coef, x_t.ndim
        return (extract(c.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - extract(c.sqrt_recipm1_alphas_cumprod, t, nd) * eps)

    def model_variance(self, model_var_values, x_t, t):
        """(variance, log_variance) of p(x_{t-1} | x_t) from the second half
        of the model output, interpolated in log space between the posterior
        variance and beta_t."""
        c, nd = self.coef, x_t.ndim
        min_log = extract(c.posterior_log_variance_clipped, t, nd)
        max_log = extract(c.log_betas, t, nd)
        frac = (model_var_values + 1.0) / 2.0
        log_variance = frac * max_log + (1.0 - frac) * min_log
        return torch.exp(log_variance), log_variance

    def _split_output(self, model_output, x_t):
        """Split a learned-variance model output along the last axis."""
        C = x_t.shape[-1]
        if self.model_var_type is None:
            return model_output, None
        if model_output.shape[-1] != 2 * C:
            raise ValueError(f"expected 2*{C} channels, got {model_output.shape[-1]}")
        return model_output[..., :C], model_output[..., C:]

    def _pred_xstart(self, x_t, t, out):
        if self.model_mean_type == ModelMeanType.EPSILON:
            return self.predict_xstart_from_eps(x_t, t, out)
        return out

    def p_mean_variance(self, model_output, x_t, t, clip_denoised: bool = True):
        """Mean/variance of p(x_{t-1} | x_t) and the implied x0 prediction."""
        out, var_values = self._split_output(model_output, x_t)
        variance, log_variance = self.model_variance(var_values, x_t, t)
        pred_xstart = self._pred_xstart(x_t, t, out)
        if clip_denoised:
            pred_xstart = pred_xstart.clamp(-1.0, 1.0)
        mean = self.q_posterior_mean_variance(pred_xstart, x_t, t)[0]
        return {"mean": mean, "variance": variance, "log_variance": log_variance,
                "pred_xstart": pred_xstart}

    def vb_terms_bpd(self, model_output, x_start, x_t, t, clip_denoised: bool = False):
        """Variational-bound term (bits/dim) for one timestep: the KL of the
        posteriors for t > 0, the decoder NLL at t = 0."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model_output, x_t, t, clip_denoised=clip_denoised)
        kl = mean_flat(normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"]))
        kl = kl / math.log(2.0)
        nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
        nll = mean_flat(nll) / math.log(2.0)
        return {"output": torch.where(t == 0, nll, kl), "pred_xstart": out["pred_xstart"]}

    def training_losses(self, model_fn: ModelFn, x_start: torch.Tensor, t: torch.Tensor,
                        noise: torch.Tensor) -> Dict[str, Any]:
        """Per-sample losses {"loss", "mse", "vb"?, "pred_xstart", "x_t"}, each
        [B]. The noise is passed in (the caller draws it from its generator).
        With a learned variance, the VB term trains the variance only: the
        mean half of the output is detached there."""
        x_t = self.q_sample(x_start, t, noise)
        output, var_values = self._split_output(model_fn(x_t, t), x_t)
        terms: Dict[str, Any] = {}
        if var_values is not None:
            frozen = torch.cat([output.detach(), var_values], dim=-1)
            terms["vb"] = self.vb_terms_bpd(frozen, x_start, x_t, t)["output"]
            if self.loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)
        target = noise if self.model_mean_type == ModelMeanType.EPSILON else x_start
        terms["mse"] = mean_flat((target - output) ** 2)
        terms["loss"] = terms["mse"] + terms.get("vb", 0.0)
        terms["pred_xstart"] = self._pred_xstart(x_t, t, output)
        terms["x_t"] = x_t
        return terms
