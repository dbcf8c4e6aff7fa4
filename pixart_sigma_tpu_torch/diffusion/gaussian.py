"""iDDPM Gaussian diffusion: the q process, the model variances, the
variational bound, the training losses and the sampling loops.

Port of pixart_sigma_tpu/diffusion/gaussian.py, with the same channel-last
layout ([B, H, W, C]; a learned-variance head is the second half of the last
axis): epsilon, x0 or x_{t-1} prediction; learned, learned-range, fixed small
or fixed large variance; the MSE (+ VB) loss; ancestral (`p_sample_loop`),
DDIM (`ddim_sample_loop`) and DDIM-inversion (`ddim_reverse_sample_loop`)
trajectories as Python loops over device tensors; the training loss with
the SNR-switching objective (`snr`), Min-SNR weights (`min_snr_weight`) and
the masked-token per-patch losses, or the variational bound alone (the KL
losses); the diffusers-convention entry (`training_losses_diffusers`), the
LCM one (`training_losses_startx`), and the bound in bits/dim over a whole
chain (`calc_bpd_loop`, `prior_bpd`).

Random draws: a loop takes its initial latent from the caller and its
per-step noise from `noise_fn(k, shape)`, the k-th draw of the trajectory
(`diffusion/noise.py`); JAX splits keys instead (ROADMAP.md, Queue 3).
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
from pixart_sigma_tpu_torch.diffusion.noise import NoiseFn
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

    def is_vb(self) -> bool:
        return self in (LossType.KL, LossType.RESCALED_KL)


class GaussianDiffusion:
    """Schedule coefficients + the diffusion's configuration."""

    def __init__(
        self,
        coef: ScheduleCoefficients,
        model_mean_type: ModelMeanType = ModelMeanType.EPSILON,
        model_var_type: Optional[ModelVarType] = ModelVarType.LEARNED_RANGE,
        loss_type: LossType = LossType.MSE,
        snr: bool = False,
    ):
        if snr and model_mean_type == ModelMeanType.PREVIOUS_X:
            raise NotImplementedError("the snr objective with x_{t-1} prediction")
        self.coef = coef
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.loss_type = loss_type
        self.snr = snr

    @property
    def num_timesteps(self) -> int:
        return self.coef.num_timesteps

    def to(self, device) -> "GaussianDiffusion":
        """Move the coefficient tables to `device` (sampling gathers from
        them every step)."""
        self.coef = self.coef.to(device)
        return self

    def q_mean_variance(self, x_start, t):
        """Mean, variance and log-variance of q(x_t | x_0)."""
        c, nd = self.coef, x_start.ndim
        return (extract(c.sqrt_alphas_cumprod, t, nd) * x_start,
                extract(1.0 - c.alphas_cumprod, t, nd),
                extract(c.log_one_minus_alphas_cumprod, t, nd))

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

    def predict_eps_from_xstart(self, x_t, t, pred_xstart):
        c, nd = self.coef, x_t.ndim
        return ((extract(c.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart)
                / extract(c.sqrt_recipm1_alphas_cumprod, t, nd))

    def predict_xstart_from_xprev(self, x_t, t, xprev):
        c, nd = self.coef, x_t.ndim
        coef1 = extract(c.posterior_mean_coef1, t, nd)
        coef2 = extract(c.posterior_mean_coef2, t, nd)
        return xprev / coef1 - (coef2 / coef1) * x_t

    def model_variance(self, model_var_values, x_t, t):
        """(variance, log_variance) of p(x_{t-1} | x_t). Learned range: the
        second half of the model output interpolates in log space between
        the posterior variance and beta_t; learned: it is the log-variance;
        fixed: a table (the output half is ignored)."""
        c, nd = self.coef, x_t.ndim
        if self.model_var_type == ModelVarType.LEARNED:
            return torch.exp(model_var_values), model_var_values
        if self.model_var_type == ModelVarType.FIXED_LARGE:
            return (extract(c.fixed_large_variance, t, nd),
                    extract(c.fixed_large_log_variance, t, nd))
        if self.model_var_type == ModelVarType.FIXED_SMALL:
            return (extract(c.posterior_variance, t, nd),
                    extract(c.posterior_log_variance_clipped, t, nd))
        if self.model_var_type != ModelVarType.LEARNED_RANGE:
            raise NotImplementedError(f"no model variance for {self.model_var_type}")
        min_log = extract(c.posterior_log_variance_clipped, t, nd)
        max_log = extract(c.log_betas, t, nd)
        frac = (model_var_values + 1.0) / 2.0
        log_variance = frac * max_log + (1.0 - frac) * min_log
        return torch.exp(log_variance), log_variance

    def _split_output(self, model_output, x_t):
        """Split a learned-variance model output along the last axis."""
        C = x_t.shape[-1]
        if self.model_var_type not in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            return model_output, None
        if model_output.shape[-1] != 2 * C:
            raise ValueError(f"expected 2*{C} channels, got {model_output.shape[-1]}")
        return model_output[..., :C], model_output[..., C:]

    def _pred_xstart(self, x_t, t, out):
        if self.model_mean_type == ModelMeanType.EPSILON:
            return self.predict_xstart_from_eps(x_t, t, out)
        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            return self.predict_xstart_from_xprev(x_t, t, out)
        return out

    def p_mean_variance(self, model_output, x_t, t, clip_denoised: bool = True,
                        denoised_fn: Optional[Callable] = None):
        """Mean/variance of p(x_{t-1} | x_t) and the implied x0 prediction,
        from the raw model output (the caller runs the network)."""
        out, var_values = self._split_output(model_output, x_t)
        variance, log_variance = self.model_variance(var_values, x_t, t)
        pred_xstart = self._pred_xstart(x_t, t, out)
        if denoised_fn is not None:
            pred_xstart = denoised_fn(pred_xstart)
        if clip_denoised:
            pred_xstart = pred_xstart.clamp(-1.0, 1.0)
        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            mean = out
        else:
            mean = self.q_posterior_mean_variance(pred_xstart, x_t, t)[0]
        return {"mean": mean, "variance": variance, "log_variance": log_variance,
                "pred_xstart": pred_xstart}

    # -------------------------------------------------- classifier guidance
    def condition_mean(self, cond_fn, p_mean_var, x, t):
        """The posterior mean shifted by variance * grad log p(y | x);
        `cond_fn(x, t)` returns that gradient (e.g. through
        `torch.autograd.grad`)."""
        gradient = cond_fn(x, t)
        return p_mean_var["mean"].float() + p_mean_var["variance"] * gradient.float()

    def condition_score(self, cond_fn, p_mean_var, x, t):
        """Condition the model's score (Song et al. 2020): eps shifted by
        -sqrt(1 - alpha_bar) * cond_fn(x, t); returns an updated p_mean_var."""
        alpha_bar = extract(self.coef.alphas_cumprod, t, x.ndim)
        eps = self.predict_eps_from_xstart(x, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1.0 - alpha_bar) * cond_fn(x, t)
        out = dict(p_mean_var)
        out["pred_xstart"] = self.predict_xstart_from_eps(x, t, eps)
        out["mean"] = self.q_posterior_mean_variance(out["pred_xstart"], x, t)[0]
        return out

    # ---------------------------------------------------------------- sampling
    @staticmethod
    def _nonzero(t, x):
        """1 where t != 0 (no noise on the last step), shaped to broadcast."""
        return (t != 0).to(x.dtype).reshape(-1, *((1,) * (x.ndim - 1)))

    @staticmethod
    def _loop_t(i: int, x):
        """Loop index i as a [B] tensor."""
        return torch.full((x.shape[0],), i, dtype=torch.long, device=x.device)

    def p_sample(self, model_fn: ModelFn, x, t, noise, clip_denoised: bool = True,
                 denoised_fn: Optional[Callable] = None, cond_fn: Optional[Callable] = None):
        """One ancestral step x_t -> x_{t-1} with the given unit noise;
        returns (sample, pred_xstart)."""
        out = self.p_mean_variance(model_fn(x, t), x, t, clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn)
        if cond_fn is not None:
            out["mean"] = self.condition_mean(cond_fn, out, x, t)
        sample = out["mean"] + self._nonzero(t, x) * torch.exp(0.5 * out["log_variance"]) * noise
        return sample, out["pred_xstart"]

    def p_sample_loop(self, model_fn: ModelFn, noise: torch.Tensor, noise_fn: NoiseFn,
                      clip_denoised: bool = True, denoised_fn: Optional[Callable] = None,
                      cond_fn: Optional[Callable] = None) -> torch.Tensor:
        """The ancestral trajectory from x_T = `noise`: `p_sample` with loop
        index i running T-1 .. 0, taking draw k = T-1-i."""
        x = noise
        T = self.num_timesteps
        for k in range(T):
            z = noise_fn(k, x.shape).to(x.device, x.dtype)
            x, _ = self.p_sample(model_fn, x, self._loop_t(T - 1 - k, x), z,
                                 clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                                 cond_fn=cond_fn)
        return x

    def ddim_sample_loop(self, model_fn: ModelFn, noise: torch.Tensor, noise_fn: NoiseFn,
                         clip_denoised: bool = True, eta: float = 0.0,
                         cond_fn: Optional[Callable] = None) -> torch.Tensor:
        """The DDIM trajectory from x_T = `noise` (eta = 0: deterministic;
        the draws are taken all the same, as JAX's scan takes its keys)."""
        x = noise
        T, c, nd = self.num_timesteps, self.coef, noise.ndim
        for k in range(T):
            t = self._loop_t(T - 1 - k, x)
            out = self.p_mean_variance(model_fn(x, t), x, t, clip_denoised=clip_denoised)
            if cond_fn is not None:
                out = self.condition_score(cond_fn, out, x, t)
            eps = self.predict_eps_from_xstart(x, t, out["pred_xstart"])
            alpha_bar = extract(c.alphas_cumprod, t, nd)
            alpha_bar_prev = extract(c.alphas_cumprod_prev, t, nd)
            sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                     * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
            mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                         + torch.sqrt(1 - alpha_bar_prev - sigma**2) * eps)
            z = noise_fn(k, x.shape).to(x.device, x.dtype)
            x = mean_pred + self._nonzero(t, x) * sigma * z
        return x

    def ddim_reverse_sample(self, model_output, x, t, clip_denoised: bool = True,
                            denoised_fn: Optional[Callable] = None,
                            cond_fn: Optional[Callable] = None, eta: float = 0.0):
        """One deterministic DDIM reverse-ODE step x_t -> x_{t+1} (inversion)."""
        if eta != 0.0:
            raise ValueError("the reverse ODE is deterministic: eta must be 0")
        out = self.p_mean_variance(model_output, x, t, clip_denoised=clip_denoised,
                                   denoised_fn=denoised_fn)
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t)
        c, nd = self.coef, x.ndim
        # eps re-derived, whatever the model predicts
        eps = self.predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar_next = extract(c.alphas_cumprod_next, t, nd)
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_next)
                     + torch.sqrt(1.0 - alpha_bar_next) * eps)
        return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}

    def ddim_reverse_sample_loop(self, model_fn: ModelFn, x: torch.Tensor,
                                 clip_denoised: bool = True) -> torch.Tensor:
        """The whole inversion x_0 -> x_T (t = 0 .. T-1)."""
        for i in range(self.num_timesteps):
            t = self._loop_t(i, x)
            x = self.ddim_reverse_sample(model_fn(x, t), x, t,
                                         clip_denoised=clip_denoised)["sample"]
        return x

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

    def compute_snr(self, t: torch.Tensor) -> torch.Tensor:
        """Signal-to-noise ratio of q(x_t | x_0), alpha_bar / (1 - alpha_bar), f32."""
        acp = self.coef.alphas_cumprod.to(t.device)[t.long()]
        return acp / (1.0 - acp)

    def min_snr_weight(self, t: torch.Tensor, gamma: float,
                       prediction_type: str = "epsilon") -> torch.Tensor:
        """Per-sample Min-SNR-gamma MSE weights: min(snr, gamma) / snr for the
        epsilon objective, min(snr, gamma) / (snr + 1) for v prediction."""
        snr = self.compute_snr(t)
        w = torch.clamp(snr, max=gamma)
        return w / (snr + 1.0) if prediction_type == "v_prediction" else w / snr

    def training_losses(self, model_fn: ModelFn, x_start: torch.Tensor, t: torch.Tensor,
                        noise: Optional[torch.Tensor], loss_weight: Optional[torch.Tensor] = None,
                        mse_weight: Optional[torch.Tensor] = None,
                        mask_loss_coef: float = 0.0, patch_size: int = 2,
                        skip_noise: bool = False) -> Dict[str, Any]:
        """Per-sample losses {"loss", "mse", "vb"?, "mae"?, "pred_xstart",
        "x_t"}, each [B]. The noise is passed in (the caller draws it from its
        generator); `skip_noise` feeds x_start itself to the model (the noise
        is then only the epsilon target). With a learned variance, the VB
        term trains the variance only: the mean half of the output is
        detached there. The KL loss types return {"loss"} alone: the bound's
        term at t in bits/dim (times T for RESCALED_KL).

        `loss_weight` scales each sample's loss (importance sampling),
        `mse_weight` its MSE term only (Min-SNR). A model that returns
        (output, token_mask), token_mask [B, L] with 1 = removed patch, gets
        the MSE per patch (channel mean, patch_size average pool) over its
        kept patches, and with `mask_loss_coef` > 0 an "mae" term over the
        removed ones, each as mean_flat(loss * m) * L / m.sum()."""
        if noise is None and not (skip_noise and self.model_mean_type != ModelMeanType.EPSILON):
            raise ValueError("training_losses needs the noise (the epsilon target)")
        x_t = x_start if skip_noise else self.q_sample(x_start, t, noise)
        model_output = model_fn(x_t, t)
        token_mask = None
        if isinstance(model_output, (tuple, list)):
            model_output, token_mask = model_output
        terms: Dict[str, Any] = {}
        if self.loss_type.is_vb():
            terms["loss"] = self.vb_terms_bpd(model_output, x_start, x_t, t)["output"]
            if self.loss_type == LossType.RESCALED_KL:
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms
        output, var_values = self._split_output(model_output, x_t)
        if var_values is not None:
            frozen = torch.cat([output.detach(), var_values], dim=-1)
            terms["vb"] = self.vb_terms_bpd(frozen, x_start, x_t, t)["output"]
            if self.loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)
        target = {ModelMeanType.EPSILON: lambda: noise, ModelMeanType.START_X: lambda: x_start,
                  ModelMeanType.PREVIOUS_X: lambda: self.q_posterior_mean_variance(
                      x_start, x_t, t)[0]}[self.model_mean_type]()
        pred_xstart = self._pred_xstart(x_t, t, output)
        if self.snr:  # eps prediction for t > 249, x0 below
            if self.model_mean_type == ModelMeanType.START_X:
                pred_noise, pred_startx = self.predict_eps_from_xstart(x_t, t, output), output
            else:
                pred_noise, pred_startx = output, pred_xstart
            eps_branch = (t > 249).reshape(-1, *((1,) * (x_t.ndim - 1)))
            target = torch.where(eps_branch, noise, x_start)
            output = torch.where(eps_branch, pred_noise, pred_startx)
        sq_err = (target - output) ** 2
        if token_mask is not None:
            B, H, W, _ = sq_err.shape
            p = patch_size
            per_patch = sq_err.mean(-1).reshape(B, H // p, p, W // p, p).mean((2, 4))
            per_patch = per_patch.reshape(B, -1)
            token_mask = token_mask.to(per_patch.dtype)
            unmask = 1.0 - token_mask
            L = unmask.shape[1]
            terms["mse"] = mean_flat(per_patch * unmask) * L / unmask.sum(1)
            if mask_loss_coef > 0:
                terms["mae"] = (mask_loss_coef * mean_flat(per_patch * token_mask) * L
                                / token_mask.sum(1))
        else:
            terms["mse"] = mean_flat(sq_err)
        if mse_weight is not None:
            terms["mse"] = terms["mse"] * mse_weight
        terms["loss"] = terms["mse"] + terms.get("vb", 0.0) + terms.get("mae", 0.0)
        if loss_weight is not None:
            terms["loss"] = terms["loss"] * loss_weight
        terms["pred_xstart"] = pred_xstart
        terms["x_t"] = x_t
        return terms

    def training_losses_diffusers(self, model_fn: ModelFn, x_start: torch.Tensor,
                                  timestep: torch.Tensor, noise: Optional[torch.Tensor],
                                  skip_noise: bool = False, return_startx: bool = False):
        """The diffusers-convention entry: `model_fn(x_t, timestep=t)`, the
        math of `training_losses`. With `return_startx` and epsilon
        prediction: (eps, pred_xstart, x_t) from one model call, with t as
        given (a spaced diffusion does not map it there, as in JAX)."""
        t = timestep
        x_t = x_start if skip_noise else self.q_sample(x_start, t, noise)
        wrapped = lambda x, tt: model_fn(x, timestep=tt)
        if return_startx and self.model_mean_type == ModelMeanType.EPSILON:
            output, _ = self._split_output(wrapped(x_t, t), x_t)
            return output, self.predict_xstart_from_eps(x_t, t, output), x_t
        return self.training_losses(wrapped, x_start, t, noise, skip_noise=skip_noise)

    def training_losses_startx(self, model_fn: ModelFn, x_start: torch.Tensor,
                               t: torch.Tensor, noise: torch.Tensor):
        """The LCM entry: (eps, pred_xstart, x_t) from one model call."""
        x_t = self.q_sample(x_start, t, noise)
        output, _ = self._split_output(model_fn(x_t, t), x_t)
        return output, self.predict_xstart_from_eps(x_t, t, output), x_t

    # --------------------------------------------------------------- NLL eval
    def prior_bpd(self, x_start: torch.Tensor) -> torch.Tensor:
        """The bound's prior term KL(q(x_T | x_0) || N(0, I)) in bits/dim, [B]."""
        t = self._loop_t(self.num_timesteps - 1, x_start)
        mean, _, log_variance = self.q_mean_variance(x_start, t)
        zero = torch.zeros((), dtype=mean.dtype, device=mean.device)
        return mean_flat(normal_kl(mean, log_variance, zero, zero)) / math.log(2.0)

    def calc_bpd_loop(self, model_fn: ModelFn, x_start: torch.Tensor, noise_fn: NoiseFn,
                      clip_denoised: bool = True,
                      timestep_map: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The whole variational bound in bits/dim: for t = T-1 .. 0, x_t from
        draw k = T-1-t and the bound's term at t. Returns total_bpd and
        prior_bpd [B], and vb, xstart_mse and mse [B, T] whose column j is
        timestep T-1-j (JAX's order). `timestep_map` maps the loop's t to
        the timestep the model is fed (a spaced chain's `timestep_map`)."""
        T = self.num_timesteps
        cols = {"vb": [], "xstart_mse": [], "mse": []}
        for k in range(T):
            t = self._loop_t(T - 1 - k, x_start)
            t_model = t if timestep_map is None else timestep_map.to(t.device)[t]
            noise = noise_fn(k, x_start.shape).to(x_start.device, x_start.dtype)
            x_t = self.q_sample(x_start, t, noise)
            out = self.vb_terms_bpd(model_fn(x_t, t_model), x_start, x_t, t,
                                    clip_denoised=clip_denoised)
            eps = self.predict_eps_from_xstart(x_t, t, out["pred_xstart"])
            cols["vb"].append(out["output"])
            cols["xstart_mse"].append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            cols["mse"].append(mean_flat((eps - noise) ** 2))
        seq = {k: torch.stack(v, dim=1) for k, v in cols.items()}
        prior = self.prior_bpd(x_start)
        return {"total_bpd": seq["vb"].sum(dim=1) + prior, "prior_bpd": prior, **seq}
