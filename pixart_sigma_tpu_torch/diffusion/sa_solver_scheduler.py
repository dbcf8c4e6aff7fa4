"""SA-Solver with the diffusers scheduler calling convention.

Port of pixart_sigma_tpu/diffusion/sa_solver_scheduler.py: the stateful
`set_timesteps()` / `step()` API (Karras sigmas, dynamic thresholding,
`add_noise`) beside the whole-trajectory `sa_solver.SASolver.sample`. Both
take the host f64 exponential-integral x Lagrange coefficients from
`sa_solver._gradient_coefficients`. Samples and model outputs may be numpy
arrays or tensors; the updates run on tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from pixart_sigma_tpu_torch.diffusion.sa_solver import _gradient_coefficients


@dataclass
class SchedulerOutput:
    prev_sample: torch.Tensor


def betas_for_alpha_bar(num_diffusion_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """squaredcos_cap_v2 betas from the cosine alpha-bar."""

    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.asarray(betas, np.float64)


def _default_tau(t) -> float:
    # stochasticity on timesteps [200, 800]
    return 1.0 if 200 <= t <= 800 else 0.0


class SASolverScheduler:
    """Stateful step-wise SA-Solver (PEC)."""

    order = 1  # pipeline-facing attribute of diffusers schedulers

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
        beta_schedule: str = "linear",
        trained_betas: Optional[np.ndarray] = None,
        predictor_order: int = 2,
        corrector_order: int = 2,
        predictor_corrector_mode: str = "PEC",
        prediction_type: str = "epsilon",
        tau_func: Optional[Callable[[float], float]] = None,
        thresholding: bool = False,
        dynamic_thresholding_ratio: float = 0.995,
        sample_max_value: float = 1.0,
        algorithm_type: str = "data_prediction",
        lower_order_final: bool = True,
        use_karras_sigmas: bool = False,
        lambda_min_clipped: float = -float("inf"),
        timestep_spacing: str = "linspace",
        steps_offset: int = 0,
    ):
        if trained_betas is not None:
            betas = np.asarray(trained_betas, np.float64)
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
        elif beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                                dtype=np.float64) ** 2
        elif beta_schedule == "squaredcos_cap_v2":
            betas = betas_for_alpha_bar(num_train_timesteps)
        else:
            raise NotImplementedError(f"{beta_schedule} is not implemented for {type(self)}")
        if algorithm_type not in ("data_prediction", "noise_prediction"):
            raise NotImplementedError(f"{algorithm_type} is not implemented for {type(self)}")
        if predictor_corrector_mode != "PEC":
            raise NotImplementedError(
                "only PEC is supported (one corrector evaluation per step, as upstream)")
        self.config = SimpleNamespace(
            num_train_timesteps=num_train_timesteps, beta_start=beta_start, beta_end=beta_end,
            beta_schedule=beta_schedule, predictor_order=predictor_order,
            corrector_order=corrector_order, predictor_corrector_mode=predictor_corrector_mode,
            prediction_type=prediction_type, thresholding=thresholding,
            dynamic_thresholding_ratio=dynamic_thresholding_ratio,
            sample_max_value=sample_max_value, algorithm_type=algorithm_type,
            lower_order_final=lower_order_final, use_karras_sigmas=use_karras_sigmas,
            lambda_min_clipped=lambda_min_clipped, timestep_spacing=timestep_spacing,
            steps_offset=steps_offset,
        )
        self.betas = betas
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        self.alpha_t = np.sqrt(self.alphas_cumprod)
        self.sigma_t = np.sqrt(1.0 - self.alphas_cumprod)
        self.lambda_t = np.log(self.alpha_t) - np.log(self.sigma_t)
        self.init_noise_sigma = 1.0
        self.tau_func = tau_func or _default_tau
        self.predict_x0 = algorithm_type == "data_prediction"
        self.num_inference_steps: Optional[int] = None
        self.timesteps = np.arange(num_train_timesteps - 1, -1, -1)
        self._reset_state()

    def _reset_state(self) -> None:
        k = max(self.config.predictor_order, self.config.corrector_order - 1)
        self.timestep_list: List = [None] * k
        self.model_outputs: List = [None] * k
        self.lower_order_nums = 0
        self.last_sample = None
        self.last_noise = None
        self.this_predictor_order = self.config.predictor_order
        self.this_corrector_order = self.config.corrector_order

    def __len__(self) -> int:
        return self.config.num_train_timesteps

    # ------------------------------------------------------------ timesteps
    def set_timesteps(self, num_inference_steps: int) -> None:
        """The inference timesteps (linspace, leading or trailing; Karras)."""
        cfg = self.config
        clipped_idx = int(np.searchsorted(self.lambda_t[::-1], cfg.lambda_min_clipped))
        last_timestep = cfg.num_train_timesteps - clipped_idx
        if cfg.timestep_spacing == "linspace":
            timesteps = (np.linspace(0, last_timestep - 1, num_inference_steps + 1)
                         .round()[::-1][:-1].astype(np.int64))
        elif cfg.timestep_spacing == "leading":
            step_ratio = last_timestep // (num_inference_steps + 1)
            timesteps = ((np.arange(0, num_inference_steps + 1) * step_ratio)
                         .round()[::-1][:-1].astype(np.int64))
            timesteps += cfg.steps_offset
        elif cfg.timestep_spacing == "trailing":
            step_ratio = cfg.num_train_timesteps / num_inference_steps
            timesteps = np.arange(last_timestep, 0, -step_ratio).round().astype(np.int64)
            timesteps -= 1
        else:
            raise ValueError(f"{cfg.timestep_spacing} is not supported; choose one of "
                             "'linspace', 'leading' or 'trailing'.")
        sigmas = ((1 - self.alphas_cumprod) / self.alphas_cumprod) ** 0.5
        if cfg.use_karras_sigmas:
            log_sigmas = np.log(sigmas)
            sigmas = self._convert_to_karras(sigmas, num_inference_steps)
            timesteps = np.asarray([self._sigma_to_t(s, log_sigmas) for s in sigmas]).round()
            timesteps = np.flip(timesteps).astype(np.int64)
        self.sigmas = sigmas
        _, unique_indices = np.unique(timesteps, return_index=True)
        self.timesteps = timesteps[np.sort(unique_indices)]
        self.num_inference_steps = len(self.timesteps)
        self._reset_state()

    def _sigma_to_t(self, sigma: float, log_sigmas: np.ndarray) -> float:
        """The interpolated inverse of the sigma table."""
        log_sigma = np.log(max(sigma, 1e-10))
        dists = log_sigma - log_sigmas[:, None]
        low_idx = np.cumsum(dists >= 0, axis=0).argmax(axis=0).clip(max=log_sigmas.shape[0] - 2)
        high_idx = low_idx + 1
        low, high = log_sigmas[low_idx], log_sigmas[high_idx]
        w = np.clip((low - log_sigma) / (low - high), 0, 1)
        return float(((1 - w) * low_idx + w * high_idx).reshape(()))

    def _convert_to_karras(self, in_sigmas: np.ndarray, num_inference_steps: int) -> np.ndarray:
        """rho-7 Karras spacing between the table's extremes."""
        sigma_min, sigma_max = float(in_sigmas[-1]), float(in_sigmas[0])
        rho = 7.0
        ramp = np.linspace(0, 1, num_inference_steps)
        min_inv_rho = sigma_min ** (1 / rho)
        max_inv_rho = sigma_max ** (1 / rho)
        return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho

    # --------------------------------------------------------- conversions
    def _threshold_sample(self, sample: torch.Tensor) -> torch.Tensor:
        """Dynamic thresholding (Imagen §3.1.2)."""
        cfg = self.config
        B = sample.shape[0]
        flat = sample.float().reshape(B, -1).abs()
        s = torch.quantile(flat, cfg.dynamic_thresholding_ratio, dim=1)
        s = s.clamp(1.0, cfg.sample_max_value).reshape((B,) + (1,) * (sample.ndim - 1))
        return (torch.maximum(torch.minimum(sample, s), -s) / s).to(sample.dtype)

    def convert_model_output(self, model_output, timestep: int, sample):
        """eps / x0 / v prediction -> the solver's working prediction."""
        cfg = self.config
        model_output, sample = torch.as_tensor(model_output), torch.as_tensor(sample)
        if cfg.prediction_type not in ("epsilon", "sample", "v_prediction"):
            raise ValueError(f"prediction_type {cfg.prediction_type!r} must be one of "
                             "epsilon/sample/v_prediction")
        alpha_t, sigma_t = float(self.alpha_t[timestep]), float(self.sigma_t[timestep])
        if cfg.prediction_type == "epsilon" and model_output.shape[-1] == 2 * sample.shape[-1]:
            # variance-learning models append sigma channels: drop them
            model_output = model_output[..., : sample.shape[-1]]
        if self.predict_x0:
            if cfg.prediction_type == "epsilon":
                x0 = (sample - sigma_t * model_output) / alpha_t
            elif cfg.prediction_type == "sample":
                x0 = model_output
            else:
                x0 = alpha_t * sample - sigma_t * model_output
            return self._threshold_sample(x0) if cfg.thresholding else x0
        if cfg.prediction_type == "epsilon":
            return model_output
        if cfg.prediction_type == "sample":
            return (sample - alpha_t * model_output) / sigma_t
        return alpha_t * model_output + sigma_t * sample

    # -------------------------------------------------------------- updates
    def _lam(self, timestep: int) -> float:
        return float(self.lambda_t[timestep])

    def _adams(self, x, models, t_list, order, lam_s0, t, s0, tau, noise, corrector):
        """The shared update of predictor and corrector (host f64 coefficients)."""
        lam_t = self._lam(t)
        alpha_t, alpha_s0 = float(self.alpha_t[t]), float(self.alpha_t[s0])
        sigma_t, sigma_s0 = float(self.sigma_t[t]), float(self.sigma_t[s0])
        h = lam_t - lam_s0
        lams = [self._lam(t_list[-(i + 1)]) for i in range(order)]
        gc = _gradient_coefficients(order, lam_s0, lam_t, lams, tau, self.predict_x0)
        if self.predict_x0 and order == 2:
            # the UniPC-style O(h^3) term
            s = 1 + tau**2
            if corrector:
                delta = math.exp(s * lam_t) * (h / 2 - (h * s - 1 + math.exp(-s * h)) / (s**2 * h))
            else:
                delta = math.exp(s * lam_t) * (
                    h**2 / 2 - (h * s - 1 + math.exp(-s * h)) / s**2) / (
                    self._lam(self.timestep_list[-1]) - self._lam(self.timestep_list[-2]))
            gc = [gc[0] + delta, gc[1] - delta]
        grad = torch.zeros_like(x)
        for i in range(order):
            m = torch.as_tensor(models[-(i + 1)])
            if self.predict_x0:
                grad = grad + (1 + tau**2) * sigma_t * math.exp(-(tau**2) * lam_t) * gc[i] * m
            else:
                grad = grad + -(1 + tau**2) * alpha_t * gc[i] * m
        if self.predict_x0:
            noise_part = sigma_t * math.sqrt(max(0.0, 1 - math.exp(-2 * tau**2 * h))) * noise
            out = math.exp(-(tau**2) * h) * (sigma_t / sigma_s0) * x + grad + noise_part
        else:
            noise_part = tau * sigma_t * math.sqrt(max(0.0, math.exp(2 * h) - 1)) * noise
            out = (alpha_t / alpha_s0) * x + grad + noise_part
        return out.to(x.dtype)

    def stochastic_adams_bashforth_update(self, model_output, prev_timestep: int, sample,
                                          noise, order: int, tau: float):
        """The SA predictor."""
        s0 = self.timestep_list[-1]
        return self._adams(torch.as_tensor(sample), self.model_outputs, self.timestep_list,
                           order, self._lam(s0), prev_timestep, s0, tau, noise, False)

    def stochastic_adams_moulton_update(self, this_model_output, this_timestep: int,
                                        last_sample, last_noise, this_sample, order: int,
                                        tau: float):
        """The SA corrector."""
        s0 = self.timestep_list[-1]
        return self._adams(torch.as_tensor(last_sample),
                           list(self.model_outputs) + [this_model_output],
                           list(self.timestep_list) + [this_timestep], order, self._lam(s0),
                           this_timestep, s0, tau, last_noise, True)

    # ----------------------------------------------------------------- step
    def step(self, model_output, timestep: int, sample,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             return_dict: bool = True) -> Union[SchedulerOutput, tuple]:
        """One scheduler step. `noise` overrides the draw from `generator`."""
        if self.num_inference_steps is None:
            raise ValueError("run set_timesteps() before step(): num_inference_steps is None")
        timestep = int(timestep)
        idx = np.nonzero(self.timesteps == timestep)[0]
        step_index = int(idx[0]) if len(idx) else len(self.timesteps) - 1
        use_corrector = step_index > 0 and self.last_sample is not None
        cfg = self.config
        sample = torch.as_tensor(sample)
        converted = self.convert_model_output(model_output, timestep, sample)
        if use_corrector:
            sample = self.stochastic_adams_moulton_update(
                this_model_output=converted, this_timestep=timestep,
                last_sample=self.last_sample, last_noise=self.last_noise, this_sample=sample,
                order=self.this_corrector_order, tau=float(self.tau_func(self.timestep_list[-1])))
        prev_timestep = (0 if step_index == len(self.timesteps) - 1
                         else int(self.timesteps[step_index + 1]))
        self.model_outputs = self.model_outputs[1:] + [converted]
        self.timestep_list = self.timestep_list[1:] + [timestep]
        if noise is None:
            noise = torch.randn(tuple(torch.as_tensor(model_output).shape), generator=generator,
                                device=sample.device, dtype=torch.float32)
        noise = torch.as_tensor(noise)
        if cfg.lower_order_final:
            this_p = min(cfg.predictor_order, len(self.timesteps) - step_index)
            this_c = min(cfg.corrector_order, len(self.timesteps) - step_index + 1)
        else:
            this_p, this_c = cfg.predictor_order, cfg.corrector_order
        self.this_predictor_order = min(this_p, self.lower_order_nums + 1)
        self.this_corrector_order = min(this_c, self.lower_order_nums + 2)
        self.last_sample = sample
        self.last_noise = noise
        prev_sample = self.stochastic_adams_bashforth_update(
            model_output=converted, prev_timestep=prev_timestep, sample=sample, noise=noise,
            order=self.this_predictor_order, tau=float(self.tau_func(self.timestep_list[-1])))
        if self.lower_order_nums < max(cfg.predictor_order, cfg.corrector_order - 1):
            self.lower_order_nums += 1
        if not return_dict:
            return (prev_sample,)
        return SchedulerOutput(prev_sample=prev_sample)

    # ------------------------------------------------------------ utilities
    def scale_model_input(self, sample, *args, **kwargs):
        return sample

    def add_noise(self, original_samples, noise, timesteps):
        ts = np.asarray(timesteps).reshape(-1)
        x = torch.as_tensor(original_samples)
        shape = (-1,) + (1,) * (x.ndim - 1)
        alpha = torch.from_numpy(self.alpha_t[ts].astype(np.float32)).to(x.device).reshape(shape)
        sigma = torch.from_numpy(self.sigma_t[ts].astype(np.float32)).to(x.device).reshape(shape)
        return alpha * x + sigma * torch.as_tensor(noise)
