"""LCM (latent consistency model) scheduler and the training-side DDIM solver.

Port of pixart_sigma_tpu/diffusion/lcm.py: the per-step alphas and the
boundary scalings c_skip / c_out are host f64, the few-step trajectory is a
Python loop over device tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from pixart_sigma_tpu_torch.diffusion.noise import NoiseFn
from pixart_sigma_tpu_torch.diffusion.schedules import named_beta_schedule


def scalings_for_boundary_conditions(t, sigma_data: float = 0.5,
                                     timestep_scaling: float = 10.0):
    """c_skip, c_out of the consistency boundary condition."""
    ts = t * timestep_scaling
    c_skip = sigma_data**2 / (ts**2 + sigma_data**2)
    c_out = ts / (ts**2 + sigma_data**2) ** 0.5
    return c_skip, c_out


def lcm_inference_timesteps(num_inference_steps: int, lcm_origin_steps: int = 50,
                            num_train_timesteps: int = 1000) -> np.ndarray:
    """The timesteps LCMScheduler.set_timesteps picks on the origin grid."""
    c = num_train_timesteps // lcm_origin_steps
    origin = np.arange(1, lcm_origin_steps + 1) * c - 1
    skip = len(origin) // num_inference_steps
    return origin[::-skip][:num_inference_steps].copy()


class LCMScheduler:
    """Few-step LCM sampling over a consistency-distilled PixArt;
    `model_fn(x, t_vec)` returns the eps prediction, t_vec float32 [B]."""

    def __init__(self, num_train_timesteps: int = 1000, beta_schedule: str = "linear",
                 prediction_type: str = "epsilon", betas: Optional[np.ndarray] = None,
                 set_alpha_to_one: bool = True):
        if betas is None:
            betas = named_beta_schedule(
                "linear" if beta_schedule in ("linear", "scaled_linear") else beta_schedule,
                num_train_timesteps)
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        self.final_alpha_cumprod = 1.0 if set_alpha_to_one else self.alphas_cumprod[0]
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type

    def _pred_x0(self, sample, model_output, alpha_prod_t):
        beta_prod_t = 1.0 - alpha_prod_t
        if self.prediction_type == "epsilon":
            return (sample - beta_prod_t**0.5 * model_output) / alpha_prod_t**0.5
        if self.prediction_type == "sample":
            return model_output
        if self.prediction_type == "v_prediction":
            return alpha_prod_t**0.5 * sample - beta_prod_t**0.5 * model_output
        raise ValueError(self.prediction_type)

    def sample(self, model_fn: Callable, noise: torch.Tensor, noise_fn: NoiseFn,
               num_inference_steps: int = 4, lcm_origin_steps: int = 50) -> torch.Tensor:
        """The LCM trajectory from `noise`, which enters unscaled (the LCM
        quirk); each step but the last re-noises the denoised estimate to
        the next timestep with draw i. Returns the last denoised estimate."""
        timesteps = lcm_inference_timesteps(num_inference_steps, lcm_origin_steps,
                                            self.num_train_timesteps)
        x = noise
        denoised = x
        for i, t in enumerate(timesteps):
            alpha_prod_t = float(self.alphas_cumprod[t])
            c_skip, c_out = scalings_for_boundary_conditions(np.float64(t))
            t_vec = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
            pred_x0 = self._pred_x0(x, model_fn(x, t_vec), alpha_prod_t)
            denoised = float(c_out) * pred_x0 + float(c_skip) * x
            if i < len(timesteps) - 1:
                alpha_prev = float(self.alphas_cumprod[int(timesteps[i + 1])])
                z = noise_fn(i, x.shape).to(x.device, x.dtype)
                x = alpha_prev**0.5 * denoised + (1 - alpha_prev) ** 0.5 * z
        return denoised


class DDIMSolver:
    """The teacher-side deterministic DDIM stepper of LCM distillation:
    DDIM timesteps on the origin grid, a step from t to its predecessor from
    the predicted x0 and eps."""

    def __init__(self, alpha_cumprods: np.ndarray, timesteps: int = 1000,
                 ddim_timesteps: int = 50):
        step_ratio = timesteps // ddim_timesteps
        self.ddim_timesteps = ((np.arange(1, ddim_timesteps + 1) * step_ratio) - 1).astype(
            np.int64)
        self.ddim_alpha_cumprods = alpha_cumprods[self.ddim_timesteps]
        self.ddim_alpha_cumprods_prev = np.concatenate(
            [alpha_cumprods[:1], alpha_cumprods[self.ddim_timesteps[:-1]]])
        self._acp_prev = torch.from_numpy(self.ddim_alpha_cumprods_prev.astype(np.float32))

    def ddim_step(self, pred_x0: torch.Tensor, pred_noise: torch.Tensor,
                  timestep_index: torch.Tensor) -> torch.Tensor:
        acp_prev = self._acp_prev.to(pred_x0.device)[timestep_index.long()]
        acp_prev = acp_prev.reshape(-1, *((1,) * (pred_x0.ndim - 1)))
        return acp_prev**0.5 * pred_x0 + (1 - acp_prev) ** 0.5 * pred_noise
