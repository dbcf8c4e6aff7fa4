"""Beta schedules (host float64 numpy) and the diffusion coefficients.

Port of pixart_sigma_tpu/diffusion/schedules.py.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def linear_beta_schedule(num_timesteps: int) -> np.ndarray:
    """Ho et al. linear schedule, rescaled so it is invariant to T."""
    scale = 1000.0 / num_timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, num_timesteps, dtype=np.float64)


def cosine_beta_schedule(num_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """squaredcos_cap_v2: betas from the Nichol-Dhariwal cosine alpha-bar."""

    def alpha_bar(t: float) -> float:
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = np.empty(num_timesteps, dtype=np.float64)
    for i in range(num_timesteps):
        t0 = i / num_timesteps
        t1 = (i + 1) / num_timesteps
        betas[i] = min(1.0 - alpha_bar(t1) / alpha_bar(t0), max_beta)
    return betas


_SCHEDULES = {
    "linear": linear_beta_schedule,
    "squaredcos_cap_v2": cosine_beta_schedule,
}


def named_beta_schedule(name: str, num_timesteps: int) -> np.ndarray:
    """Return the float64 beta array for a named schedule."""
    try:
        return _SCHEDULES[name](num_timesteps)
    except KeyError:
        raise NotImplementedError(f"unknown beta schedule: {name}") from None


@dataclasses.dataclass(frozen=True)
class ScheduleCoefficients:
    """Per-timestep coefficient arrays, derived in float64 from `betas` and
    kept as float32 tensors on the CPU (`extract` moves what it gathers).
    Port of the JAX package's ScheduleCoefficients."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    log_betas: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor

    @classmethod
    def create(cls, betas: np.ndarray) -> "ScheduleCoefficients":
        betas = np.asarray(betas, dtype=np.float64)
        assert betas.ndim == 1 and (0 < betas).all() and (betas <= 1).all()
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        acp_next = np.append(acp[1:], 0.0)
        posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
        # log-variance clipped at t=0 because posterior_variance[0] == 0
        posterior_log_variance_clipped = np.log(
            np.append(posterior_variance[1], posterior_variance[1:]))
        fixed_large_var = np.append(posterior_variance[1], betas[1:])
        f32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))
        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(acp),
            alphas_cumprod_prev=f32(acp_prev),
            alphas_cumprod_next=f32(acp_next),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - acp)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
            log_betas=f32(np.log(betas)),
            fixed_large_variance=f32(fixed_large_var),
            fixed_large_log_variance=f32(np.log(fixed_large_var)),
        )

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """arr [T] gathered at t [B] -> [B, 1, ..., 1] with `ndim` dims, on t's device."""
    out = arr.to(t.device)[t.long()]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))
