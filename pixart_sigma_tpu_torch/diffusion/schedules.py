"""Beta schedules (host float64 numpy).

Port of the numpy half of pixart_sigma_tpu/diffusion/schedules.py.
"""

from __future__ import annotations

import math

import numpy as np


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
