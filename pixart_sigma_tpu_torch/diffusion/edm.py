"""EDM (Karras et al. 2022) samplers: Heun with optional churn, and the
generalized ablation sampler.

Port of pixart_sigma_tpu/diffusion/edm.py. `denoise_fn(x, sigma)` returns
the denoised estimate (x0 prediction) at noise level sigma; the sigma grids
and every coefficient are host f64, the updates run on tensors. Step i
takes draw i of `noise_fn` when it adds churn noise.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from pixart_sigma_tpu_torch.diffusion.noise import NoiseFn


def karras_sigmas(num_steps: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
                  rho: float = 7.0) -> np.ndarray:
    """The rho-spaced sigma grid with the terminal 0 appended."""
    idx = np.arange(num_steps, dtype=np.float64)
    t = (sigma_max ** (1 / rho)
         + idx / (num_steps - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return np.append(t, 0.0)


def edm_sampler(denoise_fn: Callable, latents: torch.Tensor, noise_fn: NoiseFn,
                num_steps: int = 18, sigma_min: float = 0.002, sigma_max: float = 80.0,
                rho: float = 7.0, s_churn: float = 0.0, s_min: float = 0.0,
                s_max: float = float("inf"), s_noise: float = 1.0) -> torch.Tensor:
    """Heun (2nd order) EDM sampling from unit-variance latents."""
    t_steps = karras_sigmas(num_steps, sigma_min, sigma_max, rho)
    x = latents.float() * float(t_steps[0])
    for i in range(num_steps):
        t_cur, t_next = float(t_steps[i]), float(t_steps[i + 1])
        gamma = min(s_churn / num_steps, np.sqrt(2.0) - 1.0) if s_min <= t_cur <= s_max else 0.0
        t_hat = t_cur + gamma * t_cur
        if gamma > 0:
            eps = noise_fn(i, x.shape).to(x.device, x.dtype)
            x = x + float(np.sqrt(max(t_hat**2 - t_cur**2, 0.0))) * s_noise * eps
        denoised = denoise_fn(x, t_hat)
        d_cur = (x - denoised) / t_hat
        x_euler = x + (t_next - t_hat) * d_cur
        if i < num_steps - 1:  # Heun correction
            d_prime = (x_euler - denoise_fn(x_euler, t_next)) / t_next
            x = x + (t_next - t_hat) * 0.5 * (d_cur + d_prime)
        else:
            x = x_euler
    return x


def ablation_sampler(denoise_fn: Callable, latents: torch.Tensor, noise_fn: NoiseFn,
                     num_steps: int = 18, sigma_min: Optional[float] = None,
                     sigma_max: Optional[float] = None, rho: float = 7.0,
                     solver: str = "heun", discretization: str = "edm",
                     schedule: str = "linear", scaling: str = "none", epsilon_s: float = 1e-3,
                     c1: float = 0.001, c2: float = 0.008, m_steps: int = 1000,
                     alpha: float = 1.0, s_churn: float = 0.0, s_min: float = 0.0,
                     s_max: float = float("inf"), s_noise: float = 1.0) -> torch.Tensor:
    """The generalized sampler of Karras et al. 2022: euler or heun; vp, ve,
    iddpm or edm discretization; vp, ve or linear schedule; vp or no
    scaling. Schedules are host f64."""
    if solver not in ("euler", "heun") or discretization not in ("vp", "ve", "iddpm", "edm") \
            or schedule not in ("vp", "ve", "linear") or scaling not in ("vp", "none"):
        raise ValueError(f"unknown sampler setting {(solver, discretization, schedule, scaling)}")

    def vp_sigma(beta_d, beta_min):
        return lambda t: np.sqrt(np.exp(0.5 * beta_d * t**2 + beta_min * t) - 1)

    def vp_sigma_deriv(beta_d, beta_min, sig):
        return lambda t: 0.5 * (beta_min + beta_d * t) * (sig(t) + 1 / sig(t))

    def vp_sigma_inv(beta_d, beta_min):
        return lambda s: (np.sqrt(beta_min**2 + 2 * beta_d * np.log(s**2 + 1)) - beta_min) / beta_d

    if sigma_min is None:
        vp_def = vp_sigma(19.1, 0.1)(epsilon_s)
        sigma_min = {"vp": vp_def, "ve": 0.02, "iddpm": 0.002, "edm": 0.002}[discretization]
    if sigma_max is None:
        vp_def = vp_sigma(19.1, 0.1)(1.0)
        sigma_max = {"vp": vp_def, "ve": 100.0, "iddpm": 81.0, "edm": 80.0}[discretization]
    vp_beta_d = 2 * (np.log(sigma_min**2 + 1) / epsilon_s - np.log(sigma_max**2 + 1)) / (
        epsilon_s - 1)
    vp_beta_min = np.log(sigma_max**2 + 1) - 0.5 * vp_beta_d

    idx = np.arange(num_steps, dtype=np.float64)
    if discretization == "vp":
        orig_t = 1 + idx / (num_steps - 1) * (epsilon_s - 1)
        sigma_steps = vp_sigma(vp_beta_d, vp_beta_min)(orig_t)
    elif discretization == "ve":
        orig_t = sigma_max**2 * (sigma_min**2 / sigma_max**2) ** (idx / (num_steps - 1))
        sigma_steps = np.sqrt(orig_t)
    elif discretization == "iddpm":
        u = np.zeros(m_steps + 1, dtype=np.float64)
        alpha_bar = lambda j: np.sin(0.5 * np.pi * j / m_steps / (c2 + 1)) ** 2
        for j in range(m_steps, 0, -1):
            u[j - 1] = np.sqrt((u[j] ** 2 + 1) / max(alpha_bar(j - 1) / alpha_bar(j), c1) - 1)
        u_filtered = u[(u >= sigma_min) & (u <= sigma_max)]
        pick = np.round((len(u_filtered) - 1) / (num_steps - 1) * idx).astype(np.int64)
        sigma_steps = u_filtered[pick]
    else:
        sigma_steps = (sigma_max ** (1 / rho) + idx / (num_steps - 1)
                       * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho

    if schedule == "vp":
        sigma = vp_sigma(vp_beta_d, vp_beta_min)
        sigma_deriv = vp_sigma_deriv(vp_beta_d, vp_beta_min, sigma)
        sigma_inv = vp_sigma_inv(vp_beta_d, vp_beta_min)
    elif schedule == "ve":
        sigma = lambda t: np.sqrt(t)
        sigma_deriv = lambda t: 0.5 / np.sqrt(t)
        sigma_inv = lambda s: s**2
    else:
        sigma = lambda t: t
        sigma_deriv = lambda t: 1.0
        sigma_inv = lambda s: s
    if scaling == "vp":
        s_fn = lambda t: 1 / np.sqrt(1 + sigma(t) ** 2)
        s_deriv = lambda t: -sigma(t) * sigma_deriv(t) * s_fn(t) ** 3
    else:
        s_fn = lambda t: 1.0
        s_deriv = lambda t: 0.0

    def slope(xi, den, t):
        """dx/dt at (xi, t) given the denoised estimate."""
        return (float(sigma_deriv(t) / sigma(t) + s_deriv(t) / s_fn(t)) * xi
                - float(sigma_deriv(t) * s_fn(t) / sigma(t)) * den)

    t_steps = np.append(sigma_inv(sigma_steps), 0.0)
    t_next = t_steps[0]
    x_next = latents.float() * float(sigma(t_next) * s_fn(t_next))
    for i in range(num_steps):
        t_cur, t_next = float(t_steps[i]), float(t_steps[i + 1])
        x_cur = x_next
        gamma = (min(s_churn / num_steps, np.sqrt(2.0) - 1.0)
                 if s_min <= sigma(t_cur) <= s_max else 0.0)
        t_hat = float(sigma_inv(sigma(t_cur) + gamma * sigma(t_cur)))
        noise_scale = float(np.sqrt(max(sigma(t_hat) ** 2 - sigma(t_cur) ** 2, 0.0)) * s_fn(t_hat))
        x_hat = float(s_fn(t_hat) / s_fn(t_cur)) * x_cur
        if noise_scale > 0:
            x_hat = x_hat + noise_scale * s_noise * noise_fn(i, x_cur.shape).to(
                x_cur.device, x_cur.dtype)
        h = t_next - t_hat
        d_cur = slope(x_hat, denoise_fn(x_hat / float(s_fn(t_hat)), float(sigma(t_hat))), t_hat)
        if solver == "euler" or i == num_steps - 1:
            x_next = x_hat + h * d_cur
        else:
            x_prime = x_hat + alpha * h * d_cur
            t_prime = t_hat + alpha * h
            d_prime = slope(x_prime, denoise_fn(x_prime / float(s_fn(t_prime)),
                                                float(sigma(t_prime))), t_prime)
            x_next = x_hat + h * ((1 - 1 / (2 * alpha)) * d_cur + 1 / (2 * alpha) * d_prime)
    return x_next
