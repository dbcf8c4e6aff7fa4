"""DPM-Solver++ (multistep, order <= 2) for few-step sampling.

Port of the production path of pixart_sigma_tpu/diffusion/dpm_solver.py:
the schedule math (time grid, lambda / alpha / sigma, the update
coefficients) is host float64 numpy, the per-step update runs on tensors.
`DPMSolver.sample` is the JAX `sample_scan` recurrence as a Python loop:

    x_i = (sig_i / sig_{i-1}) x - alpha_i expm1(-h_i) (m0 + c1_i (m0 - m1))

with c1 = 0 on the first step and, with `lower_order_final`, on the last.
Other solver types, orders, methods and the SDE variants are not ported
yet and raise (ROADMAP.md, Queue 1: other samplers).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

_NOT_PORTED = "is not ported yet (ROADMAP.md, Queue 1: other samplers)"


class NoiseScheduleVP:
    """Discrete VP noise schedule (host float64 numpy).

    A length-N beta array becomes a piecewise-linear
    log-alpha(t) on t_i = (i + 1) / N, with the log-SNR clip at -5.1.
    """

    def __init__(self, schedule: str, betas: np.ndarray):
        if schedule != "discrete":
            raise NotImplementedError(f"NoiseScheduleVP({schedule!r}) {_NOT_PORTED}")
        log_alphas = 0.5 * np.cumsum(np.log(1.0 - np.asarray(betas, dtype=np.float64)))
        self.T = 1.0
        self.log_alpha_array = self._clip_log_alphas(log_alphas)
        self.total_N = len(self.log_alpha_array)
        self.t_array = np.linspace(0.0, 1.0, self.total_N + 1)[1:]

    @staticmethod
    def _clip_log_alphas(log_alphas: np.ndarray, clipped_lambda: float = -5.1) -> np.ndarray:
        """Drop the tail where log-SNR < -5.1."""
        log_sigmas = 0.5 * np.log(1.0 - np.exp(2.0 * log_alphas))
        lambs = log_alphas - log_sigmas
        idx = int(np.searchsorted(lambs[::-1], clipped_lambda))
        return log_alphas[: len(log_alphas) - idx] if idx > 0 else log_alphas

    def marginal_log_mean_coeff(self, t):
        return np.interp(t, self.t_array, self.log_alpha_array)

    def marginal_alpha(self, t):
        return np.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_mean = self.marginal_log_mean_coeff(t)
        return log_mean - 0.5 * np.log(1.0 - np.exp(2.0 * log_mean))

    def inverse_lambda(self, lamb):
        log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * lamb)
        return np.interp(log_alpha, self.log_alpha_array[::-1], self.t_array[::-1])


def get_time_steps(ns: NoiseScheduleVP, skip_type: str, t_T: float, t_0: float,
                   N: int) -> np.ndarray:
    """The N + 1 boundary times for N solver steps (host float64)."""
    if skip_type == "logSNR":
        lam_T = ns.marginal_lambda(t_T)
        lam_0 = ns.marginal_lambda(t_0)
        return ns.inverse_lambda(np.linspace(lam_T, lam_0, N + 1))
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, N + 1)
    if skip_type == "time_quadratic":
        return np.linspace(math.sqrt(t_T), math.sqrt(t_0), N + 1) ** 2
    if skip_type == "karras":
        rho = 7.0
        lam_T, lam_0 = ns.marginal_lambda(t_T), ns.marginal_lambda(t_0)
        s_max, s_min = math.exp(-lam_T), math.exp(-lam_0)
        ramp = np.linspace(0.0, 1.0, N + 1)
        sigmas = (s_max ** (1 / rho) + ramp * (s_min ** (1 / rho) - s_max ** (1 / rho))) ** rho
        return ns.inverse_lambda(-np.log(sigmas))
    raise ValueError(f"unsupported skip_type {skip_type}")


class DPMSolver:
    """DPM-Solver++ sampler; `model_fn(x, t_continuous)` returns the noise
    prediction (wrap guidance with `make_cfg_model_fn`)."""

    def __init__(self, model_fn: Callable, noise_schedule: NoiseScheduleVP,
                 algorithm_type: str = "dpmsolver++", correcting_x0_fn=None):
        if algorithm_type != "dpmsolver++" or correcting_x0_fn is not None:
            raise NotImplementedError(
                f"DPMSolver(algorithm_type={algorithm_type!r}, correcting_x0_fn) {_NOT_PORTED}")
        self.noise_fn = model_fn
        self.ns = noise_schedule
        self.algorithm_type = algorithm_type

    def sample(
        self,
        x: torch.Tensor,
        steps: int = 20,
        t_start: Optional[float] = None,
        t_end: Optional[float] = None,
        order: int = 2,
        skip_type: str = "time_uniform",
        method: str = "multistep",
        lower_order_final: bool = True,
        denoise_to_zero: bool = False,
        solver_type: str = "dpmsolver",
    ) -> torch.Tensor:
        """Sample from t_start to t_end in `steps` model evaluations."""
        if method != "multistep" or order > 2 or solver_type != "dpmsolver" or denoise_to_zero:
            raise NotImplementedError(
                f"DPMSolver.sample(method={method!r}, order={order}, "
                f"solver_type={solver_type!r}, denoise_to_zero={denoise_to_zero}) {_NOT_PORTED}")
        if steps < order:
            raise ValueError(f"steps ({steps}) < order ({order})")
        ns = self.ns
        t_0 = (1.0 / ns.total_N) if t_end is None else t_end
        t_T = ns.T if t_start is None else t_start
        ts = get_time_steps(ns, skip_type, t_T, t_0, steps)  # [S + 1] f64
        lam = ns.marginal_lambda(ts)
        sig = ns.marginal_std(ts)
        alpha = ns.marginal_alpha(ts)
        h = lam[1:] - lam[:-1]
        sr = sig[1:] / sig[:-1]
        aphi = alpha[1:] * np.expm1(-h)
        c1 = np.zeros(steps)
        if order >= 2:
            c1[1:] = 0.5 * (h[1:] / h[:-1])
            if lower_order_final:
                c1[-1] = 0.0
        f32 = lambda a: float(np.float32(a))

        def x0_pred(xi, i):
            eps = self.noise_fn(xi, float(ts[i]))
            return (xi - f32(sig[i]) * eps) / f32(alpha[i])

        m0 = x0_pred(x, 0)
        m1 = m0  # its coefficient is zero on the first step
        for i in range(steps):
            x = f32(sr[i]) * x - f32(aphi[i]) * (m0 + f32(c1[i]) * (m0 - m1))
            if i + 1 < steps:
                m0, m1 = x0_pred(x, i + 1), m0
        return x


def make_cfg_model_fn(
    apply_fn: Callable,
    ns: NoiseScheduleVP,
    condition,
    uncondition,
    cfg_scale: float,
    model_type: str = "noise",
    guidance_type: str = "classifier-free",
) -> Callable:
    """Classifier-free-guided continuous-time noise predictor.

    `apply_fn(x, t_model, cond)` is the network; cond and uncond
    run as one 2B batch with the unconditional half first.
    """
    if model_type != "noise" or guidance_type != "classifier-free":
        raise NotImplementedError(
            f"make_cfg_model_fn(model_type={model_type!r}, "
            f"guidance_type={guidance_type!r}) {_NOT_PORTED}")

    def model_fn(x, t_cont: float):
        t_model = (torch.tensor(t_cont, dtype=torch.float32) - 1.0 / ns.total_N) * 1000.0
        if cfg_scale == 1.0 or uncondition is None:
            t_vec = t_model.to(x.device).expand(x.shape[0])
            return apply_fn(x, t_vec, condition)
        x_in = torch.cat([x, x], dim=0)
        t_vec = t_model.to(x.device).expand(x_in.shape[0])
        c_in = torch.cat([uncondition, condition], dim=0)
        noise_uncond, noise_cond = apply_fn(x_in, t_vec, c_in).chunk(2, dim=0)
        return noise_uncond + cfg_scale * (noise_cond - noise_uncond)

    return model_fn
