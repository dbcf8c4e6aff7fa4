"""DPM-Solver / DPM-Solver++ (ODE and SDE) for few-step sampling.

Port of pixart_sigma_tpu/diffusion/dpm_solver.py: the schedule math (time
grid, lambda / alpha / sigma, the update coefficients) is host float64
numpy, the per-step updates run on tensors. Multistep orders 1-3,
singlestep (DPM-Solver-fast), adaptive step size, the SDE variants and the
final denoising step, with noise, data, v or score models and
classifier-free, classifier or no guidance (`make_cfg_model_fn`).

The pipeline's path, multistep dpmsolver++ of order <= 2, is `sample_scan`,
the JAX `sample_scan` recurrence as a Python loop:

    x_i = (sig_i / sig_{i-1}) x - alpha_i expm1(-h_i) (m0 + c1_i (m0 - m1))

with c1 = 0 on the first step and, with `lower_order_final`, on the last.
Its block-cache variant takes a `state_model_fn(x, t, state, use_cache)` that
carries a model state (the cached residual) through the loop and a
`refresh_mask` of the steps that must recompute it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from pixart_sigma_tpu_torch.diffusion.noise import NoiseFn

# model_fn(x, t_continuous: float) -> noise prediction, same shape as x
ContinuousModelFn = Callable[[torch.Tensor, float], torch.Tensor]


class NoiseScheduleVP:
    """VP noise schedule (host float64 numpy).

    Discrete: a length-N beta (or alpha_cumprod) array becomes a
    piecewise-linear log-alpha(t) on t_i = (i + 1) / N, with the log-SNR
    clip at -5.1. Linear: the continuous linear VPSDE.
    """

    def __init__(self, schedule: str = "discrete", betas: Optional[np.ndarray] = None,
                 alphas_cumprod: Optional[np.ndarray] = None,
                 continuous_beta_0: float = 0.1, continuous_beta_1: float = 20.0):
        if schedule not in ("discrete", "linear"):
            raise ValueError(f"unsupported schedule {schedule}")
        self.schedule = schedule
        self.T = 1.0
        if schedule == "discrete":
            if betas is not None:
                log_alphas = 0.5 * np.cumsum(np.log(1.0 - np.asarray(betas, dtype=np.float64)))
            else:
                log_alphas = 0.5 * np.log(np.asarray(alphas_cumprod, dtype=np.float64))
            self.log_alpha_array = self._clip_log_alphas(log_alphas)
            self.total_N = len(self.log_alpha_array)
            self.t_array = np.linspace(0.0, 1.0, self.total_N + 1)[1:]
        else:
            self.total_N = 1000
            self.beta_0 = continuous_beta_0
            self.beta_1 = continuous_beta_1

    @staticmethod
    def _clip_log_alphas(log_alphas: np.ndarray, clipped_lambda: float = -5.1) -> np.ndarray:
        """Drop the tail where log-SNR < -5.1."""
        log_sigmas = 0.5 * np.log(1.0 - np.exp(2.0 * log_alphas))
        lambs = log_alphas - log_sigmas
        idx = int(np.searchsorted(lambs[::-1], clipped_lambda))
        return log_alphas[: len(log_alphas) - idx] if idx > 0 else log_alphas

    def marginal_log_mean_coeff(self, t):
        if self.schedule == "discrete":
            return np.interp(t, self.t_array, self.log_alpha_array)
        return -0.25 * t**2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0

    def marginal_alpha(self, t):
        return np.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_mean = self.marginal_log_mean_coeff(t)
        return log_mean - 0.5 * np.log(1.0 - np.exp(2.0 * log_mean))

    def inverse_lambda(self, lamb):
        if self.schedule == "linear":
            tmp = 2.0 * (self.beta_1 - self.beta_0) * np.logaddexp(-2.0 * lamb, 0.0)
            delta = self.beta_0**2 + tmp
            return tmp / (np.sqrt(delta) + self.beta_0) / (self.beta_1 - self.beta_0)
        log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * lamb)
        return np.interp(log_alpha, self.log_alpha_array[::-1], self.t_array[::-1])

    def model_input_time(self, t_continuous):
        """Continuous t in [1/N, 1] -> the discrete model input in [0, 1000(N-1)/N]."""
        if self.schedule == "discrete":
            return (t_continuous - 1.0 / self.total_N) * 1000.0
        return t_continuous


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


def multistep_loop(x: torch.Tensor, ts: Sequence[float], order: int, lower_order_final: bool,
                   model: Callable, update: Callable) -> torch.Tensor:
    """The multistep loop shared by DPM-Solver (ODE and SDE) and DEIS.

    One model call per step: steps 1 .. order-1 warm up at their own order,
    later steps take `order`, lowered on the tail with `lower_order_final`.
    `update(x, model_prev, t_prev, t, step_order, step)` returns the next x
    from the last outputs and their times (oldest first)."""
    steps = len(ts) - 1
    t_prev, model_prev = [ts[0]], [model(x, ts[0])]
    for step in range(1, steps + 1):
        t = ts[step]
        if step < order:
            step_order = step
        else:
            step_order = min(order, steps + 1 - step) if lower_order_final else order
        x = update(x, model_prev, t_prev, t, step_order, step)
        t_prev = (t_prev + [t])[-order:]
        if step < steps:
            model_prev = (model_prev + [model(x, t)])[-order:]
    return x


class DPMSolver:
    """DPM-Solver(++), ODE or SDE; `model_fn(x, t_continuous)` returns the
    noise prediction (wrap other model types and guidance with
    `make_cfg_model_fn`)."""

    def __init__(self, model_fn: ContinuousModelFn, noise_schedule: NoiseScheduleVP,
                 algorithm_type: str = "dpmsolver++", correcting_x0_fn=None):
        if algorithm_type not in ("dpmsolver", "dpmsolver++", "sde-dpmsolver",
                                  "sde-dpmsolver++"):
            raise ValueError(f"unknown algorithm_type {algorithm_type!r}")
        self.noise_fn = model_fn
        self.ns = noise_schedule
        # the SDE variants share the ODE variants' predictions; only the
        # multistep update differs
        self.sde = algorithm_type.startswith("sde-")
        self.algorithm_type = algorithm_type.removeprefix("sde-")
        self.correcting_x0_fn = correcting_x0_fn

    # -------------------------------------------------------------- models
    def model(self, x, t: float):
        """Data prediction (dpmsolver++) or noise prediction (dpmsolver)."""
        if self.algorithm_type == "dpmsolver++":
            eps = self.noise_fn(x, t)
            alpha_t = float(self.ns.marginal_alpha(t))
            sigma_t = float(self.ns.marginal_std(t))
            x0 = (x - sigma_t * eps) / alpha_t
            if self.correcting_x0_fn is not None:
                x0 = self.correcting_x0_fn(x0, t)
            return x0
        return self.noise_fn(x, t)

    # ------------------------------------------------------------- updates
    def _coeffs(self, t: float):
        ns = self.ns
        return (float(ns.marginal_lambda(t)), float(ns.marginal_log_mean_coeff(t)),
                float(ns.marginal_std(t)))

    def first_update(self, x, s: float, t: float, model_s=None):
        """Order-1 step (DDIM for dpmsolver++)."""
        lam_s, log_a_s, sig_s = self._coeffs(s)
        lam_t, log_a_t, sig_t = self._coeffs(t)
        h = lam_t - lam_s
        if model_s is None:
            model_s = self.model(x, s)
        if self.algorithm_type == "dpmsolver++":
            phi_1 = math.expm1(-h)
            return (sig_t / sig_s) * x - (math.exp(log_a_t) * phi_1) * model_s
        phi_1 = math.expm1(h)
        return math.exp(log_a_t - log_a_s) * x - (sig_t * phi_1) * model_s

    def multistep_second_update(self, x, model_prev: Sequence, t_prev: Sequence[float],
                                t: float, solver_type: str = "dpmsolver"):
        """Order-2 multistep (Adams-Bashforth-like)."""
        m1, m0 = model_prev[-2], model_prev[-1]
        t1, t0 = t_prev[-2], t_prev[-1]
        lam1, _, _ = self._coeffs(t1)
        lam0, log_a0, sig0 = self._coeffs(t0)
        lam_t, log_a_t, sig_t = self._coeffs(t)
        h0 = lam0 - lam1
        h = lam_t - lam0
        r0 = h0 / h
        d1_0 = (1.0 / r0) * (m0 - m1)
        alpha_t = math.exp(log_a_t)
        if self.algorithm_type == "dpmsolver++":
            phi_1 = math.expm1(-h)
            if solver_type == "dpmsolver":
                return ((sig_t / sig0) * x - (alpha_t * phi_1) * m0
                        - 0.5 * (alpha_t * phi_1) * d1_0)
            return ((sig_t / sig0) * x - (alpha_t * phi_1) * m0
                    + (alpha_t * (phi_1 / h + 1.0)) * d1_0)
        phi_1 = math.expm1(h)
        if solver_type == "dpmsolver":
            return (math.exp(log_a_t - log_a0) * x - (sig_t * phi_1) * m0
                    - 0.5 * (sig_t * phi_1) * d1_0)
        return (math.exp(log_a_t - log_a0) * x - (sig_t * phi_1) * m0
                - (sig_t * (phi_1 / h - 1.0)) * d1_0)

    def multistep_third_update(self, x, model_prev: Sequence, t_prev: Sequence[float],
                               t: float, solver_type: str = "dpmsolver"):
        """Order-3 multistep."""
        m2, m1, m0 = model_prev[-3], model_prev[-2], model_prev[-1]
        t2, t1, t0 = t_prev[-3], t_prev[-2], t_prev[-1]
        lam2, _, _ = self._coeffs(t2)
        lam1, _, _ = self._coeffs(t1)
        lam0, log_a0, sig0 = self._coeffs(t0)
        lam_t, log_a_t, sig_t = self._coeffs(t)
        h1 = lam1 - lam2
        h0 = lam0 - lam1
        h = lam_t - lam0
        r0, r1 = h0 / h, h1 / h
        d1_0 = (1.0 / r0) * (m0 - m1)
        d1_1 = (1.0 / r1) * (m1 - m2)
        d1 = d1_0 + (r0 / (r0 + r1)) * (d1_0 - d1_1)
        d2 = (1.0 / (r0 + r1)) * (d1_0 - d1_1)
        alpha_t = math.exp(log_a_t)
        if self.algorithm_type == "dpmsolver++":
            phi_1 = math.expm1(-h)
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            return ((sig_t / sig0) * x - (alpha_t * phi_1) * m0
                    + (alpha_t * phi_2) * d1 - (alpha_t * phi_3) * d2)
        phi_1 = math.expm1(h)
        phi_2 = phi_1 / h - 1.0
        phi_3 = phi_2 / h - 0.5
        return (math.exp(log_a_t - log_a0) * x - (sig_t * phi_1) * m0
                - (sig_t * phi_2) * d1 - (sig_t * phi_3) * d2)

    def multistep_update(self, x, model_prev, t_prev, t, order, solver_type):
        if order == 1:
            return self.first_update(x, t_prev[-1], t, model_s=model_prev[-1])
        if order == 2:
            return self.multistep_second_update(x, model_prev, t_prev, t, solver_type)
        if order == 3:
            return self.multistep_third_update(x, model_prev, t_prev, t, solver_type)
        raise ValueError(f"order must be 1/2/3, got {order}")

    # ------------------------------------------------------- SDE updates
    def sde_first_update(self, x, s: float, t: float, model_s, noise):
        """Order-1 SDE-DPM-Solver step (diffusers' sde-dpmsolver(++))."""
        lam_s, log_a_s, sig_s = self._coeffs(s)
        lam_t, log_a_t, sig_t = self._coeffs(t)
        h = lam_t - lam_s
        alpha_t = math.exp(log_a_t)
        if self.algorithm_type == "dpmsolver++":
            return ((sig_t / sig_s) * math.exp(-h) * x
                    + alpha_t * (-math.expm1(-2.0 * h)) * model_s
                    + sig_t * math.sqrt(max(0.0, -math.expm1(-2.0 * h))) * noise)
        return (math.exp(log_a_t - log_a_s) * x - 2.0 * sig_t * math.expm1(h) * model_s
                + sig_t * math.sqrt(max(0.0, math.expm1(2.0 * h))) * noise)

    def sde_multistep_second_update(self, x, model_prev: Sequence, t_prev: Sequence[float],
                                    t: float, noise):
        """Order-2 multistep SDE update (midpoint form, diffusers)."""
        m1, m0 = model_prev[-2], model_prev[-1]
        t1, t0 = t_prev[-2], t_prev[-1]
        lam1, _, _ = self._coeffs(t1)
        lam0, log_a0, sig0 = self._coeffs(t0)
        lam_t, log_a_t, sig_t = self._coeffs(t)
        h0, h = lam0 - lam1, lam_t - lam0
        r0 = h0 / h
        d1_0 = (1.0 / r0) * (m0 - m1)
        alpha_t = math.exp(log_a_t)
        if self.algorithm_type == "dpmsolver++":
            k = -math.expm1(-2.0 * h)
            return ((sig_t / sig0) * math.exp(-h) * x + alpha_t * k * m0
                    + 0.5 * alpha_t * k * d1_0 + sig_t * math.sqrt(max(0.0, k)) * noise)
        return (math.exp(log_a_t - log_a0) * x - 2.0 * sig_t * math.expm1(h) * m0
                - sig_t * math.expm1(h) * d1_0
                + sig_t * math.sqrt(max(0.0, math.expm1(2.0 * h))) * noise)

    def sample_sde(self, x: torch.Tensor, noise_fn: NoiseFn, steps: int = 20,
                   t_start: Optional[float] = None, t_end: Optional[float] = None,
                   order: int = 2, skip_type: str = "time_uniform",
                   lower_order_final: bool = True) -> torch.Tensor:
        """Multistep SDE sampling (sde-dpmsolver / sde-dpmsolver++), orders
        1-2; step k (1..steps) takes draw k - 1."""
        if not self.sde:
            raise ValueError("construct DPMSolver with an sde-* algorithm_type")
        if order not in (1, 2):
            raise ValueError(f"SDE order must be 1 or 2, got {order}")
        t_0 = (1.0 / self.ns.total_N) if t_end is None else t_end
        t_T = self.ns.T if t_start is None else t_start
        ts = [float(v) for v in get_time_steps(self.ns, skip_type, t_T, t_0, steps)]

        def update(x, model_prev, t_prev, t, step_order, step):
            noise = noise_fn(step - 1, x.shape).to(x.device, x.dtype)
            if step_order == 1:
                return self.sde_first_update(x, t_prev[-1], t, model_prev[-1], noise)
            return self.sde_multistep_second_update(x, model_prev, t_prev, t, noise)

        return multistep_loop(x, ts, order, lower_order_final, self.model, update)

    # ----------------------------------------------------- singlestep updates
    def singlestep_second_update(self, x, s: float, t: float, r1: float = 0.5,
                                 solver_type: str = "dpmsolver", model_s=None,
                                 return_s1: bool = False):
        """Singlestep order 2 with one intermediate point; `model_s` when
        the caller has it, and (x_t, model_s1) with `return_s1`."""
        ns = self.ns
        lam_s = float(ns.marginal_lambda(s))
        lam_t = float(ns.marginal_lambda(t))
        h = lam_t - lam_s
        s1 = float(ns.inverse_lambda(lam_s + r1 * h))
        log_a_s = float(ns.marginal_log_mean_coeff(s))
        log_a_s1 = float(ns.marginal_log_mean_coeff(s1))
        log_a_t = float(ns.marginal_log_mean_coeff(t))
        sig_s, sig_s1, sig_t = (float(ns.marginal_std(v)) for v in (s, s1, t))
        if model_s is None:
            model_s = self.model(x, s)
        if self.algorithm_type == "dpmsolver++":
            phi_11, phi_1 = math.expm1(-r1 * h), math.expm1(-h)
            x_s1 = (sig_s1 / sig_s) * x - math.exp(log_a_s1) * phi_11 * model_s
            model_s1 = self.model(x_s1, s1)
            alpha_t = math.exp(log_a_t)
            if solver_type == "dpmsolver":
                x_t = ((sig_t / sig_s) * x - alpha_t * phi_1 * model_s
                       - (0.5 / r1) * alpha_t * phi_1 * (model_s1 - model_s))
            else:
                x_t = ((sig_t / sig_s) * x - alpha_t * phi_1 * model_s
                       + (1.0 / r1) * alpha_t * (phi_1 / h + 1.0) * (model_s1 - model_s))
        else:
            phi_11, phi_1 = math.expm1(r1 * h), math.expm1(h)
            x_s1 = math.exp(log_a_s1 - log_a_s) * x - sig_s1 * phi_11 * model_s
            model_s1 = self.model(x_s1, s1)
            if solver_type == "dpmsolver":
                x_t = (math.exp(log_a_t - log_a_s) * x - sig_t * phi_1 * model_s
                       - (0.5 / r1) * sig_t * phi_1 * (model_s1 - model_s))
            else:
                x_t = (math.exp(log_a_t - log_a_s) * x - sig_t * phi_1 * model_s
                       - (1.0 / r1) * sig_t * (phi_1 / h - 1.0) * (model_s1 - model_s))
        return (x_t, model_s1) if return_s1 else x_t

    def singlestep_third_update(self, x, s: float, t: float, r1: float = 1.0 / 3.0,
                                r2: float = 2.0 / 3.0, solver_type: str = "dpmsolver",
                                model_s=None, model_s1=None):
        """Singlestep order 3 with two intermediate points; `model_s` and
        `model_s1` when the caller has them."""
        ns = self.ns
        lam_s = float(ns.marginal_lambda(s))
        lam_t = float(ns.marginal_lambda(t))
        h = lam_t - lam_s
        s1 = float(ns.inverse_lambda(lam_s + r1 * h))
        s2 = float(ns.inverse_lambda(lam_s + r2 * h))
        log_a = {v: float(ns.marginal_log_mean_coeff(v)) for v in (s, s1, s2, t)}
        sig = {v: float(ns.marginal_std(v)) for v in (s, s1, s2, t)}
        if model_s is None:
            model_s = self.model(x, s)
        if self.algorithm_type == "dpmsolver++":
            phi_11 = math.expm1(-r1 * h)
            phi_12 = math.expm1(-r2 * h)
            phi_1 = math.expm1(-h)
            phi_22 = math.expm1(-r2 * h) / (r2 * h) + 1.0
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            if model_s1 is None:
                x_s1 = (sig[s1] / sig[s]) * x - math.exp(log_a[s1]) * phi_11 * model_s
                model_s1 = self.model(x_s1, s1)
            x_s2 = ((sig[s2] / sig[s]) * x - math.exp(log_a[s2]) * phi_12 * model_s
                    + (r2 / r1) * math.exp(log_a[s2]) * phi_22 * (model_s1 - model_s))
            model_s2 = self.model(x_s2, s2)
            alpha_t = math.exp(log_a[t])
            if solver_type == "dpmsolver":
                return ((sig[t] / sig[s]) * x - alpha_t * phi_1 * model_s
                        + (1.0 / r2) * alpha_t * phi_2 * (model_s2 - model_s))
            d1_0 = (1.0 / r1) * (model_s1 - model_s)
            d1_1 = (1.0 / r2) * (model_s2 - model_s)
            d1 = (r2 * d1_0 - r1 * d1_1) / (r2 - r1)
            d2 = 2.0 * (d1_1 - d1_0) / (r2 - r1)
            return ((sig[t] / sig[s]) * x - alpha_t * phi_1 * model_s
                    + alpha_t * phi_2 * d1 - alpha_t * phi_3 * d2)
        phi_11 = math.expm1(r1 * h)
        phi_12 = math.expm1(r2 * h)
        phi_1 = math.expm1(h)
        phi_22 = math.expm1(r2 * h) / (r2 * h) - 1.0
        phi_2 = phi_1 / h - 1.0
        phi_3 = phi_2 / h - 0.5
        if model_s1 is None:
            x_s1 = math.exp(log_a[s1] - log_a[s]) * x - sig[s1] * phi_11 * model_s
            model_s1 = self.model(x_s1, s1)
        x_s2 = (math.exp(log_a[s2] - log_a[s]) * x - sig[s2] * phi_12 * model_s
                - (r2 / r1) * sig[s2] * phi_22 * (model_s1 - model_s))
        model_s2 = self.model(x_s2, s2)
        if solver_type == "dpmsolver":
            return (math.exp(log_a[t] - log_a[s]) * x - sig[t] * phi_1 * model_s
                    - (1.0 / r2) * sig[t] * phi_2 * (model_s2 - model_s))
        d1_0 = (1.0 / r1) * (model_s1 - model_s)
        d1_1 = (1.0 / r2) * (model_s2 - model_s)
        d1 = (r2 * d1_0 - r1 * d1_1) / (r2 - r1)
        d2 = 2.0 * (d1_1 - d1_0) / (r2 - r1)
        return (math.exp(log_a[t] - log_a[s]) * x - sig[t] * phi_1 * model_s
                - sig[t] * phi_2 * d1 - sig[t] * phi_3 * d2)

    def singlestep_update(self, x, s, t, order, solver_type, r1=None, r2=None):
        if order == 1:
            return self.first_update(x, s, t)
        if order == 2:
            return self.singlestep_second_update(x, s, t, 0.5 if r1 is None else r1, solver_type)
        if order == 3:
            return self.singlestep_third_update(
                x, s, t, 1.0 / 3.0 if r1 is None else r1, 2.0 / 3.0 if r2 is None else r2,
                solver_type)
        raise ValueError(order)

    def singlestep_orders_and_timesteps(self, steps: int, order: int, skip_type: str,
                                        t_T: float, t_0: float):
        """DPM-Solver-fast's order per outer step and the outer time grid."""
        if order == 3:
            K = steps // 3 + 1
            if steps % 3 == 0:
                orders = [3] * (K - 2) + [2, 1]
            elif steps % 3 == 1:
                orders = [3] * (K - 1) + [1]
            else:
                orders = [3] * (K - 1) + [2]
        elif order == 2:
            K = steps // 2 if steps % 2 == 0 else steps // 2 + 1
            orders = [2] * K if steps % 2 == 0 else [2] * (K - 1) + [1]
        elif order == 1:
            orders = [1] * steps
        else:
            raise ValueError(order)
        if skip_type == "logSNR":
            outer = get_time_steps(self.ns, skip_type, t_T, t_0, len(orders))
        else:
            full = get_time_steps(self.ns, skip_type, t_T, t_0, steps)
            outer = full[np.cumsum([0] + orders)]
        return outer, orders

    # ------------------------------------------------------- adaptive step
    def sample_adaptive(self, x: torch.Tensor, order: int = 2,
                        t_start: Optional[float] = None, t_end: Optional[float] = None,
                        h_init: float = 0.05, atol: float = 0.0078, rtol: float = 0.05,
                        theta: float = 0.9, t_err: float = 1e-5,
                        solver_type: str = "dpmsolver", max_nfe: int = 1200,
                        return_nfe: bool = False):
        """Adaptive step size: an embedded lower/higher-order pair per step,
        accepted when the scaled error E <= 1. The times are host floats;
        each step reads E back from the card to decide. `max_nfe` bounds
        the loop."""
        if order not in (2, 3):
            raise ValueError("the adaptive solver takes order 2 or 3")
        ns = self.ns
        t_0 = (1.0 / ns.total_N) if t_end is None else t_end
        t_T = ns.T if t_start is None else t_start
        lam = lambda t: float(ns.marginal_lambda(t))
        if order == 2:
            lower = lambda xi, s, t, m: (self.first_update(xi, s, t, model_s=m), None)
            higher = lambda xi, s, t, m, _: self.singlestep_second_update(
                xi, s, t, 0.5, solver_type, model_s=m)
        else:  # the order-3 estimate takes the 'dpmsolver' form, as in JAX
            lower = lambda xi, s, t, m: self.singlestep_second_update(
                xi, s, t, 1.0 / 3.0, solver_type, model_s=m, return_s1=True)
            higher = lambda xi, s, t, m, m1: self.singlestep_third_update(
                xi, s, t, 1.0 / 3.0, 2.0 / 3.0, "dpmsolver", model_s=m, model_s1=m1)
        lambda_0 = lam(t_0)
        B = x.shape[0]
        in_dtype = x.dtype
        x = x.float()
        x_prev, s, h, nfe = x, float(t_T), float(h_init), 0
        while abs(s - t_0) > t_err and nfe < max_nfe:
            t = float(ns.inverse_lambda(lam(s) + h))
            model_s = self.model(x, s)
            x_lower, model_s1 = lower(x, s, t, model_s)
            x_higher = higher(x, s, t, model_s, model_s1)
            delta = torch.maximum(torch.full_like(x_lower, atol),
                                  rtol * torch.maximum(x_lower.abs(), x_prev.abs()))
            err = ((x_higher - x_lower) / delta) ** 2
            E = float(err.reshape(B, -1).mean(dim=-1).sqrt().max())
            if E <= 1.0:
                x, x_prev, s = x_higher, x_lower, t
            grow = E ** (-1.0 / order) if E > 0 else math.inf
            h = min(theta * h * grow, lambda_0 - lam(s))
            nfe += order
        x = x.to(in_dtype)
        return (x, nfe) if return_nfe else x

    # -------------------------------------------------------------- sample
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
        """Sample from t_start to t_end: multistep, singlestep (DPM-Solver-fast
        order allocation), singlestep_fixed or adaptive. Multistep dpmsolver++
        of order <= 2 in the 'dpmsolver' form is `sample_scan`; every other
        multistep run takes `multistep_loop`."""
        t_0 = (1.0 / self.ns.total_N) if t_end is None else t_end
        t_T = self.ns.T if t_start is None else t_start
        if not (t_0 > 0 and t_T > 0):
            raise ValueError("t_start and t_end must be positive")
        if self.sde:
            raise ValueError("sde-* algorithm types need a noise stream: call "
                             "sample_sde(x, noise_fn, ...) instead of sample()")
        if method in ("singlestep", "singlestep_fixed"):
            if method == "singlestep":
                outer, orders = self.singlestep_orders_and_timesteps(
                    steps, order, skip_type, t_T, t_0)
            else:
                K = steps // order
                orders = [order] * K
                outer = get_time_steps(self.ns, skip_type, t_T, t_0, K)
            for i, step_order in enumerate(orders):
                s, t = float(outer[i]), float(outer[i + 1])
                inner = get_time_steps(self.ns, skip_type, s, t, step_order)
                lam = self.ns.marginal_lambda(inner)
                h = float(lam[-1] - lam[0])
                r1 = None if step_order <= 1 else float((lam[1] - lam[0]) / h)
                r2 = None if step_order <= 2 else float((lam[2] - lam[0]) / h)
                x = self.singlestep_update(x, s, t, step_order, solver_type, r1, r2)
            if denoise_to_zero:
                x = self.denoise_to_zero(x, float(outer[-1]))
            return x
        if method == "adaptive":
            x = self.sample_adaptive(x, order=order, t_start=t_T, t_end=t_0,
                                     solver_type=solver_type)
            if denoise_to_zero:
                x = self.denoise_to_zero(x, t_0)
            return x
        if method != "multistep":
            raise NotImplementedError(f"method={method}")
        if steps < order:
            raise ValueError(f"steps ({steps}) < order ({order})")
        if (order <= 2 and self.algorithm_type == "dpmsolver++" and solver_type == "dpmsolver"
                and self.correcting_x0_fn is None and not denoise_to_zero):
            return self.sample_scan(x, steps=steps, t_start=t_T, t_end=t_0, order=order,
                                    skip_type=skip_type, lower_order_final=lower_order_final)
        ts = [float(t) for t in get_time_steps(self.ns, skip_type, t_T, t_0, steps)]
        x = multistep_loop(
            x, ts, order, lower_order_final, self.model,
            lambda x, model_prev, t_prev, t, step_order, _: self.multistep_update(
                x, model_prev, t_prev, t, step_order, solver_type))
        if denoise_to_zero:
            x = self.denoise_to_zero(x, ts[-1])
        return x

    def denoise_to_zero(self, x, s: float):
        """The final x0 projection at time s (one more model call)."""
        return self.first_update(x, s, 1.0 / self.ns.total_N)

    def sample_scan(self, x: torch.Tensor, steps: int, t_start: float, t_end: float,
                    order: int = 2, skip_type: str = "time_uniform",
                    lower_order_final: bool = True, state_model_fn=None, model_state=None,
                    refresh_mask=None, return_state: bool = False):
        """Multistep dpmsolver++ of order <= 2 with every step in one form:
        the first step's order 1 and the lower-order tail zero the D1
        coefficient. Coefficients in f64 on the host, rounded to f32 as
        JAX's scan columns are.

        With `state_model_fn(x, t, state, use_cache) -> (eps, state)` in
        place of the noise model, `model_state` rides the loop: the model
        call at ts[0] always refreshes, the one at step i (1..steps-1) gets
        `use_cache = not refresh_mask[i]`. `return_state` also returns the
        final state."""
        ns = self.ns
        ts = get_time_steps(ns, skip_type, t_start, t_end, steps)  # [S + 1] f64
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
        stateful = state_model_fn is not None
        if stateful:
            if model_state is None or refresh_mask is None:
                raise ValueError("state_model_fn needs model_state and refresh_mask")
            refresh_mask = np.asarray(refresh_mask, bool)
            if refresh_mask.shape != (steps,):
                raise ValueError(f"refresh_mask of shape {refresh_mask.shape}, expected "
                                 f"({steps},)")
        state = model_state

        def x0_pred(xi, i):
            nonlocal state
            if stateful:
                refresh = i == 0 or bool(refresh_mask[i])
                eps, state = state_model_fn(xi, float(ts[i]), state, not refresh)
            else:
                eps = self.noise_fn(xi, float(ts[i]))
            return (xi - f32(sig[i]) * eps) / f32(alpha[i])

        m0 = x0_pred(x, 0)
        m1 = m0  # its coefficient is zero on the first step
        for i in range(steps):
            x = f32(sr[i]) * x - f32(aphi[i]) * (m0 + f32(c1[i]) * (m0 - m1))
            if i + 1 < steps:
                m0, m1 = x0_pred(x, i + 1), m0
        return (x, state) if return_state else x


def model_time(ns: NoiseScheduleVP, t_cont: float) -> torch.Tensor:
    """The network's time input for continuous t, an f32 scalar tensor:
    (t - 1/N) * 1000 for a discrete schedule, computed in f32 as JAX does."""
    t = torch.tensor(t_cont, dtype=torch.float32)
    return (t - 1.0 / ns.total_N) * 1000.0 if ns.schedule == "discrete" else t


def cfg_batch(x: torch.Tensor, condition, uncondition):
    """The classifier-free guidance batch: [x, x] against [uncondition, condition]."""
    return torch.cat([x, x], dim=0), torch.cat([uncondition, condition], dim=0)


def cfg_guide(noise: torch.Tensor, cfg_scale: float) -> torch.Tensor:
    """Guided noise from the prediction over a `cfg_batch`."""
    noise_uncond, noise_cond = noise.chunk(2, dim=0)
    return noise_uncond + cfg_scale * (noise_cond - noise_uncond)


def make_cfg_model_fn(
    apply_fn: Callable,
    ns: NoiseScheduleVP,
    condition,
    uncondition,
    cfg_scale: float,
    model_type: str = "noise",
    model_kwargs: Optional[dict] = None,
    guidance_type: str = "classifier-free",
    classifier_fn: Optional[Callable] = None,
) -> ContinuousModelFn:
    """The guided continuous-time noise predictor.

    `apply_fn(x, t_model, cond, **model_kwargs)` is the network, predicting
    noise, x0 ("x_start"), v or the score (`model_type`). Guidance:
    classifier-free runs cond and uncond as one 2B batch with the
    unconditional half first; "classifier" subtracts
    cfg_scale * sigma_t * grad_x sum log p(cond | x_t), the gradient of
    `classifier_fn(x, t_model, cond)` taken with `torch.autograd.grad`;
    "uncond" runs the model alone.
    """
    model_kwargs = model_kwargs or {}
    if model_type not in ("noise", "x_start", "v", "score"):
        raise ValueError(f"unknown model_type {model_type!r}")
    if guidance_type not in ("uncond", "classifier", "classifier-free"):
        raise ValueError(f"unknown guidance_type {guidance_type!r}")

    def marginals(t_cont):
        """alpha_t, sigma_t in f32, as the JAX wrapper computes them."""
        if ns.schedule == "discrete":
            la = np.interp(np.float32(t_cont), ns.t_array.astype(np.float32),
                           ns.log_alpha_array.astype(np.float32))
        else:
            la = -0.25 * t_cont**2 * (ns.beta_1 - ns.beta_0) - 0.5 * t_cont * ns.beta_0
        la = np.float32(la)
        return (float(np.exp(la)),
                float(np.sqrt(np.float32(1.0) - np.exp(np.float32(2.0) * la))))

    def to_noise(x, t_cont, out):
        if model_type == "noise":
            return out
        alpha_t, sigma_t = marginals(t_cont)
        if model_type == "x_start":
            return (x - alpha_t * out) / sigma_t
        if model_type == "v":
            return alpha_t * out + sigma_t * x
        return -sigma_t * out  # score

    def model_fn(x, t_cont: float):
        t_model = model_time(ns, t_cont)
        if guidance_type == "uncond":
            t_vec = t_model.to(x.device).expand(x.shape[0])
            return to_noise(x, t_cont, apply_fn(x, t_vec, condition, **model_kwargs))
        if guidance_type == "classifier":
            if classifier_fn is None:
                raise ValueError("classifier guidance needs classifier_fn")
            t_vec = t_model.to(x.device).expand(x.shape[0])
            with torch.enable_grad():
                xx = x.detach().requires_grad_(True)
                cond_grad, = torch.autograd.grad(classifier_fn(xx, t_vec, condition).sum(), xx)
            _, sigma_t = marginals(t_cont)
            noise = to_noise(x, t_cont, apply_fn(x, t_vec, condition, **model_kwargs))
            return noise - cfg_scale * sigma_t * cond_grad
        if cfg_scale == 1.0 or uncondition is None:
            t_vec = t_model.to(x.device).expand(x.shape[0])
            return to_noise(x, t_cont, apply_fn(x, t_vec, condition, **model_kwargs))
        x_in, c_in = cfg_batch(x, condition, uncondition)
        t_vec = t_model.to(x.device).expand(x_in.shape[0])
        return cfg_guide(to_noise(x_in, t_cont, apply_fn(x_in, t_vec, c_in, **model_kwargs)),
                         cfg_scale)

    return model_fn


def dpm_solver_sample(model_fn: ContinuousModelFn, betas: np.ndarray, x: torch.Tensor,
                      steps: int = 20, order: int = 2, **kwargs) -> torch.Tensor:
    """One call: build the schedule and the solver, and sample (dpmsolver++)."""
    ns = NoiseScheduleVP("discrete", betas=betas)
    solver = DPMSolver(model_fn, ns, algorithm_type="dpmsolver++")
    return solver.sample(x, steps=steps, order=order, **kwargs)
