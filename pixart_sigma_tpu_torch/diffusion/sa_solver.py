"""SA-Solver: the stochastic Adams predictor-corrector sampler.

Port of pixart_sigma_tpu/diffusion/sa_solver.py. Every gradient coefficient
(exponential integral x Lagrange) is a function of the time grid and the tau
schedule only, so it is host float64; the tensors see `steps` model calls,
linear combinations and the per-step noise. One Python loop serves both
modes (few_steps, more_steps), both PC modes (PEC, PECE) and any orders;
JAX's one-scan path for the pipeline's setting (few_steps, PEC, orders 2/2,
data prediction) computes the same updates with f32 coefficient columns.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Union

import numpy as np
import torch

from pixart_sigma_tpu_torch.diffusion.dpm_solver import ContinuousModelFn, NoiseScheduleVP
from pixart_sigma_tpu_torch.diffusion.noise import NoiseFn

# ----------------------------------------------------------------------
# host coefficient math (float64 scalars)
# ----------------------------------------------------------------------


def _exp_int_negative(order: int, a: float, b: float) -> float:
    """Integral of exp(-x) x^order dx on [a, b] (noise prediction)."""
    eab = math.exp(b - a)
    if order == 0:
        return math.exp(-b) * (eab - 1)
    if order == 1:
        return math.exp(-b) * ((a + 1) * eab - (b + 1))
    if order == 2:
        return math.exp(-b) * ((a**2 + 2 * a + 2) * eab - (b**2 + 2 * b + 2))
    if order == 3:
        return math.exp(-b) * (
            (a**3 + 3 * a**2 + 6 * a + 6) * eab - (b**3 + 3 * b**2 + 6 * b + 6))
    raise ValueError(order)


def _exp_int_positive(order: int, a: float, b: float, tau: float) -> float:
    """Integral of exp(x (1 + tau^2)) x^order dx on [a, b] (data prediction)."""
    s = 1 + tau**2
    ac, bc = s * a, s * b
    e = math.exp(bc)
    d = math.exp(-(bc - ac))
    if order == 0:
        return e * (1 - d) / s
    if order == 1:
        return e * ((bc - 1) - (ac - 1) * d) / s**2
    if order == 2:
        return e * ((bc**2 - 2 * bc + 2) - (ac**2 - 2 * ac + 2) * d) / s**3
    if order == 3:
        return e * ((bc**3 - 3 * bc**2 + 6 * bc - 6)
                    - (ac**3 - 3 * ac**2 + 6 * ac - 6) * d) / s**4
    raise ValueError(order)


def _lagrange_coeffs(order: int, lams: Sequence[float]) -> List[List[float]]:
    """Each Lagrange basis polynomial through `lams` in monomial form,
    highest power first."""
    if order != len(lams) - 1:
        raise ValueError(f"order {order} needs {order + 1} nodes, got {len(lams)}")
    if order == 0:
        return [[1.0]]
    out = []
    for i in range(order + 1):
        denom = 1.0
        for j in range(order + 1):
            if j != i:
                denom *= lams[i] - lams[j]
        poly = [1.0]
        for j in range(order + 1):
            if j == i:
                continue
            new = [0.0] * (len(poly) + 1)
            for k, c in enumerate(poly):
                new[k] += c
                new[k + 1] += -lams[j] * c
            poly = new
        out.append([c / denom for c in poly])
    return out


def _gradient_coefficients(order: int, interval_start: float, interval_end: float,
                           lams: Sequence[float], tau: float, predict_x0: bool) -> List[float]:
    """The weight of each of the last `order` model outputs over
    [interval_start, interval_end] in lambda."""
    if order != len(lams):
        raise ValueError(f"order {order} needs {order} nodes, got {len(lams)}")
    lagr = _lagrange_coeffs(order - 1, lams)
    coeffs = []
    for i in range(order):
        c = 0.0
        for j in range(order):
            if predict_x0:
                c += lagr[i][j] * _exp_int_positive(order - 1 - j, interval_start,
                                                    interval_end, tau)
            else:
                c += lagr[i][j] * _exp_int_negative(order - 1 - j, interval_start, interval_end)
        coeffs.append(c)
    return coeffs


def sa_get_time_steps(ns: NoiseScheduleVP, skip_type: str, t_T: float, t_0: float, N: int,
                      order: int) -> np.ndarray:
    """The N + 1 boundary times: logSNR, time (power `order`) or karras."""
    if skip_type == "logSNR":
        lam_T = float(ns.marginal_lambda(t_T))
        lam_0 = float(ns.marginal_lambda(t_0))
        steps = lam_T + np.linspace(0.0, (lam_0 - lam_T) ** (1.0 / order), N + 1) ** order
        return np.asarray(ns.inverse_lambda(steps))
    if skip_type == "time":
        return np.linspace(t_T ** (1.0 / order), t_0 ** (1.0 / order), N + 1) ** order
    if skip_type == "karras":
        # rho-7 spacing in sigma = std / alpha = exp(-lambda), clamped to
        # [max(0.002, sigma(1e-3)), min(80, sigma(T))]
        rho = 7.0
        sigma_min = max(0.002, math.exp(-float(ns.marginal_lambda(1e-3))))
        sigma_max = min(80.0, math.exp(-float(ns.marginal_lambda(ns.T))))
        ramp = np.linspace(sigma_max ** (1 / rho), sigma_min ** (1 / rho), N + 1)
        return np.asarray(ns.inverse_lambda(-np.log(ramp**rho)))
    raise ValueError(f"unsupported skip_type {skip_type}")


# ----------------------------------------------------------------------
# the solver
# ----------------------------------------------------------------------

TauFn = Union[float, Callable[[float], float]]


class SASolver:
    """Stochastic Adams solver over a noise-prediction `model_fn(x, t_cont)`
    (guidance in the caller's wrapper, as for DPMSolver)."""

    def __init__(self, model_fn: ContinuousModelFn, noise_schedule: NoiseScheduleVP,
                 algorithm_type: str = "data_prediction"):
        if algorithm_type not in ("data_prediction", "noise_prediction"):
            raise ValueError(f"unknown algorithm_type {algorithm_type!r}")
        self.noise_fn = model_fn
        self.ns = noise_schedule
        self.predict_x0 = algorithm_type == "data_prediction"

    def model(self, x, t: float):
        if self.predict_x0:
            eps = self.noise_fn(x, t)
            alpha_t = float(self.ns.marginal_alpha(t))
            sigma_t = float(self.ns.marginal_std(t))
            return (x - sigma_t * eps) / alpha_t
        return self.noise_fn(x, t)

    def _update_coeffs(self, *, order: int, tau: float, t_prev: Sequence[float], t: float,
                       corrector: bool, few_steps: bool):
        """(decay, coefs, noise_coef) of one Adams update, host f64:
        x' = decay x + sum_i coefs[i] model_prev[-(i + 1)] + noise_coef n,
        where the corrector's model list holds the predicted point too."""
        ns = self.ns
        alpha_t = float(ns.marginal_alpha(t))
        sigma_t = float(ns.marginal_std(t))
        lam_t = float(ns.marginal_lambda(t))
        alpha_p = float(ns.marginal_alpha(t_prev[-1]))
        sigma_p = float(ns.marginal_std(t_prev[-1]))
        lam_p = float(ns.marginal_lambda(t_prev[-1]))
        h = lam_t - lam_p
        t_list = list(t_prev) + [t] if corrector else list(t_prev)
        lams = [float(ns.marginal_lambda(t_list[-(i + 1)])) for i in range(order)]
        gc = _gradient_coefficients(order, lam_p, lam_t, lams, tau, self.predict_x0)
        if few_steps and self.predict_x0 and order == 2:
            # UniPC-style O(h^3) correction
            s = 1 + tau**2
            if corrector:
                delta = math.exp(s * lam_t) * (h / 2 - (h * s - 1 + math.exp(-s * h)) / (s**2 * h))
            else:
                lam_p1 = float(ns.marginal_lambda(t_prev[-2]))
                delta = math.exp(s * lam_t) * (
                    h**2 / 2 - (h * s - 1 + math.exp(-s * h)) / s**2) / (lam_p - lam_p1)
            gc = [gc[0] + delta, gc[1] - delta]
        if self.predict_x0:
            coefs = [(1 + tau**2) * sigma_t * math.exp(-(tau**2) * lam_t) * g for g in gc]
            noise_coef = sigma_t * math.sqrt(max(0.0, 1 - math.exp(-2 * tau**2 * h)))
            decay = math.exp(-(tau**2) * h) * (sigma_t / sigma_p)
        else:
            coefs = [-(1 + tau**2) * alpha_t * g for g in gc]
            noise_coef = tau * sigma_t * math.sqrt(max(0.0, math.exp(2 * h) - 1))
            decay = alpha_t / alpha_p
        return decay, coefs, noise_coef

    def _update(self, *, order: int, x, tau: float, model_prev: Sequence, t_prev, noise,
                t: float, corrector: bool, few_steps: bool):
        """Adams-Bashforth (predictor) / Adams-Moulton (corrector) update."""
        decay, coefs, noise_coef = self._update_coeffs(
            order=order, tau=tau, t_prev=t_prev, t=t, corrector=corrector,
            few_steps=few_steps)
        out = decay * x
        for i in range(order):
            out = out + coefs[i] * model_prev[-(i + 1)]
        if noise is not None:
            out = out + noise_coef * noise
        return out

    def sample(self, mode: str, x: torch.Tensor, tau: TauFn, steps: int, noise_fn: NoiseFn,
               t_start=None, t_end=None, skip_type: str = "time", skip_order: int = 1,
               predictor_order: int = 3, corrector_order: int = 4,
               pc_mode: str = "PEC") -> torch.Tensor:
        """few_steps: NFE == steps (no final correction, the UniPC term on,
        the last step noise-free); more_steps: NFE == steps + 2 (final
        correction and the denoising step). Step k (1..steps) takes draw
        k - 1; few_steps' last step takes none."""
        if mode not in ("few_steps", "more_steps"):
            raise ValueError(f"unknown mode {mode!r}")
        if pc_mode not in ("PEC", "PECE"):
            raise ValueError(f"unknown pc_mode {pc_mode!r}")
        few = mode == "few_steps"
        tau_fn = tau if callable(tau) else (lambda _t: tau)
        t_0 = 1.0 / self.ns.total_N if t_end is None else t_end
        t_T = self.ns.T if t_start is None else t_start
        if steps < max(predictor_order, corrector_order - 1):
            raise ValueError(f"steps ({steps}) below the solver's orders")
        ts = [float(v) for v in sa_get_time_steps(self.ns, skip_type, t_T, t_0, steps,
                                                    skip_order)]
        t_prev = [ts[0]]
        model_prev = [self.model(x, ts[0])]
        warmup_end = max(predictor_order, corrector_order - 1)
        for step in range(1, steps + 1):
            t = ts[step]
            warm = step < warmup_end
            final = step == steps
            if warm:
                p_order = min(predictor_order, step)
                c_order = min(corrector_order, step + 1)
            else:
                p_order = min(predictor_order, steps - step + 1)
                c_order = min(corrector_order, steps - step + 2)
            noise = None if (few and final) else noise_fn(step - 1, x.shape).to(x.device, x.dtype)
            tau_p = 0.0 if (few and final) else tau_fn(t)
            common = dict(x=x, model_prev=model_prev, t_prev=t_prev, noise=noise, t=t,
                          few_steps=few)
            x_p = self._update(order=p_order, tau=tau_p, corrector=False, **common)
            evaluate = warm or not few or step < steps
            if evaluate:
                model_prev.append(self.model(x_p, t))
            if corrector_order > 0 and evaluate:
                x = self._update(order=c_order, tau=tau_fn(t), corrector=True, **common)
                if pc_mode == "PECE" and step < steps:
                    model_prev[-1] = self.model(x, t)
            else:
                x = x_p
            t_prev.append(t)
            if not warm:
                del model_prev[0]
        if not few:
            # the final x0 projection: data prediction whatever the solver's space
            eps = self.noise_fn(x, t_0)
            x = (x - float(self.ns.marginal_std(t_0)) * eps) / float(self.ns.marginal_alpha(t_0))
        return x


def sa_solver_sample(model_fn: ContinuousModelFn, betas: np.ndarray, x: torch.Tensor,
                     noise_fn: NoiseFn, steps: int = 25, eta: float = 1.0,
                     **kwargs) -> torch.Tensor:
    """The SASolverSampler facade: tau = eta on t in [0.2, 0.8], few-steps
    PEC with predictor and corrector order 2."""
    ns = NoiseScheduleVP("discrete", betas=betas)
    solver = SASolver(model_fn, ns, algorithm_type="data_prediction")
    kwargs.setdefault("predictor_order", 2)
    kwargs.setdefault("corrector_order", 2)
    return solver.sample("few_steps", x, lambda t: eta if 0.2 <= t <= 0.8 else 0.0, steps,
                         noise_fn, skip_type="time", skip_order=1, pc_mode="PEC", **kwargs)
