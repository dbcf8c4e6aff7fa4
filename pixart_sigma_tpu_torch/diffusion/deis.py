"""DEIS multistep sampler (Diffusion Exponential Integrator Sampler, the
"logrho" variant).

Port of pixart_sigma_tpu/diffusion/deis.py, with DPMSolver's conventions
(continuous-time noise `model_fn`, host f64 coefficients, tensor updates).
With x̄ = x / alpha and rho = sigma / alpha the probability-flow ODE is
dx̄/drho = eps(x, t); DEIS-k extrapolates eps by the Lagrange polynomial in
log rho through the last k model outputs and integrates it exactly over
[rho_s, rho_t]:

    x̄_t = x̄_s + sum_i eps_i * ∫ l_i(log rho) d rho,

with a 64-point Gauss-Legendre quadrature in f64 (any order).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from pixart_sigma_tpu_torch.diffusion.dpm_solver import (
    ContinuousModelFn,
    NoiseScheduleVP,
    get_time_steps,
    multistep_loop,
)


def _lagrange_integrals(rho_nodes: Sequence[float], rho_s: float, rho_t: float) -> List[float]:
    """∫_{rho_s}^{rho_t} l_i(log rho) d rho for each Lagrange basis l_i on
    the nodes log(rho_nodes): u = log rho, d rho = e^u du."""
    logs = np.log(np.asarray(rho_nodes, np.float64))
    u0, u1 = math.log(rho_s), math.log(rho_t)
    nodes, weights = np.polynomial.legendre.leggauss(64)
    u = 0.5 * (u1 - u0) * nodes + 0.5 * (u1 + u0)
    w = 0.5 * (u1 - u0) * weights
    out = []
    for i in range(len(logs)):
        li = np.ones_like(u)
        for j in range(len(logs)):
            if j != i:
                li *= (u - logs[j]) / (logs[i] - logs[j])
        out.append(float(np.sum(w * li * np.exp(u))))
    return out


class DEISMultistep:
    """model_fn(x, t_continuous) -> the noise prediction (guidance in the wrapper)."""

    def __init__(self, model_fn: ContinuousModelFn, noise_schedule: NoiseScheduleVP):
        self.noise_fn = model_fn
        self.ns = noise_schedule

    def _ar(self, t: float):
        alpha = float(self.ns.marginal_alpha(t))
        return alpha, float(self.ns.marginal_std(t)) / alpha

    def multistep_update(self, x, model_prev: Sequence, t_prev: Sequence[float], t: float,
                         order: int):
        alpha_s, rho_s = self._ar(t_prev[-1])
        alpha_t, rho_t = self._ar(t)
        rho_nodes = [self._ar(t_prev[-(i + 1)])[1] for i in range(order)]
        coefs = _lagrange_integrals(rho_nodes, rho_s, rho_t)
        acc = (alpha_t / alpha_s) * x
        for i in range(order):
            acc = acc + (alpha_t * coefs[i]) * model_prev[-(i + 1)]
        return acc

    def sample(self, x: torch.Tensor, steps: int = 20, t_start: Optional[float] = None,
               t_end: Optional[float] = None, order: int = 2, skip_type: str = "time_uniform",
               lower_order_final: bool = True) -> torch.Tensor:
        """Multistep DEIS from t_start to t_end; NFE == steps."""
        t_0 = (1.0 / self.ns.total_N) if t_end is None else t_end
        t_T = self.ns.T if t_start is None else t_start
        if not steps >= order >= 1:
            raise ValueError(f"need steps >= order >= 1, got {steps}, {order}")
        ts = [float(t) for t in get_time_steps(self.ns, skip_type, t_T, t_0, steps)]
        return multistep_loop(
            x, ts, order, lower_order_final, self.noise_fn,
            lambda x, model_prev, t_prev, t, step_order, _: self.multistep_update(
                x, model_prev, t_prev, t, step_order))
