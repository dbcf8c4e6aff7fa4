"""Optimizers: CAME (the Sigma configs' default) and AdamW, a global-norm
gradient clip and the LR auto-scaling rule.

Port of pixart_sigma_tpu/training/optim.py. CAME (Luo et al. 2023) keeps a
full momentum per parameter and factors both its second moment and its
confidence statistic over a parameter's last two dims, Adafactor-style.
Which dims those are depends on the layout: a torch Linear weight [out, in]
is the transpose of the flax kernel [in, out], and the factoring is
symmetric under a transpose, but a convolution is not. So CAME factors each
parameter in the JAX package's layout (`jax_layout`): the patch embedding,
a flax Dense over (p, p, c) inputs, as a 2D [D, p*p*c] matrix, and the
depthwise KV-compression conv, [C, 1, sr, sr] in torch, as flax's HWIO
[sr, sr, 1, C]. Lion is not ported yet.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence, Tuple

import torch


def jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A view of parameter `name` in the layout the JAX package factors."""
    if name.endswith("x_embedder.proj.weight"):  # Dense [(p, p, c), D] in JAX
        return t.flatten(1)
    if t.ndim == 4:  # conv OIHW -> HWIO
        return t.permute(2, 3, 1, 0)
    return t


def _approx_sq_grad(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Adafactor rank-1 reconstruction: rsqrt(R / mean(R)) (x) rsqrt(C)."""
    r = torch.rsqrt(row / row.mean(dim=-1, keepdim=True))[..., None]
    return r * torch.rsqrt(col)[..., None, :]


class CAME(torch.optim.Optimizer):
    """CAME over named parameters: `params` is a sequence of (name, tensor).

    State (f32, in the `jax_layout` view): exp_avg, and for a parameter of
    two or more dims the factored row/col second moments and confidence
    rows/cols; a vector keeps a full second moment. The update is the JAX
    package's `came`; `step` takes the rate from the param group's "lr".
    """

    def __init__(
        self,
        params: Iterable[Tuple[str, torch.Tensor]],
        lr: float,
        betas: Tuple[float, float, float] = (0.9, 0.999, 0.9999),
        eps: Tuple[float, float] = (1e-30, 1e-16),
        clip_threshold: float = 1.0,
        weight_decay: float = 0.0,
    ):
        named = list(params)
        super().__init__([p for _, p in named], dict(
            lr=lr, betas=betas, eps=eps, clip_threshold=clip_threshold,
            weight_decay=weight_decay))
        self._names = {p: n for n, p in named}

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, wd, clip = group["lr"], group["weight_decay"], group["clip_threshold"]
            beta1, beta2, beta3 = group["betas"]
            eps1, eps2 = group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                name = self._names[p]
                g = jax_layout(name, p.grad).float()
                pv = jax_layout(name, p)
                st = self.state[p]
                factored = g.ndim >= 2
                if not st:
                    st["exp_avg"] = torch.zeros_like(g)
                    if factored:
                        st["row"] = g.new_zeros(g.shape[:-1])
                        st["col"] = g.new_zeros(g.shape[:-2] + g.shape[-1:])
                        st["res_row"] = torch.zeros_like(st["row"])
                        st["res_col"] = torch.zeros_like(st["col"])
                    else:
                        st["row"] = torch.zeros_like(g)
                sq = g.square() + eps1
                if factored:
                    st["row"].mul_(beta2).add_(sq.mean(dim=-1), alpha=1 - beta2)
                    st["col"].mul_(beta2).add_(sq.mean(dim=-2), alpha=1 - beta2)
                    u = _approx_sq_grad(st["row"], st["col"]) * g
                else:
                    st["row"].mul_(beta2).add_(sq, alpha=1 - beta2)
                    u = g * torch.rsqrt(st["row"])
                u = u / torch.clamp(u.square().mean().sqrt() / clip, min=1.0)
                m = st["exp_avg"].mul_(beta1).add_(u, alpha=1 - beta1)
                if factored:
                    res = (u - m).square() + eps2
                    st["res_row"].mul_(beta3).add_(res.mean(dim=-1), alpha=1 - beta3)
                    st["res_col"].mul_(beta3).add_(res.mean(dim=-2), alpha=1 - beta3)
                    upd = _approx_sq_grad(st["res_row"], st["res_col"]) * m
                else:
                    upd = m
                delta = -lr * upd
                if wd:
                    delta = delta - lr * wd * pv.float()
                pv.add_(delta.to(p.dtype))


def auto_scale_lr(lr: float, effective_bs: int, rule: str = "linear",
                  base_batch_size: int = 256) -> Tuple[float, float]:
    """Linear or sqrt LR scaling with the batch; returns (lr, ratio)."""
    if rule not in ("linear", "sqrt"):
        raise ValueError(f"unknown LR scaling rule {rule!r}")
    ratio = effective_bs / base_batch_size
    if rule == "sqrt":
        ratio = math.sqrt(ratio)
    return lr * ratio, ratio


@torch.no_grad()
def clip_by_global_norm(params: Sequence[torch.Tensor], max_norm: Optional[float]) -> float:
    """Scale the gradients by max_norm / norm when their global norm reaches
    max_norm (optax.clip_by_global_norm); returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    if max_norm is not None:
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        for g in grads:
            g.mul_(scale.to(g.dtype))
    return float(norm)


def build_optimizer(named_params: Sequence[Tuple[str, torch.Tensor]], *, name: str = "came",
                    lr: float, weight_decay: float = 0.0, betas=None,
                    eps=None) -> torch.optim.Optimizer:
    """The config's `optimizer` dict as a torch optimizer (the clip is
    `clip_by_global_norm`, applied by the train step before it)."""
    if name == "came":
        # eps may leak in as a scalar from a merged AdamW base config; CAME
        # needs its (eps1, eps2) pair, so fall back to the paper's defaults
        eps_pair = tuple(eps) if isinstance(eps, (tuple, list)) else (1e-30, 1e-16)
        return CAME(named_params, lr, betas=tuple(betas) if betas else (0.9, 0.999, 0.9999),
                    eps=eps_pair, weight_decay=weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(
            [p for _, p in named_params], lr=lr,
            betas=(betas[0], betas[1]) if betas else (0.9, 0.999),
            eps=eps if isinstance(eps, float) else 1e-10, weight_decay=weight_decay)
    raise ValueError(f"optimizer {name!r} is not ported (ROADMAP.md, Queue 1)")
