"""Optimizers: CAME (the Sigma configs' default), Lion and AdamW, a
global-norm gradient clip and the LR auto-scaling rule.

Port of pixart_sigma_tpu/training/optim.py. CAME (Luo et al. 2023) keeps a
full momentum per parameter and factors both its second moment and its
confidence statistic over a parameter's last two dims, Adafactor-style.
Which dims those are depends on the layout: a torch Linear weight [out, in]
is the transpose of the flax kernel [in, out], and the factoring is
symmetric under a transpose, but a convolution is not. So CAME factors each
parameter in the JAX package's layout (`jax_layout`): the patch embedding,
a flax Dense over (p, p, c) inputs, as a 2D [D, p*p*c] matrix, and the
depthwise KV-compression conv, [C, 1, sr, sr] in torch, as flax's HWIO
[sr, sr, 1, C]. With a scan-stacked JAX tree (`scan_blocks`, the shipped
configs' default) the JAX trainer's leaves are a scan group's layers
stacked [count, ...]; CAME then factors and clips each stack as one tensor
(`block_stacks`), as JAX does. Lion is optax's `lion`: the sign of
b1 m + (1 - b1) g, momentum b2, decoupled weight decay. Parameters that
`skip_decay(name)` marks (the config's `no_weight_decay_on`) get no weight
decay.

Sharded parameters (DTensors of `parallel.mesh.shard_model`) are updated
through their local shards, and so are their state and gradients: every
statistic that reaches across a shard's cut dims, CAME's row and column
means and its update's RMS, and the gradients' global norm, is reduced
over the groups that cut it (`parallel.sharded`), so R ranks compute the
update of one. `full_state_dict` gathers the state into whole tensors, the
`.pth` layout whatever the sharding; `load_full_state_dict` cuts it again.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from pixart_sigma_tpu_torch.parallel.sharded import (
    ShardDim,
    gather_full,
    groups_of,
    all_reduce_over,
    local,
    mean_over,
    remap,
    shard_dims,
    sharded_sum,
    take_shard,
)


def jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A view of parameter `name` in the layout the JAX package factors."""
    if name.endswith("x_embedder.proj.weight"):  # Dense [(p, p, c), D] in JAX
        return t.flatten(1)
    if t.ndim == 4:  # conv OIHW -> HWIO
        return t.permute(2, 3, 1, 0)
    return t


def jax_layout_dims(name: str, ndim: int) -> Dict[int, int]:
    """torch dim -> dim of the `jax_layout` view, for the dims a shard may
    cut (the patch embedding's flattened input dims are never cut)."""
    if name.endswith("x_embedder.proj.weight"):
        return {0: 0}
    if ndim == 4:
        return {2: 0, 3: 1, 1: 2, 0: 3}
    return {d: d for d in range(ndim)}


def block_stacks(names: Sequence[str], block_groups: Sequence[Tuple[int, int]]
                 ) -> List[List[str]]:
    """The leaves of the JAX scan-stacked tree: for each scan group of
    `block_groups` ([(sr_ratio, count)], `PixArtConfig.block_groups`) and
    each parameter of its first block, that parameter's name in each of the
    group's blocks, in layer order."""
    stacks, start = [], 0
    for _sr, count in block_groups:
        prefix = f"blocks.{start}."
        for name in names:
            if name.startswith(prefix):
                rest = name[len(prefix):]
                stacks.append([f"blocks.{start + j}.{rest}" for j in range(count)])
        start += count
    return stacks


def _approx_sq_grad(row: torch.Tensor, col: torch.Tensor,
                    row_dims: Sequence[ShardDim] = ()) -> torch.Tensor:
    """Adafactor rank-1 reconstruction: rsqrt(R / mean(R)) (x) rsqrt(C)."""
    r = torch.rsqrt(row / mean_over(row, -1, row_dims)[..., None])[..., None]
    return r * torch.rsqrt(col)[..., None, :]


def _row_dims(dims: Sequence[ShardDim], ndim: int) -> Tuple[ShardDim, ...]:
    """The cut dims of a row statistic (the mean over the last dim)."""
    return remap(dims, {i: i for i in range(ndim - 1)})


def _col_dims(dims: Sequence[ShardDim], ndim: int) -> Tuple[ShardDim, ...]:
    """The cut dims of a column statistic (the mean over dim -2)."""
    return remap(dims, {**{i: i for i in range(ndim - 2)}, ndim - 1: ndim - 2})


class _ShardedState:
    """`full_state_dict` / `load_full_state_dict` over `_state_dims(p, key,
    value)`, the cut dims of each state tensor of a parameter."""

    def _state_dims(self, p, key: str, value: torch.Tensor) -> Tuple[ShardDim, ...]:
        return shard_dims(p)

    def _map_state(self, sd: dict, fn) -> dict:
        params = [p for g in self.param_groups for p in g["params"]]
        sd = dict(sd, state=dict(sd["state"]))
        for i, st in sd["state"].items():
            sd["state"][i] = {k: fn(v, self._state_dims(params[i], k, v))
                              if torch.is_tensor(v) and v.ndim else v for k, v in st.items()}
        return sd

    def full_state_dict(self) -> dict:
        """`state_dict()` with every state tensor whole, on the CPU (a
        collective when a parameter is sharded)."""
        return self._map_state(self.state_dict(), lambda v, dims: gather_full(v, dims).cpu())

    def load_full_state_dict(self, sd: dict) -> None:
        """Load a `full_state_dict` (or a one-rank `state_dict`) into this
        rank's shards."""
        self.load_state_dict(self._map_state(sd, take_shard))


class CAME(_ShardedState, torch.optim.Optimizer):
    """CAME over named parameters: `params` is a sequence of (name, tensor).

    State (f32, in the `jax_layout` view): exp_avg, and for a parameter of
    two or more dims the factored row/col second moments and confidence
    rows/cols; a vector keeps a full second moment. The update is the JAX
    package's `came`; `step` takes the rate from the param group's "lr".

    `stacks` (`block_stacks`): lists of parameter names updated as one
    tensor, their `jax_layout` views stacked on a new first axis, as the
    JAX trainer's scan-stacked leaves: row and column statistics over the
    last two dims (a stacked bias [count, D] is factored), the update's RMS
    clip over the whole stack. The stack's state is kept stacked, under its
    first parameter.
    """

    def __init__(
        self,
        params: Iterable[Tuple[str, torch.Tensor]],
        lr: float,
        betas: Tuple[float, float, float] = (0.9, 0.999, 0.9999),
        eps: Tuple[float, float] = (1e-30, 1e-16),
        clip_threshold: float = 1.0,
        weight_decay: float = 0.0,
        skip_decay: Optional[Callable[[str], bool]] = None,
        stacks: Optional[Sequence[Sequence[str]]] = None,
    ):
        named = list(params)
        super().__init__(_decay_groups(named, weight_decay, skip_decay), dict(
            lr=lr, betas=betas, eps=eps, clip_threshold=clip_threshold,
            weight_decay=weight_decay))
        self._names = {p: n for n, p in named}
        # the cut dims of each parameter's jax_layout view (a stack's: + 1)
        self._dims = {p: remap(shard_dims(p), jax_layout_dims(n, p.ndim)) for n, p in named}
        by_name = dict(named)
        group_of = {p: i for i, g in enumerate(self.param_groups) for p in g["params"]}
        self._stacks: Dict[torch.Tensor, List[torch.Tensor]] = {}
        self._followers = set()
        for members in stacks or ():
            ps = [by_name[n] for n in members]
            if len({group_of[p] for p in ps}) != 1:
                raise ValueError(f"stack {members[0]}...: members in different param groups")
            self._stacks[ps[0]] = ps
            self._followers.update(ps[1:])
            self._dims[ps[0]] = tuple(ShardDim(d.dim + 1, d.group, d.size, d.rank)
                                      for d in self._dims[ps[0]])

    def _state_dims(self, p, key, value):
        """exp_avg (and an unfactored second moment) is cut as the view; the
        row and column statistics of a factored one as `_row_dims` and
        `_col_dims` say."""
        dims = self._dims[p]
        ndim = jax_layout(self._names[p], local(p)).ndim + (p in self._stacks)
        if ndim >= 2 and key in ("row", "res_row"):
            return _row_dims(dims, ndim)
        if key in ("col", "res_col"):
            return _col_dims(dims, ndim)
        return dims

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, wd, clip = group["lr"], group["weight_decay"], group["clip_threshold"]
            beta1, beta2, beta3 = group["betas"]
            eps1, eps2 = group["eps"]
            for p in group["params"]:
                if p.grad is None or p in self._followers:
                    continue
                members = self._stacks.get(p)
                dims = self._dims[p]
                if members is None:
                    views = [jax_layout(self._names[p], local(p))]
                    g = jax_layout(self._names[p], local(p.grad)).float()
                else:
                    views = [jax_layout(self._names[q], local(q)) for q in members]
                    g = torch.stack([jax_layout(self._names[q], local(q.grad)).float()
                                     for q in members])
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
                row_dims = _row_dims(dims, g.ndim)
                sq = g.square() + eps1
                if factored:
                    st["row"].mul_(beta2).add_(mean_over(sq, -1, dims), alpha=1 - beta2)
                    st["col"].mul_(beta2).add_(mean_over(sq, -2, dims), alpha=1 - beta2)
                    u = _approx_sq_grad(st["row"], st["col"], row_dims) * g
                else:
                    st["row"].mul_(beta2).add_(sq, alpha=1 - beta2)
                    u = g * torch.rsqrt(st["row"])
                u = u / torch.clamp(_rms(u, dims) / clip, min=1.0)
                m = st["exp_avg"].mul_(beta1).add_(u, alpha=1 - beta1)
                if factored:
                    res = (u - m).square() + eps2
                    st["res_row"].mul_(beta3).add_(mean_over(res, -1, dims), alpha=1 - beta3)
                    st["res_col"].mul_(beta3).add_(mean_over(res, -2, dims), alpha=1 - beta3)
                    upd = _approx_sq_grad(st["res_row"], st["res_col"], row_dims) * m
                else:
                    upd = m
                delta = -lr * upd
                if members is None:
                    delta = delta[None]
                for j, pv in enumerate(views):
                    d = delta[j] - lr * wd * pv.float() if wd else delta[j]
                    pv.add_(d.to(pv.dtype))


def _rms(u: torch.Tensor, dims: Sequence[ShardDim]) -> torch.Tensor:
    """The root mean square of the full tensor whose shard is `u`."""
    if not dims:
        return u.square().mean().sqrt()
    total = all_reduce_over(u.square().sum(), groups_of(dims))
    return (total / (u.numel() * math.prod(d.size for d in dims))).sqrt()


def _decay_groups(named: Sequence[Tuple[str, torch.Tensor]], weight_decay: float,
                  skip_decay: Optional[Callable[[str], bool]]) -> list:
    """One param group, or two when `skip_decay` exempts some parameters
    (weight_decay 0 in the second)."""
    if skip_decay is None:
        return [{"params": [p for _, p in named]}]
    keep = [p for n, p in named if not skip_decay(n)]
    skip = [p for n, p in named if skip_decay(n)]
    return [{"params": keep}, {"params": skip, "weight_decay": 0.0}]


class Lion(_ShardedState, torch.optim.Optimizer):
    """optax `lion`: u = sign((1 - b1) g + b1 m), m <- b2 m + (1 - b2) g,
    p <- p - lr (u + weight_decay p)."""

    def __init__(self, params: Iterable[Tuple[str, torch.Tensor]], lr: float,
                 betas: Tuple[float, float] = (0.9, 0.99), weight_decay: float = 0.0,
                 skip_decay: Optional[Callable[[str], bool]] = None):
        super().__init__(_decay_groups(list(params), weight_decay, skip_decay),
                         dict(lr=lr, betas=betas, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, pv = local(p.grad).float(), local(p)
                st = self.state[p]
                if not st:
                    st["exp_avg"] = torch.zeros_like(g)
                m = st["exp_avg"]
                upd = torch.sign((1.0 - b1) * g + b1 * m)
                m.mul_(b2).add_(g, alpha=1.0 - b2)
                if wd:
                    upd = upd + wd * pv.float()
                pv.add_((upd * -lr).to(pv.dtype))


class AdamW(_ShardedState, torch.optim.Optimizer):
    """optax `adamw`: m and v with bias correction, p <- p - lr (m_hat /
    (sqrt(v_hat) + eps) + weight_decay p); the state keys and "step" are
    torch.optim.AdamW's."""

    def __init__(self, params: Iterable[Tuple[str, torch.Tensor]], lr: float,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 skip_decay: Optional[Callable[[str], bool]] = None):
        super().__init__(_decay_groups(list(params), weight_decay, skip_decay),
                         dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, pv = local(p.grad).float(), local(p)
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(g)
                    st["exp_avg_sq"] = torch.zeros_like(g)
                st["step"] += 1
                t = float(st["step"])
                m = st["exp_avg"].mul_(b1).add_(g, alpha=1.0 - b1)
                v = st["exp_avg_sq"].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                upd = (m / (1.0 - b1**t)) / ((v / (1.0 - b2**t)).sqrt() + eps)
                if wd:
                    upd = upd + wd * pv.float()
                pv.add_((upd * -lr).to(pv.dtype))


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
def global_norm(params: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of the parameters' gradients (f32, on their
    device), over the full tensors of sharded ones."""
    return torch.sqrt(sharded_sum([(local(p.grad).float().square().sum(), shard_dims(p.grad))
                                   for p in params if p.grad is not None]))


@torch.no_grad()
def clip_by_global_norm(params: Sequence[torch.Tensor], max_norm: Optional[float],
                        norm: Optional[torch.Tensor] = None) -> float:
    """Scale the gradients by max_norm / norm when their global norm (given,
    or computed here) reaches max_norm (optax.clip_by_global_norm); returns
    the norm before clipping."""
    norm = global_norm(params) if norm is None else norm
    if max_norm is not None:
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        for p in params:
            if p.grad is not None:
                local(p.grad).mul_(scale.to(p.grad.dtype))
    return float(norm)


def build_optimizer(named_params: Sequence[Tuple[str, torch.Tensor]], *, name: str = "came",
                    lr: float, weight_decay: float = 0.0, betas=None, eps=None,
                    skip_decay: Optional[Callable[[str], bool]] = None,
                    stacks: Optional[Sequence[Sequence[str]]] = None
                    ) -> torch.optim.Optimizer:
    """The config's `optimizer` dict as a torch optimizer (the clip is
    `clip_by_global_norm`, applied before it). `skip_decay(name)` exempts a
    parameter from weight decay. `stacks` (`block_stacks`) are the JAX
    tree's scan-stacked leaves, which CAME factors as one tensor each; the
    elementwise Lion and AdamW update the same either way."""
    if name == "came":
        # eps may leak in as a scalar from a merged AdamW base config; CAME
        # needs its (eps1, eps2) pair, so fall back to the paper's defaults
        eps_pair = tuple(eps) if isinstance(eps, (tuple, list)) else (1e-30, 1e-16)
        return CAME(named_params, lr, betas=tuple(betas) if betas else (0.9, 0.999, 0.9999),
                    eps=eps_pair, weight_decay=weight_decay, skip_decay=skip_decay,
                    stacks=stacks)
    if name == "lion":
        return Lion(named_params, lr, betas=(betas[0], betas[1]) if betas else (0.9, 0.99),
                    weight_decay=weight_decay, skip_decay=skip_decay)
    if name == "adamw":
        return AdamW(named_params, lr, betas=(betas[0], betas[1]) if betas else (0.9, 0.999),
                     eps=eps if isinstance(eps, float) else 1e-10, weight_decay=weight_decay,
                     skip_decay=skip_decay)
    raise ValueError(f"unknown optimizer {name!r}")
