"""Sharded tensors as their local shards.

A parameter that the mesh shards is a DTensor; what this rank holds of it
(and of its gradient, optimizer state and EMA) is a plain tensor, its
local shard. These helpers describe which dims of a local shard are cut
over which process group, gather a full tensor from its shards, cut a
rank's shard out of a full one, and reduce over the groups that shard a
value, so the optimizer, the EMA, the clip and the checkpoints work on
plain local tensors. Every shard is an even `chunk` (the placement rules
shard only divisible axes).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ShardDim:
    """Dim `dim` of a local shard is chunk `rank` of `size` over `group`."""
    dim: int
    group: Any
    size: int
    rank: int


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """The rank's shard of `t` (a view of its storage), or `t` itself."""
    return t.to_local() if is_sharded(t) else t


def shard_dims(t: torch.Tensor) -> Tuple[ShardDim, ...]:
    """The cut dims of a DTensor's local shard over mesh axes above size 1
    (a Replicate axis, as HSDP's data axis, cuts nothing)."""
    if not is_sharded(t):
        return ()
    mesh, out = t.device_mesh, []
    for i, placement in enumerate(t.placements):
        if placement.is_shard() and mesh.size(i) > 1:
            out.append(ShardDim(placement.dim % t.ndim, mesh.get_group(i), mesh.size(i),
                                mesh.get_local_rank(i)))
    return tuple(out)


def remap(dims: Sequence[ShardDim], mapping: Dict[int, int]) -> Tuple[ShardDim, ...]:
    """`dims` renumbered through `mapping` (old dim -> new dim, for a view
    of the shard); a dim missing from `mapping` was reduced away."""
    return tuple(dataclasses.replace(d, dim=mapping[d.dim]) for d in dims if d.dim in mapping)


def gather_full(shard: torch.Tensor, dims: Sequence[ShardDim]) -> torch.Tensor:
    """The full tensor from every rank's shard (a collective over `dims`'
    groups; every rank gets it)."""
    for d in dims:
        parts = [torch.empty_like(shard) for _ in range(d.size)]
        dist.all_gather(parts, shard.contiguous(), group=d.group)
        shard = torch.cat(parts, dim=d.dim)
    return shard


def take_shard(full: torch.Tensor, dims: Sequence[ShardDim]) -> torch.Tensor:
    """This rank's shard of `full` (a copy)."""
    for d in dims:
        full = full.chunk(d.size, dim=d.dim)[d.rank]
    return full.clone()


def groups_of(dims: Iterable[ShardDim]) -> List[Any]:
    out: List[Any] = []
    for d in dims:
        if not any(g is d.group for g in out):
            out.append(d.group)
    return out


def all_reduce_over(t: torch.Tensor, groups: Sequence[Any]) -> torch.Tensor:
    """Sum `t` in place over each of `groups` (orthogonal mesh axes, so
    the result is the sum over their product)."""
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def mean_over(t: torch.Tensor, dim: int, dims: Sequence[ShardDim]) -> torch.Tensor:
    """The mean of a shard over `dim` of the full tensor: the local mean,
    averaged over the groups that cut `dim` (equal chunks)."""
    m = t.mean(dim=dim)
    cut = [d for d in dims if d.dim == dim % t.ndim]
    if cut:
        all_reduce_over(m, groups_of(cut))
        for d in cut:
            m = m / d.size
    return m


def sharded_sum(values: Sequence[Tuple[torch.Tensor, Sequence[ShardDim]]]) -> torch.Tensor:
    """The sum over the full tensors of per-shard partial sums: a partial
    of a value whose shards are cut over some groups is summed over those
    groups (one all-reduce per set of groups); whole values add as they
    are, in order."""
    whole = [v for v, dims in values if not dims]
    total = sum(whole) if whole else None
    pending: Dict[Tuple[int, ...], Tuple[List[Any], List[torch.Tensor]]] = {}
    for v, dims in values:
        if dims:
            groups = groups_of(dims)
            key = tuple(sorted(id(g) for g in groups))
            pending.setdefault(key, (groups, []))[1].append(v)
    for groups, parts in pending.values():
        part = all_reduce_over(torch.stack(parts).sum(), groups)
        total = part if total is None else total + part
    return total


def average_gradients(params: Iterable[torch.nn.Parameter], group) -> None:
    """Average the (local) gradients of `params` over `group`, one
    all-reduce per dtype."""
    if group is None or dist.get_world_size(group) == 1:
        return
    n = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            g = local(p.grad)
            by_dtype.setdefault(g.dtype, []).append(g)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def set_grad(p: torch.nn.Parameter, shard: torch.Tensor) -> None:
    """Set the gradient of `p` to `shard` (its local shard when sharded)."""
    if p.grad is not None:
        local(p.grad).copy_(shard)
    elif is_sharded(p):
        from torch.distributed.tensor import DTensor

        p.grad = DTensor.from_local(shard, p.device_mesh, p.placements, run_check=False,
                                    shape=p.shape, stride=p.stride())
    else:
        p.grad = shard


def full_state(named: Iterable[Tuple[str, torch.Tensor]], like: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """{name: full tensor on the CPU} of local shards `named`, each cut as
    the parameter `like[name]` is (a collective: every rank calls it)."""
    return {n: gather_full(t.detach(), shard_dims(like[n])).cpu() for n, t in named}
