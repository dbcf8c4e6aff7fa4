"""Process coordination over torch.distributed: start-up, rank helpers,
barrier, object broadcast and gather, and the differentiable collectives of
sharded training and of sequence parallelism: the all-gather whose backward
reduce-scatters (`all_gather_tensor`), the all-gather of a replicated
result whose backward keeps the local slice (`gather_replicated`), its
transpose (`slice_replicated`), and the ring shift (`ring_shift`).

Port of pixart_sigma_tpu/parallel/dist.py. JAX starts from
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID; the port
reads what `torchrun` sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK). A port rank drives one card, where a JAX process drives all
the chips of its host. Without a process group every helper answers for one
process.
"""

from __future__ import annotations

import os
import datetime
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None,
                           device: Union[str, torch.device] = "cuda",
                           backend: Optional[str] = None,
                           timeout: Optional[float] = None) -> bool:
    """Join the process group; returns whether one is initialised.

    Arguments that are None come from torchrun's environment (init_method
    "env://" when MASTER_ADDR is set). One process with neither arguments
    nor environment is a no-op, as JAX's. The backend is NCCL on the card
    and gloo when `device` is the CPU, unless `backend` names one (gloo on
    the card lets several ranks share one GPU, which NCCL refuses); on the
    card the current device becomes LOCAL_RANK (0 without it). `timeout`
    (seconds) bounds every collective's wait."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            return False  # one process
        init_method = "env://"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:  # NOT `or`: rank 0 is falsy
        rank = int(os.environ["RANK"])
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            **kw)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """The rank-0 guard (upstream: accelerator.is_main_process)."""
    return process_index() == 0


def broadcast_object(obj: Any) -> Any:
    """`obj` of rank 0 on every rank."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def sync_global_devices(tag: str = "barrier") -> None:
    """A barrier across the ranks (`tag` names it in JAX; unused here)."""
    if process_count() > 1:
        dist.barrier()


def reduce_dict(d: Dict[str, torch.Tensor], group=None, average: bool = True
                ) -> Dict[str, torch.Tensor]:
    """The mean (or sum) of each tensor of `d` over `group`'s ranks, stacked
    into one all-reduce; the values keep their dtypes."""
    if not d or not dist.is_initialized() or dist.get_world_size(group) == 1:
        return dict(d)
    keys = list(d)
    flat = torch.stack([d[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=group)
    if average:
        flat = flat / dist.get_world_size(group)
    return {k: flat[i].to(d[k].dtype) for i, k in enumerate(keys)}


def gather_cpu(obj: Any) -> list:
    """Every rank's `obj`, as a list in rank order, on every rank."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


# The transports the collectives below took, "<op> <transport>" -> calls.
TRANSPORTS: Dict[str, int] = {}


def _staged(x: torch.Tensor, group) -> bool:
    """Gloo moves CPU tensors only for all-gather, reduce-scatter and
    send/recv (it reduces and broadcasts CUDA tensors itself): a CUDA
    tensor on a gloo group goes through host memory for those, and only
    those. NCCL takes it as it is."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _note(op: str, staged: bool) -> None:
    key = f"{op} {'gloo, staged through host memory' if staged else 'native'}"
    TRANSPORTS[key] = TRANSPORTS.get(key, 0) + 1


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    staged = _staged(x, group)
    _note("all_gather", staged)
    src = x.detach().contiguous()
    if staged:
        src = src.cpu()
    out = src.new_empty((dist.get_world_size(group),) + src.shape)
    dist.all_gather(list(out), src, group=group)
    return torch.cat(list(out), dim=dim).to(x.device)


def _reduce_scatter(full: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the ranks of `full`, chunk `rank` of it along `dim`."""
    staged = _staged(full, group)
    _note("reduce_scatter", staged)
    n = dist.get_world_size(group)
    src = full.movedim(dim, 0).contiguous()
    if staged:
        src = src.cpu()
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(full.device).movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.group, ctx.dim), None, None


def all_gather_tensor(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim` in rank order (each rank's
    `x` of the same shape). Differentiable: the gradient of a rank's `x` is
    the sum over the ranks of the gradient of its slice, a reduce-scatter,
    as `lax.all_gather`'s transpose is `psum_scatter`. It is the gather of
    values that each rank then uses for its own part of the work (the K/V of
    its query shard): each rank's gradient is a partial one."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def gather_replicated(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """`all_gather_tensor` for a result that every rank then uses whole and
    alike (the model's output, from which each rank computes the same
    loss): every rank's gradient of the gathered tensor is the same whole
    one, so the gradient of a rank's `x` is its own slice of it. A
    reduce-scatter would sum the ranks' identical copies and make it
    world-size times too large."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x
    return _GatherReplicated.apply(x, group, dim)


class _SliceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // dist.get_world_size(group)
        return x.narrow(dim, dist.get_rank(group) * n, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.group, ctx.dim), None, None


def slice_replicated(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """This rank's chunk along `dim` of `x`, a value every rank holds alike
    (the whole input of a row-parallel layer), the transpose of
    `gather_replicated`: the gradient of `x` is the ranks' gradients of
    their chunks gathered, each rank's whole for its own chunk (DTensor's
    Replicate -> Shard redistribution and its backward)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x
    return _SliceReplicated.apply(x, group, dim)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Rank r's `x` on rank r + step (mod the group's size)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    staged = _staged(x, group)
    _note("send/recv", staged)
    src = x.detach().contiguous()
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    peer = lambda i: dist.get_global_rank(group, i % n)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, src, peer(r + step), group),
                                        dist.P2POp(dist.irecv, out, peer(r - step), group)]):
        work.wait()
    return out.to(x.device)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """Each rank's `x` passed to its right neighbour (rank r + 1, the last
    to rank 0), as `lax.ppermute` over the ring; its backward passes the
    gradients to the left."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x
    return _RingShift.apply(x, group or dist.group.WORLD)


def mean_abs_ratio(a: torch.Tensor, b: torch.Tensor, group=None, eps: float = 1e-8
                   ) -> torch.Tensor:
    """mean|a| / (mean|b| + eps) over the `group` ranks' `a` and `b`
    together (the global batch when each rank holds its rows; ranks holding
    the same rows count them alike on both sides), the same f32 scalar on
    every rank; this rank's alone when `group` is None."""
    if group is None or dist.get_world_size(group) == 1:
        return a.abs().mean() / (b.abs().mean() + eps)
    sums = torch.stack([a.abs().sum(), b.abs().sum(),
                        torch.tensor(float(a.numel()), device=a.device)]).float()
    dist.all_reduce(sums, group=group)
    return (sums[0] / sums[2]) / (sums[1] / sums[2] + eps)
