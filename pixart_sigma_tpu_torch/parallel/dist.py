"""Process coordination over torch.distributed: start-up, rank helpers,
barrier, object broadcast and gather, and a differentiable all-gather.

Port of pixart_sigma_tpu/parallel/dist.py. JAX starts from
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID; the port
reads what `torchrun` sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK). A port rank drives one card, where a JAX process drives all
the chips of its host. Without a process group every helper answers for one
process.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None,
                           device: Union[str, torch.device] = "cuda") -> bool:
    """Join the process group; returns whether one is initialised.

    Arguments that are None come from torchrun's environment (init_method
    "env://" when MASTER_ADDR is set). One process with neither arguments
    nor environment is a no-op, as JAX's. The backend is NCCL on the card
    and gloo when `device` is the CPU; on the card the current device
    becomes LOCAL_RANK (0 without it)."""
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
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
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


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        full = grad.movedim(ctx.dim, 0).contiguous()
        out = full.new_empty((full.shape[0] // n,) + full.shape[1:])
        dist.reduce_scatter_tensor(out, full, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def all_gather_tensor(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim` in rank order (each rank's
    `x` of the same shape). Differentiable: the gradient of a rank's `x` is
    the sum over the ranks of the gradient of its slice, a reduce-scatter,
    as `lax.all_gather`'s transpose is `psum_scatter`."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim)
