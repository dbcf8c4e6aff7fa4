"""The device mesh and the placement rules of sharded training.

Port of pixart_sigma_tpu/parallel/mesh.py. Axes, over torch.distributed's
ranks (one card each) where JAX's are over devices:

  data   - data parallelism: the batch split, parameters replicated
  fsdp   - ZeRO-3 sharding of parameters, gradients, optimizer state and
           EMA, each on its largest fsdp-divisible axis; it carries batch
           too, so the batch is split over (data, fsdp) jointly
  tensor - Megatron tensor parallelism of the blocks' attention and MLP
           projections; the ranks of one tensor group see the same rows
           (and, with a seq axis, the same token shard)
  seq    - sequence (context) parallelism: the token dim of the model's
           activations split over the ranks of a seq group, which share
           their batch rows and their tensor shards (`SeqContext`)

The rules are pure functions of (parameter name, shape, axis sizes,
min_size, model config) and give JAX's answers: `param_placement` reads a
parameter in the JAX package's layout (a Dense kernel [in, out], a conv
HWIO, a scan group's leaves stacked [count, ...] when `scan_blocks`) and
maps the axis JAX shards back to the torch tensor. `shard_model` applies
them: `parallelize_module` for the tensor axis, FSDP2's `fully_shard` per
block and at the root for the fsdp axis (over a 2-D (data, fsdp) mesh that
is HSDP), DDP when the batch ranks are the only parallelism. Any mix of the
four axes runs, as JAX's GSPMD step takes any.

JAX carries the seq axis as the ambient mesh that the model's sharding
constraints read; the port carries it explicitly: `seq_context(mesh)` is
this rank's seq group, which the pipeline and the Trainer hand to the model
(`models.pixart.set_seq_parallel`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch
import torch.distributed as dist
from torch import nn

from pixart_sigma_tpu_torch.parallel.dist import (
    all_gather_tensor,
    gather_replicated,
    slice_replicated,
)
from pixart_sigma_tpu_torch.utils.checkpoint import jax_param_path

AXES = ("data", "fsdp", "tensor", "seq")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: every rank the other axes leave
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1  # sequence/context parallelism of the token dim

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int]:
        """The axis sizes over `n_devices` ranks (the world size)."""
        d, f, t, s = self.data, self.fsdp, self.tensor, self.seq
        if d == -1:
            assert n_devices % (f * t * s) == 0, (n_devices, f, t, s)
            d = n_devices // (f * t * s)
        assert d * f * t * s == n_devices, (
            f"mesh {d}x{f}x{t}x{s} != {n_devices} devices"
        )
        return d, f, t, s


def build_mesh(config: Optional[MeshConfig] = None, device_type: str = "cuda"):
    """A ("data", "fsdp", "tensor", "seq") DeviceMesh over the world's
    ranks, which must be initialised (`dist.initialize_distributed`)."""
    from torch.distributed.device_mesh import init_device_mesh

    config = config or MeshConfig()
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialised process group "
                           "(parallel.dist.initialize_distributed)")
    shape = config.resolve(dist.get_world_size())
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def seq_axis_size(mesh) -> int:
    """The size of the mesh's seq axis (1 without a mesh)."""
    return 1 if mesh is None else axis_size(mesh, "seq")


def batch_shard_axes(mesh) -> Tuple[str, ...]:
    """The axes the batch is split over beside seq: data and fsdp where
    above size 1."""
    return tuple(a for a in ("data", "fsdp") if mesh is not None and axis_size(mesh, a) > 1)


@dataclasses.dataclass(frozen=True)
class SeqContext:
    """This rank's place in its seq group: the token dim of the model's
    activations is cut into `size` contiguous shards of `shard_len(n)`
    tokens, and this rank holds shard `rank` (so whole latent rows when the
    grid's height divides `size`). A token count that does not divide
    `size` is padded at the end with zero tokens; the padding is dropped
    from every gather (`gather`, `gather_kv`), so it is never a key and
    never an output."""

    group: Any
    size: int
    rank: int

    def shard_len(self, n: int) -> int:
        return -(-n // self.size)

    def shard(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's shard of a whole (replicated) `x` along `dim`; the
        gradient of the rest is zero, so each rank's is a partial one."""
        n = self.shard_len(x.shape[dim])
        pad = n * self.size - x.shape[dim]
        if pad:
            shape = list(x.shape)
            shape[dim] = pad
            x = torch.cat([x, x.new_zeros(shape)], dim=dim)
        return x.narrow(dim, self.rank * n, n)

    def gather(self, x: torch.Tensor, n: int, dim: int = 1) -> torch.Tensor:
        """The whole first `n` tokens from the shards, for a result every
        rank uses alike (the output): the backward keeps the local slice."""
        return gather_replicated(x, self.group, dim).narrow(dim, 0, n)

    def gather_kv(self, x: torch.Tensor, n: int, dim: int = 1) -> torch.Tensor:
        """The whole first `n` tokens from the shards, for values each rank
        uses for its own queries (K/V): the backward reduce-scatters the
        ranks' partial gradients to the owners."""
        return all_gather_tensor(x, self.group, dim).narrow(dim, 0, n)


def seq_context(mesh) -> Optional[SeqContext]:
    """This rank's `SeqContext` on the mesh's seq axis, or None when it has
    one rank."""
    if seq_axis_size(mesh) == 1:
        return None
    return SeqContext(mesh.get_group("seq"), axis_size(mesh, "seq"), mesh.get_local_rank("seq"))


def batch_ranks(mesh) -> int:
    """How many slices the global batch is split into: data x fsdp."""
    return math.prod(axis_size(mesh, a) for a in batch_shard_axes(mesh))


def batch_rank(mesh) -> int:
    """This rank's slice of the global batch (data-major, as JAX's
    `P(("data", "fsdp"))` orders it)."""
    return mesh.get_local_rank("data") * axis_size(mesh, "fsdp") + mesh.get_local_rank("fsdp")


def batch_group(mesh):
    """The process group of the ranks that hold this rank's tensor and token
    slices of every batch slice: those with its tensor and seq coordinates,
    over which its gradients are averaged. Every rank must call it (it makes
    one group per (tensor, seq) coordinate)."""
    if batch_ranks(mesh) == dist.get_world_size():
        return dist.group.WORLD
    ranks = mesh.mesh
    mine = None
    for ti in range(ranks.shape[2]):
        for si in range(ranks.shape[3]):
            members = ranks[:, :, ti, si].flatten().tolist()
            group = dist.new_group(members)
            if dist.get_rank() in members:
                mine = group
    return mine


# Megatron-style tensor-parallel rules, keyed on trailing JAX param-path
# components, as JAX's: column-parallel kernels shard their output dim (and
# bias), row-parallel kernels their input dim (bias whole). A suffix match:
# y_embedder/y_proj/fc1 is not ("mlp", "fc1").
_TP_COL = (
    ("attn", "qkv", "kernel"),
    ("attn", "qkv", "bias"),
    ("cross_attn", "q_linear", "kernel"),
    ("cross_attn", "q_linear", "bias"),
    ("cross_attn", "kv_linear", "kernel"),
    ("cross_attn", "kv_linear", "bias"),
    ("mlp", "fc1", "kernel"),
    ("mlp", "fc1", "bias"),
)
_TP_ROW = (
    ("attn", "proj", "kernel"),
    ("cross_attn", "proj", "kernel"),
    ("mlp", "fc2", "kernel"),
)


def _tp_axis(path_names: Tuple[str, ...], ndim: int) -> Optional[int]:
    """JAX's rule: the axis of the JAX leaf sharded over 'tensor', or None."""
    for suffix in _TP_COL:
        if path_names[-len(suffix):] == suffix:
            return ndim - 1
    for suffix in _TP_ROW:
        if path_names[-len(suffix):] == suffix:
            return ndim - 2 if ndim >= 2 else None
    return None


def _stack_count(name: str, cfg) -> int:
    """The length of the scan group holding block parameter `name` in the
    JAX tree, or 0 when it is not stacked."""
    if not (cfg.scan_blocks and name.startswith("blocks.")):
        return 0
    layer, start = int(name.split(".")[1]), 0
    for _sr, count in cfg.block_groups():
        if layer < start + count:
            return count
        start += count
    raise ValueError(name)


def jax_leaf(name: str, shape: Sequence[int], cfg) -> Tuple[Tuple[int, ...], List[Optional[int]]]:
    """(shape of the JAX leaf holding port parameter `name`, and for each of
    its axes the torch dim it is, or None for an axis that is no torch dim:
    a scan stack, or the patch embedding's flattened (p, p, c))."""
    shape = tuple(shape)
    path = jax_param_path(name, cfg)
    if name.endswith("x_embedder.proj.weight"):  # conv [D, c, p, p] -> Dense [(p, p, c), D]
        jshape, to_torch = (math.prod(shape[1:]), shape[0]), [None, 0]
    elif len(shape) == 2 and path.endswith("/kernel"):  # Linear [out, in] -> [in, out]
        jshape, to_torch = (shape[1], shape[0]), [1, 0]
    elif len(shape) == 4:  # depthwise conv OIHW -> HWIO
        jshape, to_torch = (shape[2], shape[3], shape[1], shape[0]), [2, 3, 1, 0]
    else:
        jshape, to_torch = shape, list(range(len(shape)))
    count = _stack_count(name, cfg)
    if count:
        jshape, to_torch = (count,) + jshape, [None] + to_torch
    return jshape, to_torch


def leaf_spec(jshape: Sequence[int], names: Tuple[str, ...], *, fsdp_size: int = 1,
              tp_size: int = 1, fsdp: bool = False, tensor: bool = False,
              min_size: int = 2**16) -> Tuple[Optional[int], Optional[int]]:
    """JAX's `param_sharding` rule on one leaf of the JAX tree, of shape
    `jshape` at the path `names`: (the axis sharded over 'tensor', the axis
    sharded over 'fsdp'), each None when none is. The tensor rule first,
    then fsdp on the largest remaining axis divisible by the fsdp size, for
    leaves of at least `min_size` elements."""
    if not jshape:
        return None, None
    taken = taken_f = None
    if tensor:
        axis = _tp_axis(names, len(jshape))
        if axis is not None and jshape[axis] % tp_size == 0:
            taken = axis
    if fsdp and math.prod(jshape) >= min_size:
        for axis in sorted(range(len(jshape)), key=lambda i: -jshape[i]):
            if axis != taken and jshape[axis] % fsdp_size == 0:
                taken_f = axis
                break
    return taken, taken_f


def param_placement(name: str, shape: Sequence[int], cfg, *, fsdp_size: int = 1,
                    tp_size: int = 1, fsdp: bool = False, tensor: bool = False,
                    min_size: int = 2**16) -> Dict[str, Optional[int]]:
    """{"tensor": torch dim or None, "fsdp": torch dim or None} for port
    parameter `name`: `leaf_spec` on the JAX leaf that holds it (a scan
    stack's whole size counts against `min_size`), read back onto the torch
    tensor. Over one rank every axis divides, so the same parameters are
    sharded as over more and each shard is the whole tensor (JAX's spec
    over a size-1 axis is the same)."""
    jshape, to_torch = jax_leaf(name, shape, cfg)
    names = tuple(jax_param_path(name, cfg).split("/"))
    t_axis, f_axis = leaf_spec(jshape, names, fsdp_size=fsdp_size, tp_size=tp_size,
                               fsdp=fsdp, tensor=tensor, min_size=min_size)
    out: Dict[str, Optional[int]] = {"tensor": None, "fsdp": None}
    if t_axis is not None:
        out["tensor"] = to_torch[t_axis]
    if f_axis is not None:
        if to_torch[f_axis] is None:
            raise NotImplementedError(
                f"{name}: JAX shards axis {f_axis} of its leaf {tuple(jshape)}, which is no "
                "axis of the torch parameter")
        out["fsdp"] = to_torch[f_axis]
    return out


# the modules of a block that tensor parallelism splits; row layers after
# column ones, so that each knows whether its input comes sharded
_TP_MODULES = ("attn.qkv", "cross_attn.q_linear", "cross_attn.kv_linear", "mlp.fc1",
               "attn.proj", "cross_attn.proj", "mlp.fc2")


def _tensor_plan(block_name: str, block: nn.Module, cfg,
                 tp_size: int) -> Tuple[dict, List[str], List[str]]:
    """The `parallelize_module` plan of one block, whose layers hand each
    other local shards: (the plan, the column layers whose output shard the
    caller gathers whole, the row layers whose whole input the caller cuts
    to this rank's slice). The fused qkv and kv_linear shards do not fall on
    q/k/v or head boundaries (as in JAX), so the column layers of attention
    hand back their whole output, and the attention kernels see whole heads
    as plain tensors (under a seq group, of this rank's token shard, which
    the ranks of its tensor group share); the row `proj` takes its slice of
    that replicated input. The MLP keeps its hidden features sharded between
    fc1 and fc2 when both are split.

    The gathers, and the all-gathers in the backward of the slices, go
    through `parallel.dist` (`gather_replicated`, `slice_replicated`), not
    through DTensor's redistributions: those use the functional all-gather,
    which crashes the process on CUDA tensors over gloo (torch 2.11), the
    backend of ranks that share one card. DTensor's all-reduces, the plan's
    other collectives, work there."""
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    split = {}
    for mod in _TP_MODULES:
        w = block.get_submodule(mod).weight
        dim = param_placement(f"{block_name}.{mod}.weight", w.shape, cfg, tp_size=tp_size,
                              tensor=True)["tensor"]
        if dim is not None:
            split[mod] = dim
    mlp_sharded = "mlp.fc1" in split and "mlp.fc2" in split
    plan, gathered, sliced = {}, [], []
    for mod in split:
        whole = not (mlp_sharded and mod in ("mlp.fc1", "mlp.fc2"))
        if mod.endswith(("proj", "fc2")):  # row layers
            plan[mod] = RowwiseParallel()
            sliced += [mod] if whole else []
        else:
            plan[mod] = ColwiseParallel()
            gathered += [mod] if whole else []
    return plan, gathered, sliced


def shard_model(model: nn.Module, mesh, *, fsdp: bool = False, tensor: bool = False,
                min_size: int = 2**16, batch_group=None) -> Tuple[nn.Module, Set[nn.Parameter]]:
    """Apply the placement rules to `model` in place: tensor parallelism
    over mesh["tensor"] (`tensor`), then FSDP2 over mesh["fsdp"], or
    mesh["data", "fsdp"] (HSDP) when the data axis is above 1 (`fsdp`).
    Returns (the module a training step calls, the parameters whose
    gradients the caller must average over the batch ranks): those FSDP
    leaves whole (under `min_size`), or every parameter when tensor
    parallelism is on without FSDP, or when the mesh has a seq axis (the
    step sums the gradients over the seq group besides; DDP over the batch
    group would run its reductions inside the backward, among the seq
    group's collectives). Otherwise the step calls DDP over `batch_group`,
    which averages every gradient itself.

    With a seq axis the model's seq context is set first
    (`models.pixart.set_seq_parallel`); the tensor plan swaps the linears'
    weights, not the modules, so the context stays. A seq group's ranks
    share their tensor coordinate, so each gradient's seq sum acts on the
    same local shard on every rank of the group; the clip's norm and CAME's
    statistics then reduce a sharded entry over its tensor (and fsdp)
    group only (`parallel.sharded`)."""
    cfg = model.cfg
    if tensor:
        from torch.distributed.tensor.parallel import parallelize_module

        tp_mesh = mesh["tensor"]
        group = tp_mesh.get_group()
        gather = lambda mod, args, out: gather_replicated(out, group, -1)
        cut = lambda mod, args: (slice_replicated(args[0], group, -1),) + tuple(args[1:])
        for i, block in enumerate(model.blocks):
            plan, gathered, sliced = _tensor_plan(f"blocks.{i}", block, cfg, tp_mesh.size())
            if plan:
                parallelize_module(block, tp_mesh, plan)
            for mod in gathered:  # after the plan's own output hook
                block.get_submodule(mod).register_forward_hook(gather)
            for mod in sliced:  # before the plan's own input hook
                block.get_submodule(mod).register_forward_pre_hook(cut, prepend=True)
    if fsdp:
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        fsdp_mesh = mesh["data", "fsdp"] if axis_size(mesh, "data") > 1 else mesh["fsdp"]
        fsdp_size = axis_size(mesh, "fsdp")
        dims: Dict[nn.Parameter, int] = {}
        ignored: Set[nn.Parameter] = set()
        for n, p in model.named_parameters():  # the tensor-parallel ones replaced
            dim = param_placement(n, p.shape, cfg, fsdp_size=fsdp_size,
                                  tp_size=axis_size(mesh, "tensor"), fsdp=True, tensor=tensor,
                                  min_size=min_size)["fsdp"]
            if dim is None:
                ignored.add(p)
            else:
                dims[p] = dim
        placement = lambda p: Shard(dims[p])
        for block in model.blocks:
            fully_shard(block, mesh=fsdp_mesh, shard_placement_fn=placement,
                        ignored_params={p for p in block.parameters() if p in ignored})
        fully_shard(model, mesh=fsdp_mesh, shard_placement_fn=placement, ignored_params=ignored)
        return model, ignored
    if tensor or seq_axis_size(mesh) > 1:
        return model, set(model.parameters())
    from torch.nn.parallel import DistributedDataParallel

    param = next(model.parameters())
    device_ids = [param.device.index] if param.device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=device_ids, process_group=batch_group,
                                   static_graph=True), set()
