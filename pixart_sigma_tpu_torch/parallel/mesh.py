"""The device mesh and the placement rules of sharded training.

Port of pixart_sigma_tpu/parallel/mesh.py. Axes, over torch.distributed's
ranks (one card each) where JAX's are over devices:

  data   - data parallelism: the batch split, parameters replicated
  fsdp   - ZeRO-3 sharding of parameters, gradients, optimizer state and
           EMA, each on its largest fsdp-divisible axis; it carries batch
           too, so the batch is split over (data, fsdp) jointly
  tensor - Megatron tensor parallelism of the blocks' attention and MLP
           projections; the ranks of one tensor group see the same rows
  seq    - sequence parallelism, not ported (ROADMAP.md, Queue 1,
           'Parallelism')

The rules are pure functions of (parameter name, shape, axis sizes,
min_size, model config) and give JAX's answers: `param_placement` reads a
parameter in the JAX package's layout (a Dense kernel [in, out], a conv
HWIO, a scan group's leaves stacked [count, ...] when `scan_blocks`) and
maps the axis JAX shards back to the torch tensor. `shard_model` applies
them: `parallelize_module` for the tensor axis, FSDP2's `fully_shard` per
block and at the root for the fsdp axis (over a 2-D (data, fsdp) mesh that
is HSDP), DDP when the batch ranks are the only parallelism.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch
import torch.distributed as dist
from torch import nn

from pixart_sigma_tpu_torch.utils.checkpoint import jax_param_path

AXES = ("data", "fsdp", "tensor", "seq")
_SEQ = "sequence parallelism is not ported (ROADMAP.md, Queue 1, 'Parallelism')"


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
    if config.seq != 1:
        raise NotImplementedError(f"mesh seq={config.seq}: {_SEQ}")
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialised process group "
                           "(parallel.dist.initialize_distributed)")
    shape = config.resolve(dist.get_world_size())
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def batch_ranks(mesh) -> int:
    """How many slices the global batch is split into: data x fsdp."""
    return axis_size(mesh, "data") * axis_size(mesh, "fsdp")


def batch_rank(mesh) -> int:
    """This rank's slice of the global batch (data-major, as JAX's
    `P(("data", "fsdp"))` orders it)."""
    return mesh.get_local_rank("data") * axis_size(mesh, "fsdp") + mesh.get_local_rank("fsdp")


def batch_group(mesh):
    """The process group of the ranks that hold this rank's tensor slice of
    every batch slice: those with its tensor and seq coordinates. Every
    rank must call it (it makes one group per tensor coordinate)."""
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


def param_placement(name: str, shape: Sequence[int], cfg, *, fsdp_size: int = 1,
                    tp_size: int = 1, fsdp: bool = False, tensor: bool = False,
                    min_size: int = 2**16) -> Dict[str, Optional[int]]:
    """{"tensor": torch dim or None, "fsdp": torch dim or None} for port
    parameter `name`, JAX's `param_sharding` read back onto the torch
    tensor: the tensor rule first, then fsdp on the largest remaining axis
    of the JAX leaf divisible by the fsdp size, for leaves of at least
    `min_size` elements (a scan stack's whole size). Over one rank every
    axis divides, so the same parameters are sharded as over more and each
    shard is the whole tensor (JAX's spec over a size-1 axis is the same)."""
    jshape, to_torch = jax_leaf(name, shape, cfg)
    out: Dict[str, Optional[int]] = {"tensor": None, "fsdp": None}
    if not jshape:
        return out
    taken = None
    if tensor:
        names = tuple(jax_param_path(name, cfg).split("/"))
        axis = _tp_axis(names, len(jshape))
        if axis is not None and jshape[axis] % tp_size == 0:
            taken, out["tensor"] = axis, to_torch[axis]
    if fsdp and math.prod(jshape) >= min_size:
        for axis in sorted(range(len(jshape)), key=lambda i: -jshape[i]):
            if axis != taken and jshape[axis] % fsdp_size == 0:
                if to_torch[axis] is None:
                    raise NotImplementedError(
                        f"{name}: JAX shards axis {axis} of its leaf {jshape}, which is no "
                        "axis of the torch parameter")
                out["fsdp"] = to_torch[axis]
                break
    return out


# the modules of a block that tensor parallelism splits; row layers after
# column ones, so that each knows whether its input comes sharded
_TP_MODULES = ("attn.qkv", "cross_attn.q_linear", "cross_attn.kv_linear", "mlp.fc1",
               "attn.proj", "cross_attn.proj", "mlp.fc2")


def _tensor_plan(block_name: str, block: nn.Module, cfg, tp_size: int) -> dict:
    """The `parallelize_module` plan of one block. The fused qkv and
    kv_linear shards do not fall on q/k/v or head boundaries (as in JAX), so
    the column layers of attention hand back their whole output, and the
    attention kernels see whole heads as plain tensors; the row `proj`
    takes its slice of that replicated input. The MLP keeps its hidden
    features sharded between fc1 and fc2 when both are split."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    split = {}
    for mod in _TP_MODULES:
        w = block.get_submodule(mod).weight
        dim = param_placement(f"{block_name}.{mod}.weight", w.shape, cfg, tp_size=tp_size,
                              tensor=True)["tensor"]
        if dim is not None:
            split[mod] = dim
    mlp_sharded = "mlp.fc1" in split and "mlp.fc2" in split
    plan = {}
    for mod in split:
        if mod == "mlp.fc1":
            plan[mod] = ColwiseParallel(output_layouts=Shard(-1) if mlp_sharded else Replicate())
        elif mod == "mlp.fc2":
            plan[mod] = RowwiseParallel(input_layouts=Shard(-1) if mlp_sharded else Replicate())
        elif mod.endswith("proj"):
            plan[mod] = RowwiseParallel(input_layouts=Replicate())
        else:
            plan[mod] = ColwiseParallel(output_layouts=Replicate())
    return plan


def shard_model(model: nn.Module, mesh, *, fsdp: bool = False, tensor: bool = False,
                min_size: int = 2**16, batch_group=None) -> Tuple[nn.Module, Set[nn.Parameter]]:
    """Apply the placement rules to `model` in place: tensor parallelism
    over mesh["tensor"] (`tensor`), then FSDP2 over mesh["fsdp"], or
    mesh["data", "fsdp"] (HSDP) when the data axis is above 1 (`fsdp`).
    Returns (the module a training step calls, the parameters whose
    gradients the caller must average over the batch ranks): those FSDP
    leaves whole (under `min_size`), or every parameter when tensor
    parallelism is on without FSDP. With neither, the step calls DDP over
    `batch_group`, which averages every gradient itself."""
    cfg = model.cfg
    if tensor:
        from torch.distributed.tensor.parallel import parallelize_module

        tp_mesh = mesh["tensor"]
        for i, block in enumerate(model.blocks):
            plan = _tensor_plan(f"blocks.{i}", block, cfg, tp_mesh.size())
            if plan:
                parallelize_module(block, tp_mesh, plan)
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
    if tensor:
        return model, set(model.parameters())
    from torch.nn.parallel import DistributedDataParallel

    param = next(model.parameters())
    device_ids = [param.device.index] if param.device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=device_ids, process_group=batch_group,
                                   static_graph=True), set()
