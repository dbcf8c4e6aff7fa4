"""Weights carried into the port.

- `state_dict_from_jax`: the JAX package's PixArt param tree (nested dicts of
  arrays, scan-stacked `blocks_scan_<g>` or unrolled `blocks_<i>`) -> the
  port's state dict, which uses the upstream `.pth` names.
- `vae_state_dict_from_jax` / `vae_state_dict_to_jax`: the JAX
  AutoencoderKL param tree <-> diffusers AutoencoderKL names (the port's VAE
  module names).
- `t5_state_dict_from_jax`: the JAX T5Encoder param tree -> HF
  `T5EncoderModel` names (the port's T5 module names).
- `load_pth`: an upstream-dialect `.pth` straight into a port model.
- `load_checkpoint`: the entry points' loader, a `.pth` (its EMA weights
  with `load_ema`), a diffusers transformer `.safetensors` (a file or a
  directory of shards) or the JAX trainer's orbax checkpoint (a `step_N`,
  `checkpoints/` or run directory: `load_orbax_params`, re-split by
  `repartition_scan_params`).
- `diffusers_to_torch_state_dict` / `torch_to_diffusers_state_dict`: the
  diffusers `Transformer2DModel` names <-> the upstream `.pth` names (names
  only: qkv and kv_linear split and joined); `load_safetensors_state_dict`
  and `save_safetensors` read and write the files.
- `save_pth`: a training checkpoint in the upstream dialect ({"state_dict",
  "state_dict_ema", "optimizer", "step", "epoch"}, and what a resumed run
  needs besides), which `load_pth` reads; `latest_checkpoint` finds the
  newest checkpoint of a run for `resume_from="latest"`, the port's `.pth`
  or the JAX trainer's `step_N`.
- `jax_param_path`: a port parameter's path in the JAX package's param tree
  ("blocks_scan_1/attn/qkv/bias"), which `no_weight_decay_on` matches.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from pixart_sigma_tpu_torch.utils import orbax

_DROPPED = ("pos_embed", "base_model.pos_embed", "model.pos_embed")


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):  # a bfloat16 leaf of `flax_msgpack.from_bytes`
        return tree.float().numpy()
    return np.asarray(tree, dtype=np.float32)


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def _unstack_blocks(params: Dict[str, Any], cfg) -> Dict[str, Any]:
    """scan ('blocks_scan_<g>', leaves stacked on axis 0) -> 'blocks_<i>'."""
    out = {k: v for k, v in params.items() if not k.startswith("blocks_scan_")}
    layer = 0
    for g, (_sr, count) in enumerate(cfg.block_groups()):
        stacked = params[f"blocks_scan_{g}"]
        for j in range(count):
            out[f"blocks_{layer + j}"] = _index_tree(stacked, j)
        layer += count
    return out


def _index_tree(tree, j):
    if isinstance(tree, dict):
        return {k: _index_tree(v, j) for k, v in tree.items()}
    return tree[j]


def state_dict_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX PixArt params (the dict under 'params') -> the port's state dict."""
    params = _numpy_tree(params)
    if any(k.startswith("blocks_scan_") for k in params):
        params = _unstack_blocks(params, cfg)
    sd: Dict[str, np.ndarray] = {}

    def dense(name, tree):
        sd[f"{name}.weight"] = tree["kernel"].T
        sd[f"{name}.bias"] = tree["bias"]

    def layer_norm(name, tree):
        sd[f"{name}.weight"] = tree["scale"]
        sd[f"{name}.bias"] = tree["bias"]

    p, D, C = cfg.patch_size, cfg.hidden_size, cfg.in_channels
    # dense kernel [(p_row, p_col, c), D] -> conv [D, c, p_row, p_col]
    kernel = params["x_embedder"]["proj"]["kernel"].reshape(p, p, C, D)
    sd["x_embedder.proj.weight"] = kernel.transpose(3, 2, 0, 1)
    sd["x_embedder.proj.bias"] = params["x_embedder"]["proj"]["bias"]
    dense("t_embedder.mlp.0", params["t_embedder"]["fc1"])
    dense("t_embedder.mlp.2", params["t_embedder"]["fc2"])
    dense("t_block.1", params["t_block"])
    if "csize_embedder" in params:
        for name in ("csize_embedder", "ar_embedder"):
            dense(f"{name}.mlp.0", params[name]["fc1"])
            dense(f"{name}.mlp.2", params[name]["fc2"])
    sd["y_embedder.y_embedding"] = params["y_embedder"]["y_embedding"]
    dense("y_embedder.y_proj.fc1", params["y_embedder"]["y_proj"]["fc1"])
    dense("y_embedder.y_proj.fc2", params["y_embedder"]["y_proj"]["fc2"])

    for i in range(cfg.depth):
        blk = params[f"blocks_{i}"]
        b = f"blocks.{i}"
        attn = blk["attn"]
        sd[f"{b}.scale_shift_table"] = blk["scale_shift_table"]
        dense(f"{b}.attn.qkv", attn["qkv"])
        dense(f"{b}.attn.proj", attn["proj"])
        if "q_norm" in attn:
            layer_norm(f"{b}.attn.q_norm", attn["q_norm"])
            layer_norm(f"{b}.attn.k_norm", attn["k_norm"])
        if "sr_kernel" in attn:
            # depthwise HWIO [sr, sr, 1, C] -> [C, 1, sr, sr]
            sd[f"{b}.attn.sr.weight"] = attn["sr_kernel"].transpose(3, 2, 0, 1)
            sd[f"{b}.attn.sr.bias"] = attn["sr_bias"]
            layer_norm(f"{b}.attn.norm", attn["sr_norm"])
        for name in ("q_linear", "kv_linear", "proj"):
            dense(f"{b}.cross_attn.{name}", blk["cross_attn"][name])
        dense(f"{b}.mlp.fc1", blk["mlp"]["fc1"])
        dense(f"{b}.mlp.fc2", blk["mlp"]["fc2"])

    sd["final_layer.scale_shift_table"] = params["final_layer"]["scale_shift_table"]
    dense("final_layer.linear", params["final_layer"]["linear"])
    if "mask_token" in params:
        sd["mask_token"] = params["mask_token"]
    return _tensors(sd)


_TOP_MODULES = {"t_embedder.mlp.0": "t_embedder/fc1", "t_embedder.mlp.2": "t_embedder/fc2",
                "csize_embedder.mlp.0": "csize_embedder/fc1",
                "csize_embedder.mlp.2": "csize_embedder/fc2",
                "ar_embedder.mlp.0": "ar_embedder/fc1", "ar_embedder.mlp.2": "ar_embedder/fc2",
                "t_block.1": "t_block"}
_LAYER_NORMS = ("attn/q_norm", "attn/k_norm", "attn/sr_norm")


def aux_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX param tree of one auxiliary block (`FinalLayer`,
    `MaskFinalLayer`, `DecoderLayer`, `LabelEmbedder`,
    `CaptionEmbedderDoubleBr` of models/layers.py) -> the port module's
    state dict: Dense kernels transposed to Linear weights, the adaLN Dense
    into its `nn.Sequential` slot, the Embed table to `nn.Embedding`, raw
    params as they are."""
    out: Dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            name = {"adaLN_modulation": "adaLN_modulation.1"}.get(key, key)
            if not isinstance(val, dict):
                out[prefix + name] = np.asarray(val)
            elif "kernel" in val:
                out[prefix + name + ".weight"] = np.asarray(val["kernel"]).T
                out[prefix + name + ".bias"] = np.asarray(val["bias"])
            elif set(val) == {"embedding"}:
                out[prefix + name + ".weight"] = np.asarray(val["embedding"])
            else:
                walk(val, prefix + name + ".")

    walk(params.get("params", params), "")
    return _tensors(out)


def jax_param_path(name: str, cfg) -> str:
    """The path of port parameter `name` in the JAX param tree of `cfg`:
    module names joined by "/", blocks in their scan group (`blocks_scan_<g>`,
    `cfg.scan_blocks`) or `blocks_<i>`; Dense weights are "kernel", LayerNorm
    weights "scale", the KV-compression conv "sr_kernel"/"sr_bias"."""
    module, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    if module.startswith("blocks."):
        _, i, module = (module + ".").split(".", 2)
        module = module.rstrip(".")
        if cfg.scan_blocks:
            start = 0
            for g, (_sr, count) in enumerate(cfg.block_groups()):
                if start <= int(i) < start + count:
                    break
                start += count
            group = f"blocks_scan_{g}"
        else:
            group = f"blocks_{i}"
        if module == "attn.sr":
            return f"{group}/attn/sr_{'kernel' if leaf == 'weight' else leaf}"
        module = {"attn.norm": "attn.sr_norm"}.get(module, module).replace(".", "/")
        module = f"{group}/{module}" if module else group
    else:
        module = _TOP_MODULES.get(module, module.replace(".", "/"))
    if leaf == "weight":
        leaf = "scale" if module.endswith(_LAYER_NORMS) else "kernel"
    return f"{module}/{leaf}" if module else leaf


def _vae_names(vae_cfg, encoder: bool):
    """(diffusers name, JAX param path, kind) of every VAE weight; kind is
    "conv" (HWIO <-> OIHW), "linear" (transposed) or "" (as is)."""
    n_blocks = len(vae_cfg.block_out_channels)
    out = []

    def conv(name, path):
        out.extend([(f"{name}.weight", path + ("kernel",), "conv"),
                    (f"{name}.bias", path + ("bias",), "")])

    def norm(name, path):
        out.extend([(f"{name}.weight", path + ("scale",), ""),
                    (f"{name}.bias", path + ("bias",), "")])

    def linear(name, path):
        out.extend([(f"{name}.weight", path + ("kernel",), "linear"),
                    (f"{name}.bias", path + ("bias",), "")])

    def resnet(name, path, shortcut):
        norm(f"{name}.norm1", path + ("norm1",))
        conv(f"{name}.conv1", path + ("conv1",))
        norm(f"{name}.norm2", path + ("norm2",))
        conv(f"{name}.conv2", path + ("conv2",))
        if shortcut:
            conv(f"{name}.conv_shortcut", path + ("conv_shortcut",))

    def mid(name, path):
        resnet(f"{name}.mid_block.resnets.0", path + ("mid_res_0",), False)
        attn = path + ("mid_attn",)
        norm(f"{name}.mid_block.attentions.0.group_norm", attn + ("norm",))
        for proj in ("to_q", "to_k", "to_v"):
            linear(f"{name}.mid_block.attentions.0.{proj}", attn + (proj,))
        linear(f"{name}.mid_block.attentions.0.to_out.0", attn + ("to_out",))
        resnet(f"{name}.mid_block.resnets.1", path + ("mid_res_1",), False)
        norm(f"{name}.conv_norm_out", path + ("conv_norm_out",))
        conv(f"{name}.conv_in", path + ("conv_in",))
        conv(f"{name}.conv_out", path + ("conv_out",))

    ch = vae_cfg.block_out_channels
    if encoder:
        mid("encoder", ("encoder",))
        for i in range(n_blocks):
            for j in range(vae_cfg.layers_per_block):
                cin = ch[max(i - 1, 0)] if j == 0 else ch[i]
                resnet(f"encoder.down_blocks.{i}.resnets.{j}", ("encoder", f"down_{i}_res_{j}"),
                       cin != ch[i])
            if i < n_blocks - 1:
                conv(f"encoder.down_blocks.{i}.downsamplers.0.conv",
                     ("encoder", f"down_{i}_downsample"))
        conv("quant_conv", ("quant_conv",))
    mid("decoder", ("decoder",))
    rev = list(reversed(ch))
    for i in range(n_blocks):
        for j in range(vae_cfg.layers_per_block + 1):
            cin = rev[max(i - 1, 0)] if j == 0 else rev[i]
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", ("decoder", f"up_{i}_res_{j}"),
                   cin != rev[i])
        if i < n_blocks - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", ("decoder", f"up_{i}_upsample"))
    conv("post_quant_conv", ("post_quant_conv",))
    return out


def vae_state_dict_from_jax(params: Dict[str, Any], vae_cfg) -> Dict[str, torch.Tensor]:
    """JAX AutoencoderKL params -> diffusers names (the inverse of the JAX
    package's `diffusers_vae_to_flax`). The encoder is mapped when present."""
    params = _numpy_tree(params)
    sd: Dict[str, np.ndarray] = {}
    for name, path, kind in _vae_names(vae_cfg, encoder="encoder" in params):
        v = params
        for part in path:
            v = v[part]
        sd[name] = v.transpose(3, 2, 0, 1) if kind == "conv" else v.T if kind == "linear" else v
    return _tensors(sd)


def vae_state_dict_to_jax(sd: Dict[str, torch.Tensor], vae_cfg) -> Dict[str, Any]:
    """diffusers-named VAE weights (encoder and decoder) -> the JAX package's
    AutoencoderKL param tree of f32 numpy arrays (the inverse of
    `vae_state_dict_from_jax`)."""
    tree: Dict[str, Any] = {}
    for name, path, kind in _vae_names(vae_cfg, encoder=True):
        v = sd[name].detach().float().cpu().numpy()
        v = v.transpose(2, 3, 1, 0) if kind == "conv" else v.T if kind == "linear" else v
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(v)
    return tree


def load_pth(model: nn.Module, path: str, load_ema: bool = False) -> nn.Module:
    """Load an upstream-dialect PixArt `.pth` ({'state_dict': ...}, with
    `load_ema` its 'state_dict_ema' when present, or a bare state dict) into
    a port model; resolution-dependent `pos_embed` buffers are dropped,
    every other key must match."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    key = "state_dict_ema" if load_ema and "state_dict_ema" in ckpt else "state_dict"
    sd = ckpt.get(key, ckpt)
    sd = {k: v for k, v in sd.items() if k not in _DROPPED}
    model.load_state_dict(sd, strict=True)
    return model


# diffusers Transformer2DModel name -> upstream .pth name, outside the blocks
_DIFFUSERS_RENAMES = {
    "pos_embed.proj.weight": "x_embedder.proj.weight",
    "pos_embed.proj.bias": "x_embedder.proj.bias",
    "caption_projection.linear_1.weight": "y_embedder.y_proj.fc1.weight",
    "caption_projection.linear_1.bias": "y_embedder.y_proj.fc1.bias",
    "caption_projection.linear_2.weight": "y_embedder.y_proj.fc2.weight",
    "caption_projection.linear_2.bias": "y_embedder.y_proj.fc2.bias",
    "adaln_single.emb.timestep_embedder.linear_1.weight": "t_embedder.mlp.0.weight",
    "adaln_single.emb.timestep_embedder.linear_1.bias": "t_embedder.mlp.0.bias",
    "adaln_single.emb.timestep_embedder.linear_2.weight": "t_embedder.mlp.2.weight",
    "adaln_single.emb.timestep_embedder.linear_2.bias": "t_embedder.mlp.2.bias",
    "adaln_single.emb.resolution_embedder.linear_1.weight": "csize_embedder.mlp.0.weight",
    "adaln_single.emb.resolution_embedder.linear_1.bias": "csize_embedder.mlp.0.bias",
    "adaln_single.emb.resolution_embedder.linear_2.weight": "csize_embedder.mlp.2.weight",
    "adaln_single.emb.resolution_embedder.linear_2.bias": "csize_embedder.mlp.2.bias",
    "adaln_single.emb.aspect_ratio_embedder.linear_1.weight": "ar_embedder.mlp.0.weight",
    "adaln_single.emb.aspect_ratio_embedder.linear_1.bias": "ar_embedder.mlp.0.bias",
    "adaln_single.emb.aspect_ratio_embedder.linear_2.weight": "ar_embedder.mlp.2.weight",
    "adaln_single.emb.aspect_ratio_embedder.linear_2.bias": "ar_embedder.mlp.2.bias",
    "adaln_single.linear.weight": "t_block.1.weight",
    "adaln_single.linear.bias": "t_block.1.bias",
    "proj_out.weight": "final_layer.linear.weight",
    "proj_out.bias": "final_layer.linear.bias",
    "scale_shift_table": "final_layer.scale_shift_table",
    "caption_projection.y_embedding": "y_embedder.y_embedding",
}

# per block: (upstream suffix, diffusers suffixes joined along dim 0)
_DIFFUSERS_BLOCK = (
    ("scale_shift_table", ("scale_shift_table",)),
    ("attn.qkv.weight", ("attn1.to_q.weight", "attn1.to_k.weight", "attn1.to_v.weight")),
    ("attn.qkv.bias", ("attn1.to_q.bias", "attn1.to_k.bias", "attn1.to_v.bias")),
    ("attn.proj.weight", ("attn1.to_out.0.weight",)),
    ("attn.proj.bias", ("attn1.to_out.0.bias",)),
    ("attn.q_norm.weight", ("attn1.q_norm.weight",)),
    ("attn.q_norm.bias", ("attn1.q_norm.bias",)),
    ("attn.k_norm.weight", ("attn1.k_norm.weight",)),
    ("attn.k_norm.bias", ("attn1.k_norm.bias",)),
    ("cross_attn.q_linear.weight", ("attn2.to_q.weight",)),
    ("cross_attn.q_linear.bias", ("attn2.to_q.bias",)),
    ("cross_attn.kv_linear.weight", ("attn2.to_k.weight", "attn2.to_v.weight")),
    ("cross_attn.kv_linear.bias", ("attn2.to_k.bias", "attn2.to_v.bias")),
    ("cross_attn.proj.weight", ("attn2.to_out.0.weight",)),
    ("cross_attn.proj.bias", ("attn2.to_out.0.bias",)),
    ("mlp.fc1.weight", ("ff.net.0.proj.weight",)),
    ("mlp.fc1.bias", ("ff.net.0.proj.bias",)),
    ("mlp.fc2.weight", ("ff.net.2.weight",)),
    ("mlp.fc2.bias", ("ff.net.2.bias",)),
)
_OPTIONAL = ("q_norm", "k_norm")  # qk_norm models only


def diffusers_to_torch_state_dict(dsd: Dict[str, torch.Tensor],
                                  depth: int = 28) -> Dict[str, torch.Tensor]:
    """diffusers `Transformer2DModel` names -> upstream `.pth` names: the
    attention projections joined into qkv and kv_linear. The names a
    diffusers PixArt has: no KV-compression conv, no `pos_embed` buffer."""
    sd = {dst: dsd[src] for src, dst in _DIFFUSERS_RENAMES.items() if src in dsd}
    for i in range(depth):
        t, b = f"transformer_blocks.{i}", f"blocks.{i}"
        for ours, theirs in _DIFFUSERS_BLOCK:
            if any(n in ours for n in _OPTIONAL) and f"{t}.{theirs[0]}" not in dsd:
                continue
            parts = [dsd[f"{t}.{n}"] for n in theirs]
            sd[f"{b}.{ours}"] = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    return sd


def torch_to_diffusers_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Upstream `.pth` names -> diffusers `Transformer2DModel` names (qkv
    split into to_q/to_k/to_v, kv_linear into to_k/to_v); `pos_embed` and
    the KV-compression conv, which diffusers does not name, are dropped."""
    dsd = {src: sd[dst] for src, dst in _DIFFUSERS_RENAMES.items() if dst in sd}
    depth = max(int(k.split(".")[1]) for k in sd if k.startswith("blocks.")) + 1
    for i in range(depth):
        t, b = f"transformer_blocks.{i}", f"blocks.{i}"
        for ours, theirs in _DIFFUSERS_BLOCK:
            if f"{b}.{ours}" not in sd and any(n in ours for n in _OPTIONAL):
                continue
            parts = sd[f"{b}.{ours}"].chunk(len(theirs), dim=0)
            for n, part in zip(theirs, parts):
                dsd[f"{t}.{n}"] = part.contiguous()
    return dsd


def _safetensors_files(path: str) -> list:
    if not os.path.isdir(path):
        return [path]
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {path}")
    return [os.path.join(path, f) for f in files]


def load_safetensors_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file, or every one in a directory (a diffusers
    transformer's shards), as f32 CPU tensors."""
    from safetensors.torch import load_file

    sd: Dict[str, torch.Tensor] = {}
    for f in _safetensors_files(path):
        sd.update({k: v.float() for k, v in load_file(f).items()})
    return sd


def save_safetensors(path: str, sd: Dict[str, torch.Tensor]) -> str:
    """Write `sd` (CPU copies, made contiguous) as one `.safetensors` file."""
    from safetensors.torch import save_file

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_file({k: v.detach().cpu().contiguous() for k, v in sd.items()}, path)
    return path


def load_orbax_params(path: str, load_ema: bool = False) -> Dict[str, Any]:
    """The params of the JAX trainer's orbax checkpoint at `path` (a `step_N`
    directory, or the newest `step_N` of a `checkpoints/` or run directory),
    or its `ema_params` when `load_ema` and the checkpoint has them: the JAX
    param tree as nested dicts of numpy arrays (bfloat16 leaves as
    torch.bfloat16 tensors), as the JAX package's `load_orbax_params`
    restores it. Only that subtree's arrays are read."""
    step_dir = orbax.resolve_step_dir(path)
    key = "params"
    if load_ema and orbax.leaves(step_dir, "ema_params"):
        key = "ema_params"
    return orbax.read_tree(step_dir, key)


def _concat(xs):
    if isinstance(xs[0], dict):
        if any(set(x) != set(xs[0]) for x in xs):
            raise ValueError(f"scan stacks of different structures cannot be joined: "
                             f"{sorted(set().union(*xs) - set(xs[0]))} not in every stack")
        return {k: _concat([x[k] for x in xs]) for k in xs[0]}
    if isinstance(xs[0], torch.Tensor):
        return torch.cat(xs, 0)
    return np.concatenate(xs, 0)


def _slice_tree(tree, sl: slice):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, sl) for k, v in tree.items()}
    return tree[sl]


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def repartition_scan_params(params: Dict[str, Any], cfg) -> Dict[str, Any]:
    """Re-split the `blocks_scan_<g>` stacks of a JAX param tree (or of any
    tree of the same structure, such as an optimizer moment) to `cfg`'s
    `block_groups()`, as the JAX package's `repartition_scan_params`: the
    saved stacks are joined layer-wise and cut at the model's group
    boundaries (a `cache_span` model splits a group at the span's edges). A
    tree that already matches, or holds no stacks, is returned as it is."""
    saved = sorted((k for k in params if k.startswith("blocks_scan_")),
                   key=lambda k: int(k.rsplit("_", 1)[1]))
    if not saved:
        return params
    target = cfg.block_groups()
    counts = [_first_leaf(params[k]).shape[0] for k in saved]
    if counts == [c for _, c in target]:
        return params
    if sum(counts) != sum(c for _, c in target):
        raise ValueError(f"checkpoint has {sum(counts)} stacked blocks but the model wants "
                         f"{sum(c for _, c in target)} ({target})")
    full = _concat([params[k] for k in saved])
    out = {k: v for k, v in params.items() if k not in saved}
    start = 0
    for g, (_, count) in enumerate(target):
        out[f"blocks_scan_{g}"] = _slice_tree(full, slice(start, start + count))
        start += count
    return out


def load_checkpoint(path: str, model: nn.Module, load_ema: bool = False,
                    null_embedding: Optional[torch.Tensor] = None) -> nn.Module:
    """Load a PixArt checkpoint into a port model, as the JAX package's
    `load_checkpoint` does: a `.pth`/`.pt` through `load_pth`; the JAX
    trainer's orbax checkpoint (a `step_N`, `checkpoints/` or run directory,
    `load_orbax_params`) with its scan stacks re-split to the model's
    groups; anything else as a diffusers transformer (`.safetensors` file or
    directory). A diffusers file has no `y_embedder.y_embedding` of its own
    unless it was written from a PixArt `.pth`: then `null_embedding` gives
    it, and without either it raises, as JAX does. `null_embedding` replaces
    the others'. Every key of the model must be filled."""
    if os.path.isdir(path) and orbax.is_orbax_dir(path):
        params = repartition_scan_params(load_orbax_params(path, load_ema), model.cfg)
        sd = state_dict_from_jax(params, model.cfg)
        if null_embedding is not None:
            sd["y_embedder.y_embedding"] = torch.as_tensor(null_embedding, dtype=torch.float32)
        model.load_state_dict(sd, strict=True)
        return model
    if os.path.isdir(path) and not any(f.endswith(".safetensors") for f in os.listdir(path)):
        raise FileNotFoundError(
            f"{path} is neither an orbax checkpoint (no {orbax.COMMIT_MARKER}, and no step_N "
            "in it or in its checkpoints/) nor a diffusers directory (no .safetensors)")
    if path.endswith((".pth", ".pt")):
        load_pth(model, path, load_ema=load_ema)
        if null_embedding is not None:
            with torch.no_grad():
                model.y_embedder.y_embedding.copy_(torch.as_tensor(null_embedding))
        return model
    sd = diffusers_to_torch_state_dict(load_safetensors_state_dict(path), depth=model.cfg.depth)
    if null_embedding is not None:
        sd["y_embedder.y_embedding"] = torch.as_tensor(null_embedding, dtype=torch.float32)
    missing_sr = [k for k in model.state_dict() if ".attn.sr." in k and k not in sd]
    if missing_sr:
        raise NotImplementedError(
            f"{path}: diffusers names carry no KV-compression conv ({missing_sr[0]}), as in the "
            "JAX package's map; load this model from a .pth or an orbax checkpoint (ROADMAP.md, "
            "Queue 3, 'What the port does not read')")
    if "y_embedder.y_embedding" not in sd:
        raise ValueError(f"{path} has no y_embedder.y_embedding (caption_projection."
                         "y_embedding); pass null_embedding=")
    model.load_state_dict(sd, strict=True)
    return model


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint of the largest step under `ckpt_dir`, or None: the
    port's `epoch_<e>_step_<s>.pth` (what `Trainer.save` writes) or the JAX
    trainer's orbax `step_<s>` directory. At a tie the `.pth` wins: it
    carries the generator, the resampler's ring and the accumulator, which
    an orbax checkpoint of the same step does not."""
    if not os.path.isdir(ckpt_dir):
        return None
    found = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"epoch_(\d+)_step_(\d+)\.pth", name)
        if m:
            found.append((int(m.group(2)), 1, int(m.group(1)), name))
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.isdir(os.path.join(ckpt_dir, name)):
            found.append((int(m.group(1)), 0, 0, name))
    if not found:
        return None
    return os.path.join(os.path.abspath(ckpt_dir), max(found)[3])


def save_pth(path: str, state_dict: Dict[str, torch.Tensor],
             state_dict_ema: Optional[Dict[str, torch.Tensor]] = None,
             optimizer: Optional[dict] = None, **extra) -> str:
    """Write a training checkpoint under the upstream `.pth` keys; tensors
    are moved to the CPU first. Returns `path`."""
    cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}
    ckpt: Dict[str, Any] = {"state_dict": cpu(state_dict)}
    if state_dict_ema is not None:
        ckpt["state_dict_ema"] = cpu(state_dict_ema)
    if optimizer is not None:
        ckpt["optimizer"] = optimizer
    ckpt.update(extra)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(ckpt, path)
    return path


def t5_state_dict_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX T5Encoder params -> HF `T5EncoderModel` names (the port's T5
    module names): the inverse of the JAX package's `hf_t5_to_flax`."""
    params = _numpy_tree(params)
    sd: Dict[str, np.ndarray] = {"shared.weight": params["token_embedding"],
                                 "encoder.final_layer_norm.weight": params["final_ln"]["weight"]}
    for i in range(cfg.num_layers):
        blk, b = params[f"block_{i}"], f"encoder.block.{i}"
        sd[f"{b}.layer.0.layer_norm.weight"] = blk["ln_attn"]["weight"]
        for proj in ("q", "k", "v", "o"):
            sd[f"{b}.layer.0.SelfAttention.{proj}.weight"] = blk["attn"][proj]["kernel"].T
        if i == 0:
            sd[f"{b}.layer.0.SelfAttention.relative_attention_bias.weight"] = (
                blk["attn"]["relative_attention_bias"])
        sd[f"{b}.layer.1.layer_norm.weight"] = blk["ln_ff"]["weight"]
        for proj in ("wi_0", "wi_1", "wo"):
            sd[f"{b}.layer.1.DenseReluDense.{proj}.weight"] = blk[proj]["kernel"].T
    return _tensors(sd)
