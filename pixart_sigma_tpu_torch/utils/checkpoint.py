"""Weights carried into the port.

- `state_dict_from_jax`: the JAX package's PixArt param tree (nested dicts of
  arrays, scan-stacked `blocks_scan_<g>` or unrolled `blocks_<i>`) -> the
  port's state dict, which uses the upstream `.pth` names.
- `vae_state_dict_from_jax`: the JAX AutoencoderKL param tree -> diffusers
  AutoencoderKL names (the port's VAE module names).
- `load_pth`: an upstream-dialect `.pth` straight into a port model.
- `save_pth`: a training checkpoint in the upstream dialect ({"state_dict",
  "state_dict_ema", "optimizer", "step", "epoch"}), which `load_pth` reads.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

_DROPPED = ("pos_embed", "base_model.pos_embed", "model.pos_embed")


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
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
    return _tensors(sd)


def vae_state_dict_from_jax(params: Dict[str, Any], vae_cfg) -> Dict[str, torch.Tensor]:
    """JAX AutoencoderKL params -> diffusers names (the inverse of the JAX
    package's `diffusers_vae_to_flax`). The encoder is mapped when present."""
    params = _numpy_tree(params)
    n_blocks = len(vae_cfg.block_out_channels)
    sd: Dict[str, np.ndarray] = {}

    def conv(name, tree):  # HWIO -> OIHW
        sd[f"{name}.weight"] = tree["kernel"].transpose(3, 2, 0, 1)
        sd[f"{name}.bias"] = tree["bias"]

    def norm(name, tree):
        sd[f"{name}.weight"] = tree["scale"]
        sd[f"{name}.bias"] = tree["bias"]

    def linear(name, tree):
        sd[f"{name}.weight"] = tree["kernel"].T
        sd[f"{name}.bias"] = tree["bias"]

    def resnet(name, tree):
        norm(f"{name}.norm1", tree["norm1"])
        conv(f"{name}.conv1", tree["conv1"])
        norm(f"{name}.norm2", tree["norm2"])
        conv(f"{name}.conv2", tree["conv2"])
        if "conv_shortcut" in tree:
            conv(f"{name}.conv_shortcut", tree["conv_shortcut"])

    def attn(name, tree):
        norm(f"{name}.group_norm", tree["norm"])
        for proj in ("to_q", "to_k", "to_v"):
            linear(f"{name}.{proj}", tree[proj])
        linear(f"{name}.to_out.0", tree["to_out"])

    def mid(name, tree):
        resnet(f"{name}.mid_block.resnets.0", tree["mid_res_0"])
        attn(f"{name}.mid_block.attentions.0", tree["mid_attn"])
        resnet(f"{name}.mid_block.resnets.1", tree["mid_res_1"])
        norm(f"{name}.conv_norm_out", tree["conv_norm_out"])
        conv(f"{name}.conv_in", tree["conv_in"])
        conv(f"{name}.conv_out", tree["conv_out"])

    if "encoder" in params:
        enc = params["encoder"]
        mid("encoder", enc)
        for i in range(n_blocks):
            for j in range(vae_cfg.layers_per_block):
                resnet(f"encoder.down_blocks.{i}.resnets.{j}", enc[f"down_{i}_res_{j}"])
            if i < n_blocks - 1:
                conv(f"encoder.down_blocks.{i}.downsamplers.0.conv",
                     enc[f"down_{i}_downsample"])
        conv("quant_conv", params["quant_conv"])
    dec = params["decoder"]
    mid("decoder", dec)
    for i in range(n_blocks):
        for j in range(vae_cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", dec[f"up_{i}_res_{j}"])
        if i < n_blocks - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", dec[f"up_{i}_upsample"])
    conv("post_quant_conv", params["post_quant_conv"])
    return _tensors(sd)


def load_pth(model: nn.Module, path: str) -> nn.Module:
    """Load an upstream-dialect PixArt `.pth` ({'state_dict': ...} or a bare
    state dict) into a port model; resolution-dependent `pos_embed` buffers
    are dropped, every other key must match."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in sd.items() if k not in _DROPPED}
    model.load_state_dict(sd, strict=True)
    return model


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
