"""LoRA / DoRA / rsLoRA as functional weight surgery.

Port of pixart_sigma_tpu/training/lora.py. An adapter is a dict of leaf
tensors {"a": [in, r], "b": [r, out], "m"?: [out]} kept in the JAX kernel
layout ([in, out], the patch embedding's kernel in (p, q, c) order), one
per adapted module of the unrolled blocks (JAX stacks a scan group's
adapters [L, in, r]; `lora_state_dict_from_jax` unstacks them). A module is
adapted when the last name of its JAX path (`jax_param_path`) is in
`targets`, so besides the blocks' projections and MLPs the defaults also
adapt the patch embedding, the timestep, caption and size embedders'
MLPs, `t_block` and the final linear, as JAX does; the KV-compression conv
is not adapted. `apply_lora` gives the merged weights W + scale·(A·B) (DoRA:
renormalised per output column and scaled by m), which `swapped_weights`
puts in the model for a forward and its backward (a recomputed block reads
them too); only the adapters take gradients.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from pixart_sigma_tpu_torch.utils.checkpoint import jax_param_path

DEFAULT_TARGETS = (
    "qkv", "proj", "q_linear", "kv_linear", "fc1", "fc2", "t_block", "linear",
)
_PATCH = "x_embedder.proj"  # a Conv2d [D, c, p, p] in the port, a Dense in JAX

Lora = Dict[str, Dict[str, torch.Tensor]]


def lora_modules(params: Dict[str, torch.Tensor], cfg,
                 targets: Sequence[str] = DEFAULT_TARGETS) -> list:
    """The port module names whose weight JAX's `init_lora_params` adapts:
    a Dense kernel whose module's last name is in `targets`."""
    out = []
    for name in params:
        if not name.endswith(".weight"):
            continue
        module, leaf = jax_param_path(name, cfg).rsplit("/", 1)
        if leaf == "kernel" and module.split("/")[-1] in targets:
            out.append(name[: -len(".weight")])
    return out


def to_kernel(module: str, weight: torch.Tensor) -> torch.Tensor:
    """A port weight as its JAX kernel [in, out]."""
    if module == _PATCH:
        D = weight.shape[0]
        return weight.permute(2, 3, 1, 0).reshape(-1, D)
    return weight.t()


def from_kernel(module: str, kernel: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of `to_kernel`, shaped as `like`."""
    if module == _PATCH:
        D, C, p, _ = like.shape
        return kernel.reshape(p, p, C, D).permute(3, 2, 0, 1)
    return kernel.t()


def init_lora_params(params: Dict[str, torch.Tensor], cfg, rank: int,
                     generator: Optional[torch.Generator] = None,
                     targets: Sequence[str] = DEFAULT_TARGETS,
                     use_dora: bool = False) -> Lora:
    """{module: {"a": N(0, 1) / rank [in, r], "b": zeros [r, out], "m"?}}
    in f32 on the weights' device, leaves that take gradients; DoRA's m is
    the column norm of the base kernel. Draws come from `generator` in the
    modules' order (JAX splits its key per kernel: other numbers)."""
    lora: Lora = {}
    for module in lora_modules(params, cfg, targets):
        kernel = to_kernel(module, params[f"{module}.weight"].detach().float())
        d_in, d_out = kernel.shape
        gen_dev = generator.device if generator is not None else kernel.device
        a = torch.randn((d_in, rank), generator=generator, device=gen_dev) * (1.0 / rank)
        entry = {"a": a.to(kernel.device),
                 "b": torch.zeros((rank, d_out), device=kernel.device)}
        if use_dora:
            entry["m"] = torch.linalg.vector_norm(kernel, dim=0)
        lora[module] = {k: v.requires_grad_(True) for k, v in entry.items()}
    return lora


def lora_parameters(lora: Lora) -> Iterator[torch.Tensor]:
    for entry in lora.values():
        yield from entry.values()


def count_lora_params(lora: Lora) -> int:
    return sum(int(x.numel()) for x in lora_parameters(lora))


def apply_lora(params: Dict[str, torch.Tensor], lora: Lora, scale: float = 1.0,
               rank: Optional[int] = None, use_rslora: bool = False,
               alpha: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """`params` with each adapted weight merged: kernel + scale·(a·b), and for
    DoRA that times m / ‖merged‖ per output column (the norm floored at
    1e-6), laid out as the weight is; with `alpha` the scale is times
    alpha / r (rsLoRA: alpha / sqrt(r)). Differentiable in the adapters.
    With b = 0 a weight comes back bit for bit (DoRA multiplies by
    m / ‖W‖ = 1 exactly)."""
    if alpha is not None:
        r = rank or next(iter(lora.values()))["a"].shape[-1]
        scale = scale * (alpha / (r**0.5) if use_rslora else alpha / r)
    out = dict(params)
    for module, entry in lora.items():
        weight = params[f"{module}.weight"]
        kernel = to_kernel(module, weight)
        merged = kernel + scale * (entry["a"] @ entry["b"]).to(kernel.dtype)
        if "m" in entry:
            norm = torch.linalg.vector_norm(merged, dim=0, keepdim=True)
            merged = merged * (entry["m"][None, :] / torch.clamp(norm, min=1e-6))
        out[f"{module}.weight"] = from_kernel(module, merged, weight).contiguous()
    return out


@torch.no_grad()
def merge_lora(params: Dict[str, torch.Tensor], lora: Lora, **kwargs) -> Dict[str, torch.Tensor]:
    """Bake the adapters into the base weights (for export)."""
    return {k: v.detach().clone() for k, v in apply_lora(params, lora, **kwargs).items()}


@contextlib.contextmanager
def swapped_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]):
    """Within the block, the model's parameters named in `weights` are those
    tensors (its parameters are back, in their order, on exit). Unlike
    `torch.func.functional_call` this spans the backward, where remat
    recomputes a block from the module's attributes."""
    swapped = []
    try:
        for name, value in weights.items():
            mod_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
            mod = model.get_submodule(mod_name)
            swapped.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = value
        yield model
    finally:
        for mod, leaf, param in swapped:
            mod._parameters[leaf] = param


def adapted_weights(merged: Dict[str, torch.Tensor], lora: Lora) -> Dict[str, torch.Tensor]:
    """The merged weights of the adapted modules only."""
    return {f"{m}.weight": merged[f"{m}.weight"] for m in lora}


def _scan_index(module: str, cfg) -> Optional[int]:
    """A block's index within its scan group (None outside the blocks)."""
    if not module.startswith("blocks."):
        return None
    layer, start = int(module.split(".")[1]), 0
    for _sr, count in cfg.block_groups():
        if layer < start + count:
            return layer - start
        start += count
    raise ValueError(module)


def lora_state_dict_from_jax(jax_lora: Dict[str, Any], params: Dict[str, torch.Tensor], cfg,
                             targets: Sequence[str] = DEFAULT_TARGETS) -> Lora:
    """JAX's adapter tree ({"blocks_scan_0/attn/qkv": {"a": [L, in, r], ...}}
    or unrolled "blocks_3/...") -> the port's, one adapter per module of
    `params`, as f32 leaves that take gradients."""
    lora: Lora = {}
    for module in lora_modules(params, cfg, targets):
        key = jax_param_path(f"{module}.weight", cfg).rsplit("/", 1)[0]
        j = _scan_index(module, cfg) if cfg.scan_blocks else None
        entry = {}
        for leaf, value in jax_lora[key].items():
            value = np.asarray(value, np.float32)
            entry[leaf] = torch.from_numpy(np.array(value if j is None else value[j])) \
                .requires_grad_(True)
        lora[module] = entry
    return lora


def make_lora_train_step(model, diffusion, base_params: Dict[str, torch.Tensor],
                         optimizer: torch.optim.Optimizer, scale: float = 1.0,
                         snr_gamma: Optional[float] = None) -> Callable:
    """step(lora, batch, *, generator=None, t=None, noise=None,
    force_drop_ids=None) -> loss, one AdamW (or any) update of the adapters
    only, which `optimizer` holds. t (uniform in [0, T)), the noise and
    then, inside the model, the caption drops come from `generator` unless
    given. `snr_gamma` turns on the Min-SNR-gamma MSE weights."""

    def step(lora: Lora, batch: Dict[str, torch.Tensor], *,
             generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None,
             force_drop_ids: Optional[torch.Tensor] = None) -> float:
        latents = batch["latents"]
        dev = latents.device
        gen_dev = generator.device if generator is not None else dev
        B = latents.shape[0]
        if t is None:
            t = torch.randint(0, diffusion.num_timesteps, (B,), generator=generator,
                              device=gen_dev).to(dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=gen_dev).to(dev)
        merged = adapted_weights(apply_lora(base_params, lora, scale=scale), lora)

        def model_fn(x_t, t_in):
            return model(x_t, t_in, batch["y"], batch.get("y_mask"), batch.get("img_hw"),
                         batch.get("aspect_ratio"), force_drop_ids=force_drop_ids, train=True,
                         generator=generator)

        mse_weight = None if snr_gamma is None else diffusion.min_snr_weight(t, snr_gamma)
        optimizer.zero_grad(set_to_none=True)
        with swapped_weights(model, merged):
            loss = diffusion.training_losses(model_fn, latents, t, noise,
                                             mse_weight=mse_weight)["loss"].mean()
            loss.backward()
        optimizer.step()
        return float(loss.detach())

    return step


def adamw(params, lr: float) -> torch.optim.AdamW:
    """`optax.adamw(lr)` with its defaults (b1 0.9, b2 0.999, eps 1e-8,
    weight decay 1e-4 on every leaf), which the fine-tuning CLIs use."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
