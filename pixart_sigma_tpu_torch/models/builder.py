"""Model registry and config-driven construction; port of
pixart_sigma_tpu/models/builder.py."""

from __future__ import annotations

from typing import Any, Callable, Dict, Union

import torch

from pixart_sigma_tpu_torch.models.pixart import PixArt, PixArt_XL_2, PixArtMS_XL_2

MODELS: Dict[str, Callable[..., PixArt]] = {
    "PixArt_XL_2": PixArt_XL_2,
    "PixArtMS_XL_2": PixArtMS_XL_2,
}


def build_model(name: str, **kwargs) -> PixArt:
    try:
        factory = MODELS[name]
    except KeyError:
        raise ValueError(f"unknown model {name}; have {sorted(MODELS)}") from None
    return factory(**kwargs)


def model_kwargs_from_config(config, **overrides) -> Dict[str, Any]:
    """A training config (configs/*.py) -> PixArtConfig kwargs."""
    kv = config.get("kv_compress_config") or {}
    kwargs: Dict[str, Any] = dict(
        input_size=config["image_size"] // 8,
        pe_interpolation=config.get("pe_interpolation", 1.0),
        model_max_length=config.get("model_max_length", 120),
        micro_condition=config.get("micro_condition", False),
        qk_norm=config.get("qk_norm", False),
        class_dropout_prob=config.get("class_dropout_prob", 0.1),
        fp32_attention=config.get("fp32_attention", False),
        attn_impl=config.get("attn_impl", "auto"),
        grad_checkpointing=config.get("grad_checkpointing", False),
        quant_int8=config.get("quant_int8", False),
        remat_policy=config.get("remat_policy", "nothing"),
        scan_blocks=config.get("scan_blocks", True),
        mask_ratio=(float(config.get("mask_ratio", 0.0))
                    if config.get("mask_type", "null") != "null" else 0.0),
        mask_type=(config.get("mask_type") if config.get("mask_type", "null") != "null"
                   else "random"),
        dtype=(torch.bfloat16 if config.get("mixed_precision", "bf16") == "bf16"
               else torch.float32),
    )
    if config.get("cache_span"):
        kwargs.update(cache_span=tuple(config["cache_span"]))
    if config.get("kv_compress", False):
        kwargs.update(
            kv_compress_sampling=kv.get("sampling"),
            kv_compress_scale=kv.get("scale_factor", 1),
            kv_compress_layers=tuple(kv.get("kv_compress_layer", ())),
        )
    # config-level architecture overrides (debug and test models)
    kwargs.update(config.get("model_overrides", {}) or {})
    kwargs.update(overrides)
    return kwargs


def build_model_from_config(config, device: Union[str, torch.device] = "cuda",
                            train: bool = False, **overrides) -> PixArt:
    return build_model(config["model"], device=device, train=train,
                       **model_kwargs_from_config(config, **overrides))
