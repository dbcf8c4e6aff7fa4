"""What the fine-tuning and distillation CLIs share: the model from a config
with weights from a `.pth` or a diffusers `.safetensors`, the shuffled
feature loader, device batches and the optimizer over a model."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from pixart_sigma_tpu_torch.models.builder import build_model_from_config
from pixart_sigma_tpu_torch.training.optim import block_stacks, build_optimizer
from pixart_sigma_tpu_torch.utils.checkpoint import load_checkpoint


def load_model(config, path: str, device, train: bool):
    """The config's PixArt with the weights at `path`: a training model (f32
    weights; `train`) or an inference model (weights in the compute dtype),
    every parameter frozen."""
    model = build_model_from_config(config, device=device, train=train)
    load_checkpoint(path, model)
    return model.requires_grad_(False)


def feature_loader(config):
    """The config's dataset in shuffled full batches of `train_batch_size`
    (the JAX CLIs' `_SimpleBatchSampler`), on the thread loader."""
    from pixart_sigma_tpu_torch.data.loader import DataLoader
    from pixart_sigma_tpu_torch.data.sampler import SimpleBatchSampler
    from pixart_sigma_tpu_torch.training.trainer import build_dataset

    dataset = build_dataset(config)
    sampler = SimpleBatchSampler(len(dataset), config.train_batch_size, seed=config.seed)
    return DataLoader(dataset, sampler, num_workers=config.get("num_workers", 4))


def device_batch(batch: Dict[str, Any], config, model_cfg, device) -> Dict[str, torch.Tensor]:
    """A feature batch on the device: latents times the scale factor, the
    captions, and the micro-conditions when the model takes them."""
    to = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    out = {"latents": to(np.asarray(batch["latents"], np.float32) * config.scale_factor),
           "y": to(batch["y"]), "y_mask": to(batch["y_mask"])}
    if model_cfg.micro_condition:
        out["img_hw"], out["aspect_ratio"] = to(batch["img_hw"]), to(batch["aspect_ratio"])
    return out


def optimizer_for(model, name: str, lr: float, **opt_cfg) -> torch.optim.Optimizer:
    """`build_optimizer` over the model's parameters; CAME factors the scan
    groups' stacks when the model's `scan_blocks` is set, as JAX's tree has
    them."""
    named = list(model.named_parameters())
    stacks = (block_stacks([n for n, _ in named], model.cfg.block_groups())
              if model.cfg.scan_blocks else None)
    return build_optimizer(named, name=name, lr=lr, stacks=stacks, **opt_cfg)
