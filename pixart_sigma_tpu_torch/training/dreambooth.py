"""DreamBooth(-LoRA) subject-driven finetuning.

Port of pixart_sigma_tpu/training/dreambooth.py: the LoRA step with the
prior-preservation split, instance and class samples stacked [instance;
class] in one batch, each half's mean loss weighted on its own.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from pixart_sigma_tpu_torch.diffusion.gaussian import GaussianDiffusion
from pixart_sigma_tpu_torch.training.lora import Lora, adapted_weights, apply_lora, swapped_weights


def make_dreambooth_step(model, diffusion: GaussianDiffusion,
                         base_params: Dict[str, torch.Tensor], optimizer: torch.optim.Optimizer,
                         *, with_prior_preservation: bool = True,
                         prior_loss_weight: float = 1.0, lora_scale: float = 1.0) -> Callable:
    """step(lora, batch, *, generator=None, t=None, noise=None) -> metrics.

    The model runs without caption dropout, as JAX's step calls it. With
    prior preservation the loss is mean(instance half) + prior_loss_weight ·
    mean(class half), split at B // 2; without it, the plain mean. t and the
    noise come from `generator` unless given."""

    def step(lora: Lora, batch: Dict[str, torch.Tensor], *,
             generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> Dict[str, float]:
        latents = batch["latents"]
        dev = latents.device
        gen_dev = generator.device if generator is not None else dev
        B = latents.shape[0]
        if t is None:
            t = torch.randint(0, diffusion.num_timesteps, (B,), generator=generator,
                              device=gen_dev).to(dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=gen_dev).to(dev)
        merged = adapted_weights(apply_lora(base_params, lora, scale=lora_scale), lora)

        def model_fn(x_t, t_in):
            return model(x_t, t_in, batch["y"], batch.get("y_mask"))

        optimizer.zero_grad(set_to_none=True)
        with swapped_weights(model, merged):
            per_sample = diffusion.training_losses(model_fn, latents, t, noise)["loss"]
            if with_prior_preservation:
                half = B // 2
                instance = per_sample[:half].mean()
                prior = per_sample[half:].mean()
                loss = instance + prior_loss_weight * prior
                metrics = {"loss": loss, "instance": instance, "prior": prior}
            else:
                loss = per_sample.mean()
                metrics = {"loss": loss}
            loss.backward()
        optimizer.step()
        return {k: float(v.detach()) for k, v in metrics.items()}

    return step
