"""One iDDPM training step: t ~ U[0, T), noise, the loss, backward, the
global-norm clip, the optimizer and the EMA.

Port of pixart_sigma_tpu/training/train_step.py for one device. The random
draws (t, noise, then the caption dropout inside the model) come from one
explicit `torch.Generator` in that order; t, noise and the drop ids may be
passed in instead, which the tests do to compare with the JAX package (the
two frameworks draw different numbers from the same seed). Mesh sharding and
the loss-second-moment timestep sampler and Min-SNR weighting are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pixart_sigma_tpu_torch.diffusion.gaussian import GaussianDiffusion
from pixart_sigma_tpu_torch.training.optim import clip_by_global_norm
from pixart_sigma_tpu_torch.training.train_state import TrainState


def compute_losses(model, diffusion: GaussianDiffusion, batch: Dict[str, torch.Tensor],
                   t: torch.Tensor, noise: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   force_drop_ids: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The loss and its parts, batch means (the `loss_fn` of the JAX step).

    batch: latents [B, H, W, C] (already scaled), y [B, L, C_cap], y_mask
    [B, L], and img_hw / aspect_ratio for micro-conditioned models."""

    def model_fn(x_t, t_in):
        return model(x_t, t_in, batch["y"], batch.get("y_mask"), batch.get("img_hw"),
                     batch.get("aspect_ratio"), force_drop_ids=force_drop_ids, train=True,
                     generator=generator)

    terms = diffusion.training_losses(model_fn, batch["latents"], t, noise)
    out = {"loss": terms["loss"].mean(), "mse": terms["mse"].mean()}
    if "vb" in terms:
        out["vb"] = terms["vb"].mean()
    return out


def train_step(state: TrainState, diffusion: GaussianDiffusion, batch: Dict[str, torch.Tensor],
               *, generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None,
               force_drop_ids: Optional[torch.Tensor] = None,
               grad_clip: Optional[float] = None) -> Dict[str, float]:
    """Update `state` in place; returns the step's metrics (loss, mse, vb,
    grad_norm before clipping, lr) as floats."""
    latents = batch["latents"]
    dev = latents.device
    gen_dev = generator.device if generator is not None else dev
    if t is None:
        t = torch.randint(0, diffusion.num_timesteps, (latents.shape[0],), generator=generator,
                          device=gen_dev).to(dev)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=gen_dev,
                            dtype=latents.dtype).to(dev)
    lr = state.lr()
    state.optimizer.zero_grad(set_to_none=True)
    terms = compute_losses(state.model, diffusion, batch, t, noise, generator=generator,
                           force_drop_ids=force_drop_ids)
    terms["loss"].backward()
    params = [p for p in state.model.parameters() if p.requires_grad]
    grad_norm = clip_by_global_norm(params, grad_clip)
    state.apply_gradients()
    metrics = {k: float(v.detach()) for k, v in terms.items()}
    metrics.update(grad_norm=grad_norm, lr=lr)
    return metrics
