"""One iDDPM training micro-step: t, noise, the loss, backward, and the
state's update (accumulation, the global-norm clip, the optimizer, the EMA).

Port of pixart_sigma_tpu/training/train_step.py for one device, with its
options: the loss-second-moment timestep sampler (its loss weights, and its
update from the per-sample losses), Min-SNR-gamma weights (`snr_gamma`) and
the masked-training loss (`mask_loss_coef`). The random draws come from one
explicit `torch.Generator` in a fixed order: t (uniform, or from the
sampler), the noise, then inside the model the token mask (masked models)
and the caption drops. t (without a sampler), the noise and the drop ids may
be passed to `train_step` instead, and the mask's uniform draw to
`compute_losses`, which the tests do to compare with the JAX package
(the JAX step splits a per-step key four ways, so the two frameworks draw
different numbers from the same seed). Mesh sharding is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pixart_sigma_tpu_torch.diffusion.gaussian import GaussianDiffusion
from pixart_sigma_tpu_torch.training.optim import global_norm
from pixart_sigma_tpu_torch.training.train_state import TrainState


def compute_losses(model, diffusion: GaussianDiffusion, batch: Dict[str, torch.Tensor],
                   t: torch.Tensor, noise: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   force_drop_ids: Optional[torch.Tensor] = None,
                   mask_noise: Optional[torch.Tensor] = None,
                   loss_weight: Optional[torch.Tensor] = None,
                   snr_gamma: Optional[float] = None,
                   mask_loss_coef: float = 0.0) -> Dict[str, torch.Tensor]:
    """The loss and its parts as batch means (the `loss_fn` of the JAX step),
    and "per_sample", the unweighted per-sample losses the sampler learns
    from. `loss_weight` [B] reweights the mean (importance sampling).

    batch: latents [B, H, W, C] (already scaled), y [B, L, C_cap], y_mask
    [B, L], and img_hw / aspect_ratio for micro-conditioned models."""

    def model_fn(x_t, t_in):
        return model(x_t, t_in, batch["y"], batch.get("y_mask"), batch.get("img_hw"),
                     batch.get("aspect_ratio"), force_drop_ids=force_drop_ids, train=True,
                     generator=generator, mask_noise=mask_noise)

    mse_weight = None if snr_gamma is None else diffusion.min_snr_weight(t, snr_gamma)
    terms = diffusion.training_losses(model_fn, batch["latents"], t, noise,
                                      mse_weight=mse_weight, mask_loss_coef=mask_loss_coef,
                                      patch_size=model.cfg.patch_size)
    per_sample = terms["loss"]
    loss = per_sample.mean() if loss_weight is None else (per_sample * loss_weight).mean()
    out = {"loss": loss, "mse": terms["mse"].mean(), "per_sample": per_sample.detach()}
    for key in ("vb", "mae"):
        if key in terms:
            out[key] = terms[key].mean()
    return out


def train_step(state: TrainState, diffusion: GaussianDiffusion, batch: Dict[str, torch.Tensor],
               *, generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None,
               force_drop_ids: Optional[torch.Tensor] = None,
               grad_clip: Optional[float] = None, schedule_sampler=None,
               snr_gamma: Optional[float] = None,
               mask_loss_coef: float = 0.0) -> Dict[str, float]:
    """Update `state` in place; returns the micro-step's metrics (loss, mse,
    vb, mae, its own gradients' global norm before clipping, lr) as floats.
    With a `schedule_sampler`, t comes from it (so `t` must not be given),
    the loss is weighted by its weights, and it learns from the per-sample
    losses."""
    latents = batch["latents"]
    dev = latents.device
    gen_dev = generator.device if generator is not None else dev
    loss_weight = None
    if schedule_sampler is not None:
        if t is not None:
            raise ValueError("t is drawn by the schedule sampler; pass one or the other")
        t, loss_weight = schedule_sampler.sample(latents.shape[0], generator)
        t, loss_weight = t.to(dev), loss_weight.to(dev)
    elif t is None:
        t = torch.randint(0, diffusion.num_timesteps, (latents.shape[0],), generator=generator,
                          device=gen_dev).to(dev)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=gen_dev,
                            dtype=latents.dtype).to(dev)
    lr = state.lr()
    state.optimizer.zero_grad(set_to_none=True)
    terms = compute_losses(state.model, diffusion, batch, t, noise, generator=generator,
                           force_drop_ids=force_drop_ids, loss_weight=loss_weight,
                           snr_gamma=snr_gamma, mask_loss_coef=mask_loss_coef)
    terms["loss"].backward()
    grad_norm = global_norm([p for p in state.model.parameters() if p.requires_grad])
    state.apply_gradients(grad_clip, grad_norm)
    per_sample = terms.pop("per_sample")
    if schedule_sampler is not None:
        schedule_sampler.update(t, per_sample)
    metrics = {k: float(v.detach()) for k, v in terms.items()}
    metrics.update(grad_norm=float(grad_norm), lr=lr)
    return metrics
