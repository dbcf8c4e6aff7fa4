"""One iDDPM training micro-step: t, noise, the loss, backward, and the
state's update (accumulation, the global-norm clip, the optimizer, the EMA).

Port of pixart_sigma_tpu/training/train_step.py for one device, with its
options: the loss-second-moment timestep sampler (its loss weights, and its
update from the per-sample losses), Min-SNR-gamma weights (`snr_gamma`) and
the masked-training loss (`mask_loss_coef`). The random draws come from one
explicit `torch.Generator` in a fixed order: t (uniform, or from the
sampler), the noise, the token mask's uniform draw (masked models) and the
caption drops, all drawn by the step and handed to the model, in the order
the model would draw them itself. t (without a sampler), the noise and the
drop ids may be passed to `train_step` instead, and the mask's uniform draw
to `compute_losses`, which the tests do to compare with the JAX package
(the JAX step splits a per-step key four ways, so the two frameworks draw
different numbers from the same seed).

Sharded (`state.batch_ranks` > 1, set by the Trainer), each rank holds its
slice of the global batch, and the step computes what one rank computes at
the global batch, as the JAX step under GSPMD draws global arrays from a
replicated key: every rank makes the global batch's draws above from its
equally seeded generator and keeps its rows; the loss is the global mean
(the local mean, with gradients averaged over the batch ranks by DDP, FSDP
or `sharded.average_gradients`); the resampler learns from the
all-gathered (t, per-sample loss), so its ring stays the same on every
rank; and the metrics are the global batch's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pixart_sigma_tpu_torch.diffusion.gaussian import GaussianDiffusion
from pixart_sigma_tpu_torch.parallel.dist import all_gather_tensor, reduce_dict
from pixart_sigma_tpu_torch.parallel.sharded import average_gradients
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
    [B, L], and img_hw / aspect_ratio for micro-conditioned models. `model`
    may be a DDP wrapper of the PixArt model."""
    cfg = getattr(model, "module", model).cfg

    def model_fn(x_t, t_in):
        return model(x_t, t_in, batch["y"], batch.get("y_mask"), batch.get("img_hw"),
                     batch.get("aspect_ratio"), force_drop_ids=force_drop_ids, train=True,
                     generator=generator, mask_noise=mask_noise)

    mse_weight = None if snr_gamma is None else diffusion.min_snr_weight(t, snr_gamma)
    terms = diffusion.training_losses(model_fn, batch["latents"], t, noise,
                                      mse_weight=mse_weight, mask_loss_coef=mask_loss_coef,
                                      patch_size=cfg.patch_size)
    per_sample = terms["loss"]
    loss = per_sample.mean() if loss_weight is None else (per_sample * loss_weight).mean()
    out = {"loss": loss, "mse": terms["mse"].mean(), "per_sample": per_sample.detach()}
    for key in ("vb", "mae"):
        if key in terms:
            out[key] = terms[key].mean()
    return out


def _draws(state: TrainState, diffusion: GaussianDiffusion, latents: torch.Tensor,
           generator: Optional[torch.Generator], schedule_sampler, t, noise, force_drop_ids):
    """The step's draws for the global batch, in the model's order (t, noise,
    the token-mask noise of a masked model, the caption drops), each drawn
    only when not given; the global t (for the resampler's update) and this
    rank's rows of everything. The model is always given the token-mask
    noise and the drop ids, so it draws nothing itself; these are the calls
    it would make, with the same shapes, so one rank draws what the model
    would."""
    if schedule_sampler is not None and t is not None:
        raise ValueError("t is drawn by the schedule sampler; pass one or the other")
    dev = latents.device
    gen_dev = generator.device if generator is not None else dev
    B = latents.shape[0] * state.batch_ranks
    shape = (B,) + tuple(latents.shape[1:])
    cfg = state.model.cfg
    loss_weight = None
    if schedule_sampler is not None:
        t, loss_weight = schedule_sampler.sample(B, generator)
        t, loss_weight = t.to(dev), loss_weight.to(dev)
    elif t is None:
        t = torch.randint(0, diffusion.num_timesteps, (B,), generator=generator,
                          device=gen_dev).to(dev)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=gen_dev,
                            dtype=latents.dtype).to(dev)
    mask_noise = None
    if cfg.mask_ratio > 0:
        p = cfg.patch_size
        mask_noise = torch.rand((B, (shape[1] // p) * (shape[2] // p)), generator=generator,
                                device=gen_dev).to(dev)
    if cfg.class_dropout_prob > 0 and force_drop_ids is None:
        u = torch.rand((B,), generator=generator, device=gen_dev)
        force_drop_ids = (u < cfg.class_dropout_prob).to(dev, torch.int32)
    rows = slice(state.batch_rank * latents.shape[0], (state.batch_rank + 1) * latents.shape[0])
    pick = lambda a: None if a is None else a[rows]
    return t, dict(t=pick(t), noise=pick(noise), loss_weight=pick(loss_weight),
                   force_drop_ids=pick(force_drop_ids), mask_noise=pick(mask_noise))


def sum_over_seq(state: TrainState) -> None:
    """Sum each parameter's (local) gradient over the seq group, where each
    rank's is the part of its tokens. The group's ranks share their tensor
    and fsdp coordinates, so their local shards of a sharded gradient are
    the same slice; it runs after the batch ranks' average and before the
    global norm."""
    average_gradients([p for p in state.model.parameters() if p.requires_grad],
                      state.seq_group, mean=False)


def train_step(state: TrainState, diffusion: GaussianDiffusion, batch: Dict[str, torch.Tensor],
               *, generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None,
               force_drop_ids: Optional[torch.Tensor] = None,
               grad_clip: Optional[float] = None, schedule_sampler=None,
               snr_gamma: Optional[float] = None,
               mask_loss_coef: float = 0.0) -> Dict[str, float]:
    """Update `state` in place; returns the micro-step's metrics (loss, mse,
    vb, mae, its own gradients' global norm before clipping, lr) as floats,
    the global batch's. With a `schedule_sampler`, t comes from it (so `t`
    must not be given), the loss is weighted by its weights, and it learns
    from the per-sample losses. `t`, `noise` and `force_drop_ids` given
    are the global batch's; a rank keeps its rows."""
    global_t, d = _draws(state, diffusion, batch["latents"], generator, schedule_sampler, t,
                         noise, force_drop_ids)
    lr = state.lr()
    state.optimizer.zero_grad(set_to_none=True)
    terms = compute_losses(state.forward, diffusion, batch, d["t"], d["noise"],
                           force_drop_ids=d["force_drop_ids"], mask_noise=d["mask_noise"],
                           loss_weight=d["loss_weight"], snr_gamma=snr_gamma,
                           mask_loss_coef=mask_loss_coef)
    terms["loss"].backward()
    average_gradients(state.sync_params, state.batch_group)
    sum_over_seq(state)
    grad_norm = global_norm([p for p in state.model.parameters() if p.requires_grad])
    state.apply_gradients(grad_clip, grad_norm)
    per_sample = terms.pop("per_sample")
    if schedule_sampler is not None:
        schedule_sampler.update(global_t, all_gather_tensor(per_sample, state.batch_group))
    if state.batch_ranks > 1:
        terms = reduce_dict({k: v.detach() for k, v in terms.items()}, state.batch_group)
    metrics = {k: float(v.detach()) for k, v in terms.items()}
    metrics.update(grad_norm=float(grad_norm), lr=lr)
    return metrics
