"""Latent-consistency (LCM) distillation training step.

Port of pixart_sigma_tpu/training/lcm_trainer.py: an online student, a
frozen teacher and an EMA target network, per step

  1. t_{n+k} = ddim_timesteps[index], t_n = max(t_{n+k} - T / N, 0);
  2. the student's eps at t_{n+k} -> x0, model_pred = c_skip·x_t + c_out·x0;
  3. the teacher's eps, conditional and unconditional, with the LCM paper's
     guidance (cond + w·(cond - uncond)), and one DDIM step to x_prev;
  4. the EMA target at t_n on x_prev (no added noise) -> the target;
  5. the huber or l2 loss, one optimizer step, and the EMA update at
     `ema_decay` (0.95) on every step, without the warmup ramp.

The student runs without caption dropout; the teacher and the target run
without gradients. `TrainState.ema` is the target network's weights.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from pixart_sigma_tpu_torch.diffusion.gaussian import GaussianDiffusion
from pixart_sigma_tpu_torch.diffusion.lcm import DDIMSolver, scalings_for_boundary_conditions
from pixart_sigma_tpu_torch.diffusion.schedules import extract
from pixart_sigma_tpu_torch.training.optim import global_norm
from pixart_sigma_tpu_torch.training.train_state import TrainState


def make_lcm_train_step(model_cfg, diffusion: GaussianDiffusion, *, num_ddim_timesteps: int = 50,
                        cfg_scale: float = 4.5, loss_type: str = "huber",
                        huber_c: float = 0.001, ema_decay: float = 0.95) -> Callable:
    """step(state, teacher, uncond_y, batch, *, generator=None, index=None,
    noise=None, grad_clip=None) -> {"loss"}.

    `state.model` is the student, `state.ema` the target network's weights,
    `teacher` a PixArt of the same architecture. batch: latents (scaled), y,
    y_mask, and img_hw / aspect_ratio for micro-conditioned models. The
    DDIM index (uniform in [0, N)) and then the noise come from `generator`
    unless given."""
    T = diffusion.num_timesteps
    acp = diffusion.coef.alphas_cumprod.double().numpy()
    solver = DDIMSolver(acp, T, num_ddim_timesteps)
    topk = T // num_ddim_timesteps
    ddim_ts = torch.from_numpy(solver.ddim_timesteps)
    sqrt_acp = torch.from_numpy(np.sqrt(acp).astype(np.float32))
    sqrt_1macp = torch.from_numpy(np.sqrt(1 - acp).astype(np.float32))
    C = model_cfg.in_channels

    def eps_and_x0(model, x_t, t, y, batch):
        out = model(x_t, t.float(), y, batch.get("y_mask"),
                    batch.get("img_hw") if model_cfg.micro_condition else None,
                    batch.get("aspect_ratio") if model_cfg.micro_condition else None)
        eps = out[..., :C]
        x0 = (x_t - extract(sqrt_1macp, t, x_t.ndim) * eps) / extract(sqrt_acp, t, x_t.ndim)
        return eps, x0

    def step(state: TrainState, teacher, uncond_y: torch.Tensor, batch: Dict[str, torch.Tensor],
             *, generator: Optional[torch.Generator] = None, index: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None,
             grad_clip: Optional[float] = None) -> Dict[str, float]:
        student = state.model
        latents = batch["latents"]
        dev, nd, B = latents.device, latents.ndim, latents.shape[0]
        gen_dev = generator.device if generator is not None else dev
        if index is None:
            index = torch.randint(0, num_ddim_timesteps, (B,), generator=generator,
                                  device=gen_dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=gen_dev)
        index, noise = index.to(dev).long(), noise.to(dev)
        start_t = ddim_ts.to(dev)[index]  # t_{n+k}
        t_n = torch.clamp(start_t - topk, min=0)
        expand = lambda v: v.reshape(-1, *((1,) * (nd - 1)))
        c_skip_s, c_out_s = map(expand, scalings_for_boundary_conditions(start_t.float()))
        c_skip, c_out = map(expand, scalings_for_boundary_conditions(t_n.float()))

        x_t = diffusion.q_sample(latents, start_t, noise)
        _, pred_x0 = eps_and_x0(student, x_t, start_t, batch["y"], batch)
        model_pred = c_skip_s * x_t + c_out_s * pred_x0
        with torch.no_grad():
            t_eps_c, t_x0_c = eps_and_x0(teacher, x_t, start_t, batch["y"], batch)
            t_eps_u, t_x0_u = eps_and_x0(teacher, x_t, start_t, uncond_y, batch)
            pred_x0_t = t_x0_c + cfg_scale * (t_x0_c - t_x0_u)
            pred_eps_t = t_eps_c + cfg_scale * (t_eps_c - t_eps_u)
            x_prev = solver.ddim_step(pred_x0_t, pred_eps_t, index)
            target_model = lambda *a: torch.func.functional_call(student, state.ema, a)
            _, target_x0 = eps_and_x0(target_model, x_prev, t_n, batch["y"], batch)
            target = c_skip * x_prev + c_out * target_x0
        if loss_type == "l2":
            loss = ((model_pred - target) ** 2).mean()
        else:  # pseudo-huber
            loss = (torch.sqrt((model_pred - target) ** 2 + huber_c**2) - huber_c).mean()
        lr = state.lr()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = global_norm([p for p in student.parameters() if p.requires_grad])
        state.apply_gradients(grad_clip, grad_norm, ema_rate=ema_decay)
        return {"loss": float(loss.detach()), "grad_norm": float(grad_norm), "lr": lr}

    return step
