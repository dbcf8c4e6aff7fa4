"""DMD (distribution matching distillation) one-step generator training.

Port of pixart_sigma_tpu/training/dmd.py. Three PixArts of one
architecture: the one-step generator (the student), the frozen real-score
teacher, and the fake-score network, which is trained. Per step:

  1. the student's x0 from `init_noise` at t = start_ts (one call);
  2. the DM loss: x0 renoised at t ~ U[1, start_ts); the real score with
     CFG over an [uncond; cond] batch (score = -eps) and the fake score,
     both without gradients; coeff = (fake - real)·sqrt(b / a); the
     normalised gradient trick, mse(x0, detached(x0 - weight·coeff)) with a
     detached weight;
  3. optionally, the LPIPS regression: the first max(B // 2, 1) x0
     decoded (`decode_fn`) and clipped to [-1, 1] against the teacher's
     `base_latent` decoded likewise, `lpips_fn` averaged and weighed by
     `regression_weight` (the CLI, as JAX's, passes no `lpips_fn`);
  4. the fake-score network's eps-MSE on the detached x0.

Each network has its own optimizer.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from pixart_sigma_tpu_torch.diffusion.gaussian import GaussianDiffusion
from pixart_sigma_tpu_torch.diffusion.schedules import extract


def make_dmd_train_steps(model_cfg, diffusion: GaussianDiffusion, *, start_ts: int = 400,
                         cfg_scale: float = 4.5, regression_weight: float = 0.25,
                         lpips_fn: Optional[Callable] = None,
                         decode_fn: Optional[Callable] = None,
                         generator_optimizer: Optional[torch.optim.Optimizer] = None,
                         fake_optimizer: Optional[torch.optim.Optimizer] = None
                         ) -> Tuple[Callable, Callable, Callable]:
    """(generator_step, fake_step, one_step_generate).

    generator_step(gen, real, fake, batch, *, generator=None, t=None,
    noise=None) -> (metrics, x0 detached), one update of `gen` by
    `generator_optimizer`; fake_step(fake, x0, batch, *, generator=None,
    t=None, noise=None) -> metrics, one update by `fake_optimizer`;
    one_step_generate(model, noise, y, y_mask) -> x0. batch: init_noise, y,
    y_mask, uncond_y, and base_latent for the regression. t (in [1,
    start_ts)) and then the noise come from `generator` unless given.
    lpips_fn(img, base_img) -> [B] distances; decode_fn(latents) -> images
    in [-1, 1] (the caller's VAE decode of scaled latents)."""
    acp = diffusion.coef.alphas_cumprod
    C = model_cfg.in_channels

    def eps_fn(model, x_t, t, y, y_mask):
        return model(x_t, t.float(), y, y_mask)[..., :C]

    def eps_to_x0(eps, x_t, t):
        a = extract(acp, t, x_t.ndim)
        return (x_t - (1 - a) ** 0.5 * eps) / a**0.5

    def one_step_generate(model, noise, y, y_mask):
        """The one-call generator at t = start_ts."""
        t = torch.full((noise.shape[0],), start_ts, dtype=torch.long, device=noise.device)
        return eps_to_x0(eps_fn(model, noise, t, y, y_mask), noise, t)

    def draws(x0, generator, t, noise):
        dev, B = x0.device, x0.shape[0]
        gen_dev = generator.device if generator is not None else dev
        if t is None:
            t = torch.randint(1, start_ts, (B,), generator=generator, device=gen_dev)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=gen_dev)
        return t.to(dev).long(), noise.to(dev)

    def generator_step(gen, real, fake, batch: Dict[str, torch.Tensor], *,
                       generator: Optional[torch.Generator] = None,
                       t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        y, y_mask, uncond_y = batch["y"], batch.get("y_mask"), batch["uncond_y"]
        x0 = one_step_generate(gen, batch["init_noise"], y, y_mask)
        t, noise = draws(x0, generator, t, noise)
        nd = x0.ndim
        with torch.no_grad():
            x_t = diffusion.q_sample(x0, t, noise)
            m2 = None if y_mask is None else torch.cat([y_mask, y_mask])
            real_eps = eps_fn(real, torch.cat([x_t, x_t]), torch.cat([t, t]),
                              torch.cat([uncond_y, y]), m2)
            score_u, score_c = (-real_eps).chunk(2, dim=0)
            score_real = score_u + cfg_scale * (score_c - score_u)
            score_fake = -eps_fn(fake, x_t, t, y, y_mask)
            a = extract(acp, t, nd)
            b = 1.0 - a
            coeff = (score_fake - score_real) * b**0.5 / a**0.5
            pred_latents = (x_t + b**0.5 * score_real) / a**0.5
            weight = 1.0 / ((x0 - pred_latents).abs().mean(dim=tuple(range(1, nd)), keepdim=True)
                            + 1e-5)
            target = x0 - weight * coeff
        dm_loss = ((x0 - target) ** 2).mean()
        metrics = {"dm_loss": float(dm_loss.detach())}
        loss = dm_loss
        if lpips_fn is not None and decode_fn is not None and "base_latent" in batch:
            rb = max(x0.shape[0] // 2, 1)
            imgs = decode_fn(x0[:rb]).clamp(-1.0, 1.0)
            with torch.no_grad():
                base = decode_fn(batch["base_latent"][:rb]).clamp(-1.0, 1.0)
            reg = lpips_fn(imgs, base).mean() * regression_weight
            metrics["lpips_loss"] = float(reg.detach())
            loss = loss + reg
        generator_optimizer.zero_grad(set_to_none=True)
        loss.backward()
        generator_optimizer.step()
        metrics["loss"] = float(loss.detach())
        return metrics, x0.detach()

    def fake_step(fake, x0, batch: Dict[str, torch.Tensor], *,
                  generator: Optional[torch.Generator] = None,
                  t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        t, noise = draws(x0, generator, t, noise)
        x_t = diffusion.q_sample(x0, t, noise)
        loss = ((eps_fn(fake, x_t, t, batch["y"], batch.get("y_mask")) - noise) ** 2).mean()
        fake_optimizer.zero_grad(set_to_none=True)
        loss.backward()
        fake_optimizer.step()
        return {"sg_loss": float(loss.detach())}

    return generator_step, fake_step, one_step_generate
