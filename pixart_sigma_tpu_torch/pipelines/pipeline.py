"""PixArtPipeline: prompts -> uint8 images with 20-step DPM-Solver++ and CFG.

Port of pixart_sigma_tpu/pipelines/pipeline.py for `sampler="dpm-solver"`:
the caption K/V are computed once per trajectory for the CFG batch
[uncond, cond], every step runs the model once on the 2B batch, and the VAE
decodes one image at a time. The other samplers, block caching and the tiled
decode beyond 1024px are not ported yet and raise.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from pixart_sigma_tpu_torch.data.aspect import aspect_ratio_table
from pixart_sigma_tpu_torch.diffusion.dpm_solver import (
    DPMSolver,
    NoiseScheduleVP,
    make_cfg_model_fn,
)
from pixart_sigma_tpu_torch.diffusion.schedules import named_beta_schedule
from pixart_sigma_tpu_torch.models.pixart import precompute_cross_kv
from pixart_sigma_tpu_torch.utils.device import resolve_device
from pixart_sigma_tpu_torch.utils.prompt import prepare_prompt_ar


class PixArtPipeline:
    """Bundles the denoiser, a text encoder and the VAE.

    model: a port `PixArt` on `device`. t5: an object with
    `get_text_embeddings(texts) -> (y, mask)` (e.g. `PseudoT5Embedder`), or
    None to take precomputed `y` / `y_mask`. vae: a port `AutoencoderKL`, or
    None to return latents.
    """

    def __init__(
        self,
        model,
        t5=None,
        vae=None,
        scale_factor: float = 0.13025,
        beta_schedule: str = "linear",
        num_train_timesteps: int = 1000,
        base_resolution: int = 1024,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.model = model
        self.t5 = t5
        self.vae = vae
        self.scale_factor = scale_factor
        self.betas = named_beta_schedule(beta_schedule, num_train_timesteps)
        self.ns = NoiseScheduleVP("discrete", betas=self.betas)
        self.base_resolution = base_resolution

    def encode_prompts(self, prompts: Sequence[str]):
        if self.t5 is None:
            raise ValueError("pipeline built without a text encoder")
        y, mask = self.t5.get_text_embeddings(list(prompts))
        return y.to(self.device), mask.to(self.device)

    def _latents_to_images(self, latents: torch.Tensor) -> np.ndarray:
        if self.vae is None:
            return latents.cpu().numpy()
        if latents.shape[1] > 128 or latents.shape[2] > 128:
            raise NotImplementedError(
                "tiled VAE decode beyond 1024px is not ported yet "
                "(ROADMAP.md, Queue 1: 2K/4K sampling)")
        z = latents / self.scale_factor
        # one image at a time: the mid-block attention over 128 x 128 tokens
        # holds a 1 GiB f32 logit matrix per image
        imgs = [self.vae.decode(z[i : i + 1]) for i in range(z.shape[0])]
        img = torch.clamp((torch.cat(imgs).float() + 1.0) / 2.0, 0.0, 1.0)
        return (img * 255).round().to(torch.uint8).cpu().numpy()

    @torch.no_grad()
    def __call__(
        self,
        prompts: Union[str, Sequence[str]],
        *,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 20,
        guidance_scale: float = 4.5,
        sampler: str = "dpm-solver",
        seed: int = 0,
        negative_prompt: str = "",
        y: Optional[torch.Tensor] = None,
        y_mask: Optional[torch.Tensor] = None,
        y_null: Optional[torch.Tensor] = None,
        latents: Optional[torch.Tensor] = None,
        return_latents: bool = False,
        block_cache_interval: int = 0,
        block_cache_threshold: Optional[float] = None,
        block_cache_schedule: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        """Generate images [B, H, W, 3] uint8 (or latents [B, H/8, W/8, 4]).
        Prompts may carry `--ar h:w` / `--hw h:w` flags."""
        if sampler != "dpm-solver":
            raise NotImplementedError(
                f"sampler {sampler!r} is not ported yet (ROADMAP.md, Queue 1: other samplers)")
        if block_cache_interval >= 2 or block_cache_threshold is not None \
                or block_cache_schedule is not None:
            raise NotImplementedError(
                "block caching is not ported yet (ROADMAP.md, Queue 1: block cache and int8)")
        if isinstance(prompts, str):
            prompts = [prompts]
        B = len(prompts)
        ratios = aspect_ratio_table(self.base_resolution, test=True)
        clean_prompts, hws, ars = [], [], []
        for p in prompts:
            cp, hw, ar, _ = prepare_prompt_ar(p, ratios)
            clean_prompts.append(cp)
            hws.append(hw[0])
            ars.append(ar[0])
        if height is None or width is None:
            height, width = int(hws[0][0]), int(hws[0][1])
        if not self.model.cfg.multi_scale and height != width:
            height = width = self.base_resolution  # fixed-resolution: square only
        h, w = height // 8, width // 8
        dev = self.device

        if y is None:
            if self.t5 is None:
                warnings.warn(
                    "pipeline has no text encoder; conditioning on the null "
                    "caption embedding: outputs are UNCONDITIONAL")
                null_emb = self.model.y_embedder.y_embedding.float()
                y = null_emb[None].expand(B, *null_emb.shape)
                y_mask = torch.ones((B, null_emb.shape[0]), dtype=torch.int32, device=dev)
            else:
                y, y_mask = self.encode_prompts(clean_prompts)
        y, y_mask = y.to(dev), y_mask.to(dev)
        if y_null is None:
            if self.t5 is None:
                null_y, null_mask = y, y_mask
            else:
                null_y, null_mask = self.encode_prompts([negative_prompt] * B)
        else:
            null_y, null_mask = y_null.to(dev), y_mask
        mask_full = torch.cat([null_mask, y_mask], dim=0)
        img_hw = torch.from_numpy(np.stack(hws)).to(dev)
        aspect = torch.from_numpy(np.stack(ars)).to(dev)

        if latents is not None:
            if tuple(latents.shape) != (B, h, w, 4):
                raise ValueError(f"latents {tuple(latents.shape)} != {(B, h, w, 4)}")
            x = latents.to(dev, torch.float32)
        else:
            gen = torch.Generator(device=dev).manual_seed(seed)
            x = torch.randn((B, h, w, 4), generator=gen, device=dev, dtype=torch.float32)
        run = self._build_dpm(num_inference_steps, guidance_scale)
        out = run(x, y, null_y, mask_full, img_hw, aspect)
        if return_latents:
            return out.cpu().numpy()
        return self._latents_to_images(out)

    def _apply_eps(self, x, t_vec, cond, mask, img_hw, aspect, cross_kv=None):
        kwargs = {}
        if self.model.cfg.micro_condition:
            n = x.shape[0] // img_hw.shape[0]
            kwargs = dict(img_hw=img_hw.repeat(n, 1), aspect_ratio=aspect.repeat(n, 1))
        out = self.model(x, t_vec, cond, mask, cross_kv=cross_kv, **kwargs)
        return out[..., :4]

    def _hoisted_kv(self, y_cat: torch.Tensor) -> list:
        """Caption K/V of the CFG batch, once per trajectory."""
        return precompute_cross_kv(self.model, y_cat)

    def _build_dpm(self, steps: int, cfg_scale: float):
        def run(x, y, null_y, mask, img_hw, aspect):
            kvs = self._hoisted_kv(torch.cat([null_y, y], dim=0))
            apply_fn = lambda xi, t, c: self._apply_eps(
                xi, t, c, mask, img_hw, aspect, cross_kv=kvs)
            model_fn = make_cfg_model_fn(
                apply_fn, self.ns, condition=y, uncondition=null_y, cfg_scale=cfg_scale)
            solver = DPMSolver(model_fn, self.ns, algorithm_type="dpmsolver++")
            return solver.sample(x, steps=steps, order=2, method="multistep")

        return run
