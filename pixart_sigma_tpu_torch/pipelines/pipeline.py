"""PixArtPipeline: prompts -> uint8 images with any sampler of the JAX
pipeline.

Port of pixart_sigma_tpu/pipelines/pipeline.py. Samplers: "dpm-solver"
(20-step DPM-Solver++ by default), "deis", "sde-dpm-solver", "sa-solver"
and "iddpm" run classifier-free guidance as one 2B model call per step with
the caption K/V computed once per trajectory; "lcm" and the one-NFE "dmd"
run unguided on the B prompts. The VAE decodes one image at a time up to
128 x 128 latents (1024px) and tile by tile beyond (`models.vae.tiled_decode`:
2048px, or 4096px through the 2880 bucket table). Block caching is not
ported yet and raises (ROADMAP.md, Queue 1 item 7).

The stochastic samplers take their per-step noise from `noise_fn(k, shape)`
(`diffusion/noise.py`): by default a `torch.Generator` on the device, seeded
with `seed`, which also draws the initial latents when none are given.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from pixart_sigma_tpu_torch.data.aspect import aspect_ratio_table
from pixart_sigma_tpu_torch.diffusion.deis import DEISMultistep
from pixart_sigma_tpu_torch.diffusion.dpm_solver import (
    DPMSolver,
    NoiseScheduleVP,
    make_cfg_model_fn,
)
from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
from pixart_sigma_tpu_torch.diffusion.lcm import LCMScheduler
from pixart_sigma_tpu_torch.diffusion.noise import NoiseFn, generator_noise
from pixart_sigma_tpu_torch.diffusion.sa_solver import SASolver
from pixart_sigma_tpu_torch.diffusion.schedules import named_beta_schedule
from pixart_sigma_tpu_torch.models.pixart import precompute_cross_kv
from pixart_sigma_tpu_torch.models.vae import tiled_decode
from pixart_sigma_tpu_torch.utils.device import resolve_device
from pixart_sigma_tpu_torch.utils.prompt import prepare_prompt_ar


def decode_to_uint8(vae, z: torch.Tensor) -> np.ndarray:
    """VAE latents [B, h, w, 4] (already divided by the scale factor) ->
    uint8 images [B, 8h, 8w, 3]: one image at a time up to 128 x 128 latents
    (the mid-block attention over 128 x 128 tokens holds a 1 GiB f32 logit
    matrix per image), tile by tile beyond."""
    if z.shape[1] > 128 or z.shape[2] > 128:
        img = tiled_decode(vae.decode, z)
    else:
        img = torch.cat([vae.decode(z[i : i + 1]) for i in range(z.shape[0])])
    img = torch.clamp((img.float() + 1.0) / 2.0, 0.0, 1.0)
    return (img * 255).round().to(torch.uint8).cpu().numpy()


class PixArtPipeline:
    """Bundles the denoiser, a text encoder and the VAE.

    model: a port `PixArt` on `device`. t5: an object with
    `get_text_embeddings(texts) -> (y, mask)`: `T5Embedder` (bf16 features
    on the card for T5-XXL) or `PseudoT5Embedder` (f32 on the CPU); either
    is moved to `device` and the model casts y to its compute dtype. None
    takes precomputed `y` / `y_mask`. vae: a port `AutoencoderKL`, or None
    to return latents.
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

    # sampler name -> the method that builds its guided trajectory; lcm and dmd run
    # unguided on the prompts' captions
    GUIDED = {"dpm-solver": "_build_dpm", "deis": "_build_deis",
              "sde-dpm-solver": "_build_sde_dpm", "sa-solver": "_build_sa",
              "iddpm": "_build_iddpm"}
    SAMPLERS = (*GUIDED, "lcm", "dmd")

    def encode_prompts(self, prompts: Sequence[str]):
        if self.t5 is None:
            raise ValueError("pipeline built without a text encoder")
        y, mask = self.t5.get_text_embeddings(list(prompts))
        return y.to(self.device), mask.to(self.device)

    def _latents_to_images(self, latents: torch.Tensor) -> np.ndarray:
        if self.vae is None:
            return latents.cpu().numpy()
        return decode_to_uint8(self.vae, latents / self.scale_factor)

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
        noise_fn: Optional[NoiseFn] = None,
    ) -> np.ndarray:
        """Generate images [B, H, W, 3] uint8 (or latents [B, H/8, W/8, 4]).
        Prompts may carry `--ar h:w` / `--hw h:w` flags. `noise_fn(k, shape)`
        replaces the seeded generator's per-step draws."""
        if sampler not in self.SAMPLERS:
            raise ValueError(f"unknown sampler {sampler}")
        if block_cache_interval >= 2 or block_cache_threshold is not None \
                or block_cache_schedule is not None:
            raise NotImplementedError(
                "block caching is not ported yet (ROADMAP.md, Queue 1 item 7: block cache "
                "and int8)")
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

        gen = torch.Generator(device=dev).manual_seed(seed)
        if latents is not None:
            if tuple(latents.shape) != (B, h, w, 4):
                raise ValueError(f"latents {tuple(latents.shape)} != {(B, h, w, 4)}")
            x = latents.to(dev, torch.float32)
        else:
            x = torch.randn((B, h, w, 4), generator=gen, device=dev, dtype=torch.float32)
        noise_fn = noise_fn or generator_noise(gen)
        if sampler == "lcm":
            out = self._build_lcm(num_inference_steps)(x, y, y_mask, img_hw, aspect, noise_fn)
        elif sampler == "dmd":
            out = self._build_dmd()(x, y, y_mask, img_hw, aspect)
        else:
            run = getattr(self, self.GUIDED[sampler])(num_inference_steps, guidance_scale)
            out = run(x, y, null_y, mask_full, img_hw, aspect, noise_fn)
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

    def _cfg_model_fn(self, y, null_y, mask, img_hw, aspect, cfg_scale):
        """The guided continuous-time noise predictor over the CFG batch
        [uncond, cond], caption K/V hoisted."""
        kvs = self._hoisted_kv(torch.cat([null_y, y], dim=0))
        apply_fn = lambda xi, t, c: self._apply_eps(xi, t, c, mask, img_hw, aspect, cross_kv=kvs)
        return make_cfg_model_fn(apply_fn, self.ns, condition=y, uncondition=null_y,
                                 cfg_scale=cfg_scale)

    def _build_dpm(self, steps: int, cfg_scale: float):
        def run(x, y, null_y, mask, img_hw, aspect, noise_fn):
            model_fn = self._cfg_model_fn(y, null_y, mask, img_hw, aspect, cfg_scale)
            solver = DPMSolver(model_fn, self.ns, algorithm_type="dpmsolver++")
            return solver.sample(x, steps=steps, order=2, method="multistep")

        return run

    def _build_deis(self, steps: int, cfg_scale: float):
        def run(x, y, null_y, mask, img_hw, aspect, noise_fn):
            model_fn = self._cfg_model_fn(y, null_y, mask, img_hw, aspect, cfg_scale)
            return DEISMultistep(model_fn, self.ns).sample(x, steps=steps, order=2)

        return run

    def _build_sde_dpm(self, steps: int, cfg_scale: float):
        def run(x, y, null_y, mask, img_hw, aspect, noise_fn):
            model_fn = self._cfg_model_fn(y, null_y, mask, img_hw, aspect, cfg_scale)
            solver = DPMSolver(model_fn, self.ns, algorithm_type="sde-dpmsolver++")
            return solver.sample_sde(x, noise_fn, steps=steps, order=2)

        return run

    def _build_sa(self, steps: int, cfg_scale: float):
        def run(x, y, null_y, mask, img_hw, aspect, noise_fn):
            model_fn = self._cfg_model_fn(y, null_y, mask, img_hw, aspect, cfg_scale)
            solver = SASolver(model_fn, self.ns, algorithm_type="data_prediction")
            tau = lambda t: 1.0 if 0.2 <= t <= 0.8 else 0.0
            return solver.sample("few_steps", x, tau, steps, noise_fn, predictor_order=2,
                                 corrector_order=2, pc_mode="PEC")

        return run

    def _build_iddpm(self, steps: int, cfg_scale: float):
        """Ancestral sampling over `steps` respaced timesteps, as the JAX
        pipeline runs it: the CFG batch is [cond, uncond] (upstream
        forward_with_cfg) while the mask stays [null, cond], so the cond half
        runs under the negative prompt's mask (ROADMAP.md, Queue 3); guidance
        covers eps channels 0-2, and channel 3 and the variance channels come
        from the cond half; no clipping of x0."""
        diffusion = IDDPM(timestep_respacing=str(steps), learn_sigma=True).to(self.device)

        def run(x, y, null_y, mask, img_hw, aspect, noise_fn):
            B = x.shape[0]
            y_full = torch.cat([y, null_y], dim=0)
            kvs = self._hoisted_kv(y_full)
            kwargs = {}
            if self.model.cfg.micro_condition:
                kwargs = dict(img_hw=img_hw.repeat(2, 1), aspect_ratio=aspect.repeat(2, 1))

            def model_fn(x_t, t_vec):
                out = self.model(torch.cat([x_t, x_t], dim=0), torch.cat([t_vec, t_vec]),
                                 y_full, mask, cross_kv=kvs, **kwargs)
                eps, rest = out[..., :3], out[..., 3:]
                cond_eps, uncond_eps = eps.chunk(2, dim=0)
                half = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
                return torch.cat([half, rest[:B]], dim=-1)

            return diffusion.p_sample_loop(model_fn, x, noise_fn, clip_denoised=False)

        return run

    def _micro(self, img_hw, aspect) -> dict:
        if not self.model.cfg.micro_condition:
            return {}
        return dict(img_hw=img_hw, aspect_ratio=aspect)

    def _build_dmd(self, start_ts: int = 400):
        """The one-NFE DMD generator: x0 from one eps prediction at t = 400,
        alpha-bar computed on the host in f64."""
        acp = float(np.cumprod(1.0 - self.betas)[start_ts])

        def run(x, y, y_mask, img_hw, aspect):
            t_vec = torch.full((x.shape[0],), float(start_ts), dtype=torch.float32,
                               device=x.device)
            eps = self.model(x, t_vec, y, y_mask, **self._micro(img_hw, aspect))[..., :4]
            return (x - (1 - acp) ** 0.5 * eps) / acp**0.5

        return run

    def _build_lcm(self, steps: int):
        """LCM: unguided, the B prompts' captions through the embedder
        (no hoisted K/V); returns the last denoised estimate."""
        scheduler = LCMScheduler()

        def run(x, y, y_mask, img_hw, aspect, noise_fn):
            micro = self._micro(img_hw, aspect)
            model_fn = lambda x_t, t_vec: self.model(x_t, t_vec, y, y_mask, **micro)[..., :4]
            return scheduler.sample(model_fn, x, noise_fn, num_inference_steps=steps)

        return run
