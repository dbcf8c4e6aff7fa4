"""PixArtPipeline: prompts -> uint8 images with any sampler of the JAX
pipeline.

Port of pixart_sigma_tpu/pipelines/pipeline.py. Samplers: "dpm-solver"
(20-step DPM-Solver++ by default), "deis", "sde-dpm-solver", "sa-solver"
and "iddpm" run classifier-free guidance as one 2B model call per step with
the caption K/V computed once per trajectory; "lcm" and the one-NFE "dmd"
run unguided on the B prompts. The VAE decodes one image at a time up to
128 x 128 latents (1024px) and tile by tile beyond (`models.vae.tiled_decode`:
2048px, or 4096px through the 2880 bucket table).

Delta block caching (`block_cache_interval`, `block_cache_threshold`,
`block_cache_schedule`) runs DPM-Solver++ with the model's `cache_span`
layers recomputed only on refresh steps (`_build_dpm_cached`).

The stochastic samplers take their per-step noise from `noise_fn(k, shape)`
(`diffusion/noise.py`): by default a `torch.Generator` on the device, seeded
with `seed`, which also draws the initial latents when none are given.

With a `mesh` (`parallel.mesh.build_mesh` over the initialised ranks, JAX's
pipeline `mesh`) every rank runs the call: the batch is split over the
data x fsdp ranks (every rank draws the whole batch's noise and keeps its
rows), the tokens over the seq ranks (the model's `set_seq_parallel`), and
the latents are gathered whole on every rank; the VAE decodes on rank 0,
which alone returns images (the others return None). The adaptive block
cache's drift is reduced over every rank before the host reads it, so all
take the same refresh decisions, those of the whole batch as in JAX.
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
    cfg_batch,
    cfg_guide,
    make_cfg_model_fn,
    model_time,
)
from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
from pixart_sigma_tpu_torch.diffusion.lcm import LCMScheduler
from pixart_sigma_tpu_torch.diffusion.noise import NoiseFn, generator_noise
from pixart_sigma_tpu_torch.diffusion.sa_solver import SASolver
from pixart_sigma_tpu_torch.diffusion.schedules import named_beta_schedule
from pixart_sigma_tpu_torch.models.pixart import precompute_cross_kv, set_seq_parallel
from pixart_sigma_tpu_torch.models.vae import tiled_decode
from pixart_sigma_tpu_torch.parallel.dist import all_gather_tensor, mean_abs_ratio
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
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.t5 = t5
        self.vae = vae
        self.scale_factor = scale_factor
        self.betas = named_beta_schedule(beta_schedule, num_train_timesteps)
        self.ns = NoiseScheduleVP("discrete", betas=self.betas)
        self.base_resolution = base_resolution
        self.mesh, self.batch_group, self.batch_ranks, self.batch_rank = mesh, None, 1, 0
        if mesh is not None:
            from pixart_sigma_tpu_torch.parallel import mesh as mesh_lib

            set_seq_parallel(model, mesh_lib.seq_context(mesh))
            self.batch_group = mesh_lib.batch_group(mesh)
            self.batch_ranks, self.batch_rank = mesh_lib.batch_ranks(mesh), mesh_lib.batch_rank(mesh)

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

    def _latents_to_images(self, latents: torch.Tensor) -> Optional[np.ndarray]:
        if self.mesh is not None and torch.distributed.get_rank() != 0:
            return None
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
        self.check_call(prompts, height=height, width=width,
                        num_inference_steps=num_inference_steps, sampler=sampler,
                        block_cache_interval=block_cache_interval,
                        block_cache_threshold=block_cache_threshold,
                        block_cache_schedule=block_cache_schedule)
        schedule = (None if block_cache_schedule is None
                    else tuple(sorted(set(int(i) for i in block_cache_schedule))))
        cache_on = (block_cache_interval >= 2 or block_cache_threshold is not None
                    or schedule is not None)
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
        if self.batch_ranks > 1:
            x, y, y_mask, null_y, mask_full, img_hw, aspect, noise_fn = self._rows(
                x, y, y_mask, null_y, null_mask, img_hw, aspect, noise_fn)
        if sampler == "lcm":
            out = self._build_lcm(num_inference_steps)(x, y, y_mask, img_hw, aspect, noise_fn)
        elif sampler == "dmd":
            out = self._build_dmd()(x, y, y_mask, img_hw, aspect)
        elif cache_on:
            run = self._build_dpm_cached(num_inference_steps, guidance_scale,
                                         block_cache_interval, block_cache_threshold, schedule)
            out = run(x, y, null_y, mask_full, img_hw, aspect, noise_fn)
        else:
            run = getattr(self, self.GUIDED[sampler])(num_inference_steps, guidance_scale)
            out = run(x, y, null_y, mask_full, img_hw, aspect, noise_fn)
        if self.batch_ranks > 1:
            out = all_gather_tensor(out, self.batch_group, dim=0)
        if return_latents:
            return out.cpu().numpy()
        return self._latents_to_images(out)

    def check_call(self, prompts, *, height: Optional[int] = None,
                   width: Optional[int] = None, num_inference_steps: int = 20,
                   sampler: str = "dpm-solver", block_cache_interval: int = 0,
                   block_cache_threshold: Optional[float] = None,
                   block_cache_schedule: Optional[Sequence[int]] = None, **_) -> None:
        """Raise ValueError for the arguments of a call that `__call__`
        refuses (it checks them first, before any work or collective): an
        unknown sampler, no steps, a side the patches do not tile, block
        caching off DPM-Solver++, without the model's `cache_span` or with a
        schedule that does not start at step 0 or passes the last step."""
        if sampler not in self.SAMPLERS:
            raise ValueError(f"unknown sampler {sampler}")
        if num_inference_steps < 1:
            raise ValueError(f"num_inference_steps {num_inference_steps} < 1")
        tile = 8 * self.model.cfg.patch_size
        if height is not None and width is not None and (
                self.model.cfg.multi_scale or height == width):
            if min(height, width) < tile or height % tile or width % tile:
                raise ValueError(f"{height} x {width} is not a multiple of {tile} pixels "
                                 "(the latent patches)")
        schedule = (None if block_cache_schedule is None
                    else sorted(set(int(i) for i in block_cache_schedule)))
        if block_cache_interval >= 2 or block_cache_threshold is not None or schedule is not None:
            if sampler != "dpm-solver":
                raise ValueError(f"block caching requires sampler='dpm-solver' (got {sampler!r})")
            if self.model.cfg.cache_span is None:
                raise ValueError("block caching needs a model built with cache_span "
                                 "(the turbo serving config sets (7, 21))")
            if block_cache_threshold is None and schedule is not None and (
                    schedule[:1] != [0] or schedule[-1] >= num_inference_steps):
                raise ValueError("block_cache_schedule must hold step 0 (the cache starts "
                                 f"empty) and no step past {num_inference_steps - 1}")

    def _rows(self, x, y, y_mask, null_y, null_mask, img_hw, aspect, noise_fn):
        """This batch rank's rows of the call's tensors, and a `noise_fn`
        that draws the whole batch's noise and keeps the rows."""
        B, n = x.shape[0], self.batch_ranks
        if B % n:
            raise ValueError(f"a batch of {B} does not split over {n} batch ranks of the mesh")
        rows = slice(self.batch_rank * (B // n), (self.batch_rank + 1) * (B // n))
        y, y_mask, null_y, null_mask = y[rows], y_mask[rows], null_y[rows], null_mask[rows]
        whole = noise_fn
        noise = lambda k, shape: whole(k, (shape[0] * n,) + tuple(shape[1:]))[rows]
        return (x[rows], y, y_mask, null_y, torch.cat([null_mask, y_mask], dim=0),
                img_hw[rows], aspect[rows], noise)

    def _apply_eps(self, x, t_vec, cond, mask, img_hw, aspect, cross_kv=None, **cache):
        """The model's eps channels; given `block_cache` and `use_block_cache`
        (the cached DPM-Solver++), (eps, the new cache)."""
        kwargs = {}
        if self.model.cfg.micro_condition:
            n = x.shape[0] // img_hw.shape[0]
            kwargs = dict(img_hw=img_hw.repeat(n, 1), aspect_ratio=aspect.repeat(n, 1))
        out = self.model(x, t_vec, cond, mask, cross_kv=cross_kv, **cache, **kwargs)
        if cache:
            out, new_cache = out
            return out[..., :4], new_cache
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

    def _build_dpm_cached(self, steps: int, cfg_scale: float, interval: int,
                          adaptive_threshold: Optional[float] = None,
                          schedule: Optional[Sequence[int]] = None):
        """DPM-Solver++ with delta block caching: the residual of the model's
        `cache_span` layers rides the sampler loop, recomputed on refresh
        steps and reused otherwise. Refresh policies: every `interval`-th
        model call (1 gives the uncached trajectory); the model calls listed
        in `schedule` (step 0 among them); or, with `adaptive_threshold`,
        while the drift, the sum of mean|x - x_prev| / (mean|x_prev| + 1e-8)
        since the last refresh, stays under the threshold (the first and last
        calls always refresh). The drift is an f32 tensor on the device, as
        in JAX; the decision is read back once per model call. The CFG batch,
        guidance and model time are `make_cfg_model_fn`'s helpers; the batch
        is always [uncond, cond], the cache's layout."""
        cfg = self.model.cfg
        adaptive = adaptive_threshold is not None
        if adaptive:
            refresh = np.zeros(steps, bool)
            refresh[0] = refresh[-1] = True
        elif schedule is not None:
            refresh = np.zeros(steps, bool)
            refresh[np.asarray(sorted(set(schedule)), int)] = True
        else:
            refresh = np.asarray([i % interval == 0 for i in range(steps)])
        ns = self.ns
        # every rank's drift together, so all refresh alike
        group = None if self.mesh is None else torch.distributed.group.WORLD

        def run(x, y, null_y, mask, img_hw, aspect, noise_fn):
            kvs = self._hoisted_kv(torch.cat([null_y, y], dim=0))

            def state_model_fn(xi, t_cont, state, use_cache):
                if adaptive:
                    cache, x_prev, drift = state
                    rel = mean_abs_ratio(xi - x_prev, x_prev, group)
                    drift = drift + rel
                    use_cache = use_cache and bool(drift < adaptive_threshold)
                    if not use_cache:
                        drift = torch.zeros_like(drift)
                else:
                    cache = state
                x_in, c_in = cfg_batch(xi, y, null_y)
                t_vec = model_time(ns, t_cont).to(xi.device).expand(x_in.shape[0])
                eps, cache = self._apply_eps(x_in, t_vec, c_in, mask, img_hw, aspect,
                                             cross_kv=kvs, block_cache=cache,
                                             use_block_cache=use_cache)
                guided = cfg_guide(eps, cfg_scale)
                return guided, ((cache, xi, drift) if adaptive else cache)

            p = cfg.patch_size
            n_tokens = (x.shape[1] // p) * (x.shape[2] // p)
            if self.model.seq is not None:  # the cache holds this rank's token shard
                n_tokens = self.model.seq.shard_len(n_tokens)
            state = torch.zeros((2 * x.shape[0], n_tokens, cfg.hidden_size), dtype=cfg.dtype,
                                device=x.device)
            if adaptive:
                state = (state, torch.zeros_like(x),
                         torch.zeros((), dtype=torch.float32, device=x.device))
            solver = DPMSolver(lambda *_: None, ns, algorithm_type="dpmsolver++")
            return solver.sample_scan(x, steps=steps, t_start=ns.T, t_end=1.0 / ns.total_N,
                                      order=2, state_model_fn=state_model_fn,
                                      model_state=state, refresh_mask=refresh)

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
