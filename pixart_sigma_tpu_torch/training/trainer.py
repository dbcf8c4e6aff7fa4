"""The training loop: config -> data -> (sharded) steps -> checkpoints.

Port of pixart_sigma_tpu/training/trainer.py: the iDDPM loss
with the learned range variance (optionally the SNR-switching objective,
Min-SNR-gamma weights, masked-token training), uniform or
loss-second-moment timestep sampling, the global-norm clip, CAME, Lion or
AdamW under the config's LR schedule (auto-scaled with the batch) with the
`no_weight_decay_on` exemptions, gradient accumulation with the semantics
of `optax.MultiSteps`, EMA with warmup, the balanced bucket sampler,
windowed metric logging with the NaN watchdog's report, periodic validation
sampling on the EMA weights, and `.pth` checkpoints in the upstream dialect
from which a run resumes where it stopped. Runs on the card unless
`device="cpu"`; without a card it raises. Batches of images and prompts
(`load_vae_feat` / `load_t5_feat` False) are encoded on the fly by the
VAE and the T5 encoder given to the Trainer.

Over torch.distributed's ranks (`parallel.dist.initialize_distributed`,
one card each) the config's `mesh`, `use_fsdp`, `use_tensor_parallel` and
`fsdp_min_size` shard the run as the JAX trainer's GSPMD step does
(`parallel.mesh`): `train_batch_size` is the batch of one rank, and the
global batch, split over the data x fsdp ranks, gives what one rank would
compute at the global batch. Checkpoints stay the upstream `.pth` with
whole tensors, written by rank 0, so a run saved on R ranks resumes on
any number. A `seq` axis splits the tokens of each image over the ranks of
a seq group (`parallel.mesh.SeqContext`), beside data, fsdp and tensor: the
ranks of a tensor group share their token shard. `loader_processes` reads
with a process pool. The training CLI is
`pixart_sigma_tpu_torch.scripts.train`; `main` here is the same CLI.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from pixart_sigma_tpu_torch.config import Config, read_config
from pixart_sigma_tpu_torch.data.aspect import aspect_ratio_table
from pixart_sigma_tpu_torch.data.datasets import PixArtDataset, PixArtMSDataset
from pixart_sigma_tpu_torch.data.loader import DataLoader
from pixart_sigma_tpu_torch.data.sampler import (
    AspectRatioBatchSampler,
    BalancedAspectRatioBatchSampler,
    ShardedBatchSampler,
    SimpleBatchSampler,
)
from pixart_sigma_tpu_torch.diffusion.dpm_solver import (
    DPMSolver,
    NoiseScheduleVP,
    make_cfg_model_fn,
)
from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
from pixart_sigma_tpu_torch.diffusion.schedules import named_beta_schedule
from pixart_sigma_tpu_torch.diffusion.timestep_sampler import create_named_schedule_sampler
from pixart_sigma_tpu_torch.models.builder import build_model_from_config
from pixart_sigma_tpu_torch.models.pixart import init_weights, set_seq_parallel
from pixart_sigma_tpu_torch.models.vae import posterior_sample
from pixart_sigma_tpu_torch.parallel import mesh as mesh_lib
from pixart_sigma_tpu_torch.parallel.dist import (
    all_gather_tensor,
    is_main_process,
    sync_global_devices,
)
from pixart_sigma_tpu_torch.parallel.sharded import full_state, local, shard_dims, take_shard
from pixart_sigma_tpu_torch.pipelines.pipeline import decode_to_uint8
from pixart_sigma_tpu_torch.training.lr_schedule import build_lr_schedule
from pixart_sigma_tpu_torch.training.optim import (
    auto_scale_lr,
    block_stacks,
    build_optimizer,
    optimizer_state_from_jax,
)
from pixart_sigma_tpu_torch.training.train_state import TrainState
from pixart_sigma_tpu_torch.training.train_step import train_step
from pixart_sigma_tpu_torch.utils import orbax
from pixart_sigma_tpu_torch.utils.checkpoint import (
    jax_param_path,
    latest_checkpoint,
    load_checkpoint,
    repartition_scan_params,
    save_pth,
    state_dict_from_jax,
)
from pixart_sigma_tpu_torch.utils.debug import (
    find_nonfinite,
    first_bad_module,
    format_health_report,
    format_overflow_report,
)
from pixart_sigma_tpu_torch.utils.device import resolve_device
from pixart_sigma_tpu_torch.utils.logging import LogBuffer, MetricsWriter, Tracker, get_logger
from pixart_sigma_tpu_torch.utils.png import write_png

_MS_TYPES = ("PixArtMSDataset", "InternalDataMS", "InternalDataMSSigma")
_FSDP_MIN_SIZE = 2**16  # the JAX trainer's default


def _needs_ranks(config: Config) -> Optional[str]:
    """The first parallelism key set away from its default, or None: those
    act on torch.distributed's ranks."""
    mesh = config.get("mesh") or {}
    for axis, size in mesh.items():
        if size not in (1, -1, None):
            return f"mesh {axis}={size}"
    for key in ("use_fsdp", "use_tensor_parallel"):
        if config.get(key, False):
            return f"{key}=True"
    if config.get("fsdp_min_size", _FSDP_MIN_SIZE) != _FSDP_MIN_SIZE:
        return f"fsdp_min_size={config.fsdp_min_size}"
    return None


def build_dataset(config: Config):
    data_cfg = dict(config.data)
    type_name = data_cfg.pop("type", "PixArtDataset")
    data_cfg.pop("transform", None)
    root = os.path.join(config.get("data_root", ""), data_cfg.pop("root", ""))
    common = dict(resolution=config.image_size, max_length=config.model_max_length,
                  real_prompt_ratio=config.get("real_prompt_ratio", 1.0),
                  seed=config.get("seed", 0))
    common.update(data_cfg)
    if config.get("multi_scale") and type_name in _MS_TYPES:
        return PixArtMSDataset(root, aspect_ratio_type=config.aspect_ratio_type or config.image_size,
                               **common)
    return PixArtDataset(root, **common)


class Trainer:
    """config -> data -> steps -> checkpoints, on one device or sharded over
    the ranks of an initialised process group.

    `vae` (a port `AutoencoderKL`) encodes image-mode batches
    (`load_vae_feat=False`) and turns validation latents into PNGs; without
    it validation latents are saved as .npy. `t5` (a `T5Embedder`, or any
    object with `get_text_embeddings(texts) -> (y, mask)`) encodes
    prompt-mode batches (`load_t5_feat=False`). `history` keeps one record
    per micro-step: the step, the batch's latent (height, width), the host
    seconds of the step (it ends in a device sync, when the metrics are
    read) and the metrics.

    Random draws: t (uniform or from the resampler), the noise, the token
    mask and the caption drops come from `generator` (seeded with seed + 1)
    in that order. Its state, the resampler's ring and the accumulator are
    saved in each checkpoint, so a resumed run draws what an uninterrupted
    one would. Every rank draws the same global numbers (`train_step`), so
    one generator state serves every world size.

    With a process group the model is sharded by `parallel.mesh.shard_model`
    over the config's mesh (DDP when only the batch is split); without one,
    the parallelism keys away from their defaults raise."""

    def __init__(self, config: Config, work_dir: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda", vae=None, t5=None):
        if not dist.is_initialized() and _needs_ranks(config):
            raise RuntimeError(
                f"{_needs_ranks(config)} acts on torch.distributed's ranks, and no process "
                "group is initialised: start the run under torchrun, or call "
                "pixart_sigma_tpu_torch.parallel.dist.initialize_distributed first")
        self.device = resolve_device(device)
        self.config = config
        self.vae = vae
        self.t5 = t5
        self.work_dir = work_dir or config.work_dir
        os.makedirs(self.work_dir, exist_ok=True)
        if is_main_process():
            config.dump(os.path.join(self.work_dir, "config.py.dump"))
        self.logger = get_logger(self.work_dir)
        self.metrics = MetricsWriter(self.work_dir)
        self.tracker = Tracker(self.work_dir, config.get("report_to"))
        self.model = build_model_from_config(config, device=self.device, train=True)
        init_weights(self.model, torch.Generator(device=self.device).manual_seed(config.seed))
        if config.get("load_from"):
            self.logger.info(f"loading weights from {config.load_from}")
            load_checkpoint(config.load_from, self.model)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"model params: {n_params / 1e6:.1f} M on {self.device}")
        self.mesh, self.batch_group, self.batch_ranks, self.batch_rank = None, None, 1, 0
        self.seq = None
        self._forward, self._sync_params, self._sharded = self.model, set(), False
        self._plain_model = None  # an unsharded copy for validation sampling
        if dist.is_initialized():
            self._shard(config)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed + 1)
        self.diffusion = IDDPM(timestep_respacing=[config.train_sampling_steps],
                               learn_sigma=True, rescale_learned_sigmas=True,
                               snr=config.get("snr_loss", False))
        name = config.get("schedule_sampler")
        self.schedule_sampler = None
        if name and name != "uniform":  # uniform is the step's own draw
            self.schedule_sampler = create_named_schedule_sampler(
                name, self.diffusion.num_timesteps, device=self.device)
        opt_cfg = dict(config.optimizer)
        if config.get("auto_lr"):  # by the world batch: per-rank batch x batch ranks
            self._base_lr, self.lr_scale_ratio = auto_scale_lr(
                opt_cfg.pop("lr"), config.train_batch_size * self.batch_ranks,
                rule=config.auto_lr["rule"])
        else:
            self._base_lr, self.lr_scale_ratio = opt_cfg.pop("lr"), 1.0
        self._opt_cfg = opt_cfg
        self.state: Optional[TrainState] = None
        self.history: List[Dict[str, Any]] = []

    def _shard(self, config: Config) -> None:
        """The mesh over the world's ranks and the model sharded on it."""
        fsdp, tensor = config.get("use_fsdp", False), config.get("use_tensor_parallel", False)
        self.mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**(config.get("mesh") or {})),
                                        self.device.type)
        self.batch_group = mesh_lib.batch_group(self.mesh)
        self.batch_ranks = mesh_lib.batch_ranks(self.mesh)
        self.batch_rank = mesh_lib.batch_rank(self.mesh)
        self.seq = mesh_lib.seq_context(self.mesh)
        # the attention modules keep their seq context when tensor
        # parallelism swaps their linears' weights for DTensors
        set_seq_parallel(self.model, self.seq)
        self._forward, self._sync_params = mesh_lib.shard_model(
            self.model, self.mesh, fsdp=fsdp, tensor=tensor,
            min_size=config.get("fsdp_min_size", _FSDP_MIN_SIZE), batch_group=self.batch_group)
        self._sharded = fsdp or tensor
        sizes = dict(zip(mesh_lib.AXES, self.mesh.mesh.shape))
        self.logger.info(f"mesh: {sizes}, use_fsdp={fsdp}, use_tensor_parallel={tensor}, "
                         f"batch rank {self.batch_rank} of {self.batch_ranks}")

    def build_state(self, total_steps: int) -> TrainState:
        """The LR schedule over `total_steps`, the optimizer (parameters whose
        JAX path holds a `no_weight_decay_on` substring get no weight decay;
        CAME factors the scan groups' stacked leaves when the model's
        `scan_blocks` is set, as the JAX trainer's tree has them) and the
        EMA."""
        cfg = self.config
        schedule = build_lr_schedule(cfg.lr_schedule, self._base_lr,
                                     num_training_steps=total_steps,
                                     lr_scale_ratio=self.lr_scale_ratio,
                                     **cfg.get("lr_schedule_args", {}))
        opt_cfg = dict(self._opt_cfg)
        skip_decay = None
        no_decay = cfg.get("no_weight_decay_on")
        if no_decay:
            mcfg = self.model.cfg
            skip_decay = lambda n: any(s in jax_param_path(n, mcfg) for s in no_decay)
        named = list(self.model.named_parameters())
        mcfg = self.model.cfg
        # the JAX trainer's tree: a scan group's leaves stacked when scan_blocks
        stacks = (block_stacks([n for n, _ in named], mcfg.block_groups())
                  if mcfg.scan_blocks else None)
        optimizer = build_optimizer(named, name=opt_cfg.pop("type"), lr=schedule(0),
                                    skip_decay=skip_decay, stacks=stacks, **opt_cfg)
        self.state = TrainState(self.model, optimizer, schedule, ema=True,
                                ema_rate=cfg.ema_rate, ema_warmup=cfg.get("ema_warmup", True),
                                accumulation_steps=cfg.get("gradient_accumulation_steps", 1))
        self.state.forward = self._forward
        self.state.sync_params = [p for p in self.model.parameters() if p in self._sync_params]
        self.state.batch_group = self.batch_group
        self.state.seq_group = None if self.seq is None else self.seq.group
        self.state.batch_ranks, self.state.batch_rank = self.batch_ranks, self.batch_rank
        return self.state

    def maybe_resume(self) -> int:
        """Restore the checkpoint `resume_from.checkpoint` names ("latest": the
        newest of this run's, `.pth` or orbax `step_N`) and return its step,
        or 0. `load_ema` starts the weights from the EMA, `resume_optimizer`
        and `resume_lr_scheduler` (the LR schedule's position) restore those,
        as upstream. The whole tensors of the checkpoint are cut to this
        rank's shards. A JAX trainer's orbax checkpoint (a `step_N`,
        `checkpoints/` or run directory) restores params, EMA, optimizer
        state and step as its `restore_train_state` does (`_resume_orbax`)."""
        opts = self.config.get("resume_from") or {}
        path = opts.get("checkpoint")
        if path == "latest":
            path = latest_checkpoint(os.path.join(self.work_dir, "checkpoints"))
        if not path:
            return 0
        self.logger.info(f"resuming from {path}")
        if os.path.isdir(path):
            return self._resume_orbax(path, opts)
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        ema = ckpt.get("state_dict_ema")
        weights = ema if opts.get("load_ema", False) and ema is not None else ckpt["state_dict"]
        self.load_weights(weights)
        if self.state.ema is not None:
            self.state.load_full_ema(ema or weights)
        self.state.load_state_dict(ckpt["train_state"])
        if opts.get("resume_optimizer", True):
            self.state.optimizer.load_full_state_dict(ckpt["optimizer"])
        if not opts.get("resume_lr_scheduler", True):
            self.state.opt_step = 0
        self.generator.set_state(ckpt["generator"])
        if self.schedule_sampler is not None and "schedule_sampler" in ckpt:
            self.schedule_sampler.load_state_dict(ckpt["schedule_sampler"])
        return self.state.step

    def _resume_orbax(self, path: str, opts: Dict[str, Any]) -> int:
        """Resume from the JAX trainer's orbax checkpoint at `path`: params,
        EMA (or the params without one), the optax state
        (`optimizer_state_from_jax`: moments, schedule position, a partly
        filled accumulator) and the step. JAX saves no torch generator and no
        resampler ring: the generator is seeded from (seed, step) through
        numpy's SeedSequence, and the ring starts empty, as JAX's restore
        leaves its own."""
        step_dir = orbax.resolve_step_dir(path)
        cfg = self.model.cfg
        jax_tree = lambda key: repartition_scan_params(orbax.read_tree(step_dir, key), cfg)
        params = state_dict_from_jax(jax_tree("params"), cfg)
        ema = (state_dict_from_jax(jax_tree("ema_params"), cfg)
               if orbax.leaves(step_dir, "ema_params") else None)
        self.load_weights(ema if opts.get("load_ema", False) and ema is not None else params)
        if self.state.ema is not None:
            self.state.load_full_ema(ema or params)
        step = int(orbax.read_tree(step_dir, "step"))
        jax_opt = optimizer_state_from_jax(
            orbax.read_tree(step_dir, "opt_state"), self.state.optimizer,
            list(self.model.named_parameters()), cfg, self.state.accumulation_steps)
        if jax_opt.mini_step != step % self.state.accumulation_steps:
            raise ValueError(f"{step_dir}: MultiSteps mini_step {jax_opt.mini_step} at step "
                             f"{step} with {self.state.accumulation_steps} accumulation steps")
        self.state.load_state_dict({"step": step, "opt_step": jax_opt.opt_step,
                                    "grad_accumulator": jax_opt.accumulator})
        if opts.get("resume_optimizer", True):
            self.state.optimizer.load_full_state_dict(jax_opt.state_dict)
        if not opts.get("resume_lr_scheduler", True):
            self.state.opt_step = 0
        seed = np.random.SeedSequence([self.config.seed, step]).generate_state(1)[0]
        self.generator.manual_seed(int(seed))
        return step

    @torch.no_grad()
    def load_weights(self, weights: Dict[str, torch.Tensor]) -> None:
        """Whole weights (every key of the model) into this rank's shards."""
        params = dict(self.model.named_parameters())
        if set(weights) != set(params):
            raise KeyError(f"checkpoint keys differ from the model's: missing "
                           f"{sorted(set(params) - set(weights))[:4]}, unexpected "
                           f"{sorted(set(weights) - set(params))[:4]}")
        for n, p in params.items():
            local(p).copy_(take_shard(weights[n], shard_dims(p)))

    def build_loader(self) -> DataLoader:
        """The global batch sampler (at the per-rank batch x batch ranks),
        of which each rank keeps its slice."""
        cfg = self.config
        dataset = build_dataset(cfg)
        global_bs = cfg.train_batch_size * self.batch_ranks
        if cfg.get("multi_scale"):
            cls = (BalancedAspectRatioBatchSampler if cfg.get("balanced_sampler")
                   else AspectRatioBatchSampler)
            sampler = cls(dataset, global_bs,
                          aspect_ratio_table(cfg.aspect_ratio_type or cfg.image_size),
                          valid_num=cfg.get("valid_num", 0), seed=cfg.seed)
        else:
            sampler = SimpleBatchSampler(len(dataset), global_bs, seed=cfg.seed, dataset=dataset)
        if self.batch_ranks > 1:
            sampler = ShardedBatchSampler(sampler, cfg.train_batch_size, self.batch_ranks,
                                          self.batch_rank)
        return DataLoader(dataset, sampler, num_workers=cfg.get("num_workers", 4),
                          use_processes=cfg.get("loader_processes", False))

    @torch.no_grad()
    def _encode_images(self, images, step: int,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """On-the-fly VAE encoding of image-mode batches [B, H, W, 3]: the
        posterior sample mean + exp(logvar / 2) eps when the config's
        `sample_posterior` (default True), else the mean. eps comes from a
        generator on the device seeded from (seed, step), and the batch rank
        when the batch is split (as JAX folds in the process index: each
        slice of the batch draws its own; ranks of one tensor group share
        their rows and their draw), so a resumed run draws what an
        uninterrupted one would, and never from the trainer's own
        generator; `noise` gives it instead."""
        if self.vae is None:
            raise ValueError("the dataset yields images (load_vae_feat=False) but the Trainer "
                             "has no VAE: pass vae= or train on precomputed features")
        x = torch.from_numpy(np.asarray(images, np.float32)).to(self.device)
        mean, logvar = self.vae.encode(x)
        if not self.config.get("sample_posterior", True):
            return mean.float()
        if noise is None:
            key = [self.config.seed, step] + ([self.batch_rank] if self.batch_ranks > 1 else [])
            seed = int(np.random.SeedSequence(key).generate_state(1)[0])
            gen = torch.Generator(device=self.device).manual_seed(seed)
            noise = torch.randn(mean.shape, generator=gen, device=self.device)
        return posterior_sample(mean, logvar, noise).float()

    def prepare_batch(self, batch: Dict[str, Any], step: int = 0,
                      noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """A loader batch on the device: latents (encoded by the VAE from
        `image` when the batch has no `latents`, with `_encode_images`'s
        draw at `step` or `noise`) times the scale factor, and the captions
        (from the T5 encoder's `get_text_embeddings(prompt)`, mask included,
        when the batch has no `y`)."""
        to = lambda a: torch.from_numpy(np.asarray(a)).to(self.device, non_blocking=True)
        if "latents" in batch:
            latents = to(np.asarray(batch["latents"], np.float32) * self.config.scale_factor)
        else:
            latents = self._encode_images(batch["image"], step, noise) * self.config.scale_factor
        if "y" in batch:
            y, y_mask = to(batch["y"]), to(batch["y_mask"])
        else:
            if self.t5 is None:
                raise ValueError("the dataset yields prompts (load_t5_feat=False) but the "
                                 "Trainer has no T5 encoder: pass t5= or train on features")
            y, y_mask = self.t5.get_text_embeddings(list(batch["prompt"]))
            y, y_mask = y.to(self.device), y_mask.to(self.device)
        out = {"latents": latents, "y": y, "y_mask": y_mask}
        if self.model.cfg.micro_condition:
            out["img_hw"], out["aspect_ratio"] = to(batch["img_hw"]), to(batch["aspect_ratio"])
        return out

    def train(self, max_steps: Optional[int] = None) -> TrainState:
        """Run `max_steps` micro-steps from where the state (or the resumed
        checkpoint) stands, or to the end of the configured epochs."""
        cfg = self.config
        loader = self.build_loader()
        steps_per_epoch = cfg.get("steps_per_epoch") or len(loader)
        start_step = 0
        if self.state is None:
            self.build_state(steps_per_epoch * cfg.num_epochs)
            start_step = self.maybe_resume()
        else:
            start_step = self.state.step
        # a resumed run restarts inside the epoch it stopped in
        start_epoch = start_step // steps_per_epoch
        if start_step:
            loader.skip_batches = start_step % steps_per_epoch
            self.logger.info(f"resume fast-forward: epoch {start_epoch}, skipping "
                             f"{loader.skip_batches} batches")
        buf = LogBuffer()
        step = start_step
        mask_loss_coef = cfg.get("mask_loss_coef", 0.0) if self.model.cfg.mask_ratio > 0 else 0.0
        for epoch in range(start_epoch, cfg.num_epochs):
            loader.batch_sampler.set_epoch(epoch)
            for batch in loader:
                batch_dev = self.prepare_batch(batch, self.state.step)
                t0 = time.perf_counter()
                metrics = train_step(self.state, self.diffusion, batch_dev,
                                     generator=self.generator, grad_clip=cfg.get("gradient_clip"),
                                     schedule_sampler=self.schedule_sampler,
                                     snr_gamma=cfg.get("snr_gamma"),
                                     mask_loss_coef=mask_loss_coef)
                seconds = time.perf_counter() - t0
                step = self.state.step
                hw = tuple(batch_dev["latents"].shape[1:3])
                self.history.append(dict(metrics, step=step, hw=hw, seconds=seconds))
                buf.update(dict(metrics, seconds=seconds))
                if step % cfg.log_interval == 0 or not np.isfinite(metrics["loss"]):
                    buf.average()
                    self._log(epoch, step, buf.output, batch_dev)
                    buf.clear()
                if cfg.save_model_steps and step % cfg.save_model_steps == 0:
                    self.save(step, epoch)
                if (cfg.get("visualize") and cfg.get("eval_sampling_steps")
                        and step % cfg.eval_sampling_steps == 0):
                    self.log_validation(step, batch_dev)
                if max_steps and step - start_step >= max_steps:
                    return self.state
            loader.skip_batches = 0  # the fast-forward applies to one epoch
            if (epoch + 1) % cfg.get("save_model_epochs", 1) == 0:
                self.save(step, epoch + 1)
        return self.state

    def _log(self, epoch: int, step: int, avg: Dict[str, float],
             batch_dev: Dict[str, torch.Tensor]) -> None:
        self.logger.info(f"epoch {epoch} step {step}: " + " ".join(
            f"{k}={v:.4g}" for k, v in avg.items()))
        self.metrics.write(step, avg)
        self.tracker.add_scalars(step, avg)
        if np.isfinite(avg["loss"]):
            return
        # the NaN watchdog: parameter health (of this rank's shards), then
        # the first module whose output overflows in one forward of this
        # batch (every rank sees the global loss, so every rank runs it)
        params = {n: local(p) for n, p in self.model.named_parameters()}
        self.logger.error(f"non-finite loss at step {step}; parameter health:\n"
                          + format_health_report(params))
        bad = find_nonfinite(params)
        B = batch_dev["latents"].shape[0]
        t = torch.full((B,), 500, device=self.device)
        self.logger.error(format_overflow_report(first_bad_module(self.model, lambda: self.model(
            batch_dev["latents"], t, batch_dev["y"], batch_dev.get("y_mask"),
            batch_dev.get("img_hw"), batch_dev.get("aspect_ratio")))))
        raise FloatingPointError(f"non-finite loss at step {step}; non-finite params {bad[:8]}")

    @torch.no_grad()
    def log_validation(self, step: int, batch_dev: Dict[str, torch.Tensor],
                       noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """DPM-Solver++ (14 steps, order 2, CFG `cfg_scale`) on the EMA
        weights for the batch's first two captions against the learned null
        caption; the noise is drawn from a generator seeded with `seed`
        (deterministic_validation) or the step, unless given. Writes
        validation_step_<step>_<i>.png through the VAE, or
        validation_step_<step>.npy without one; returns the latents divided
        by the scale factor. Sharded, every rank gathers the global batch's
        first captions and the whole weights and samples with an unsharded
        copy of the model; rank 0 writes."""
        cfg = self.config
        ns = NoiseScheduleVP("discrete",
                             betas=named_beta_schedule("linear", cfg.train_sampling_steps))
        if self.batch_ranks > 1:  # the global batch's first captions, as JAX's
            batch_dev = {k: all_gather_tensor(batch_dev[k], self.batch_group)
                         for k in ("latents", "y", "y_mask")}
        latents = batch_dev["latents"]
        n = min(2, latents.shape[0])
        model, weights = self._sampling_weights()
        y = batch_dev["y"][:n]
        mask = torch.cat([batch_dev["y_mask"][:n]] * 2, dim=0)
        null_y = weights["y_embedder.y_embedding"][None].expand(y.shape).to(y.dtype)
        apply_fn = lambda x, t, c: torch.func.functional_call(
            model, weights, (x, t, c, mask))[..., :4]
        model_fn = make_cfg_model_fn(apply_fn, ns, condition=y, uncondition=null_y,
                                     cfg_scale=cfg.get("cfg_scale", 4.5))
        if noise is None:
            seed = cfg.seed if cfg.get("deterministic_validation") else step
            gen = torch.Generator(device=self.device).manual_seed(seed)
            noise = torch.randn(latents[:n].shape, generator=gen, device=self.device)
        out = DPMSolver(model_fn, ns).sample(noise.to(self.device), steps=14, order=2)
        out = out / cfg.scale_factor
        if not is_main_process():
            return out.cpu().numpy()
        if self.vae is not None:
            imgs = decode_to_uint8(self.vae, out)
            for i, img in enumerate(imgs):
                write_png(os.path.join(self.work_dir, f"validation_step_{step}_{i}.png"), img)
            self.tracker.add_images(step, "validation", imgs.astype(np.float32) / 255.0)
            self.logger.info(f"validation images -> {self.work_dir}/validation_step_{step}_*.png")
        else:
            path = os.path.join(self.work_dir, f"validation_step_{step}.npy")
            np.save(path, out.cpu().numpy())
            self.logger.info(f"validation latents -> {path}")
        return out.cpu().numpy()

    def _sampling_weights(self):
        """(a module, the EMA weights, or the parameters without an EMA, to
        call it with): the model and its own tensors, or when sharded an
        unsharded copy and the gathered whole tensors."""
        if not self._sharded:
            return self.model, (self.state.ema if self.state.ema is not None
                                else dict(self.model.named_parameters()))
        if self.state.ema is not None:
            full = self.state.full_ema()
        else:
            full = full_state(((n, local(p)) for n, p in self.model.named_parameters()),
                              dict(self.model.named_parameters()))
        if self._plain_model is None:
            self._plain_model = build_model_from_config(self.config, device=self.device,
                                                        train=True)
        return self._plain_model, {n: t.to(self.device) for n, t in full.items()}

    def save(self, step: int, epoch: int) -> str:
        """Write checkpoints/epoch_{epoch}_step_{step}.pth: f32 weights, EMA,
        optimizer state (which `utils.checkpoint.load_pth` reads), and the
        step counters, accumulator, generator and resampler states that
        `maybe_resume` restores. Every rank calls it: sharded tensors are
        gathered whole, and rank 0 writes."""
        path = os.path.join(self.work_dir, "checkpoints", f"epoch_{epoch}_step_{step}.pth")
        sd = self.model.state_dict()
        weights = full_state(((n, local(t)) for n, t in sd.items()), sd)
        ema = self.state.full_ema() if self.state.ema is not None else None
        optimizer = self.state.optimizer.full_state_dict()
        extra: Dict[str, Any] = {"train_state": self.state.state_dict(),
                                 "generator": self.generator.get_state()}
        if self.schedule_sampler is not None:
            extra["schedule_sampler"] = {k: v.cpu() for k, v in
                                         self.schedule_sampler.state_dict().items()}
        if is_main_process():
            save_pth(path, weights, ema, optimizer, step=step, epoch=epoch, **extra)
            self.logger.info(f"saved checkpoint: {path}")
        sync_global_devices("save")
        return path


def main(argv=None) -> None:
    """The training CLI (`pixart_sigma_tpu_torch.scripts.train`)."""
    from pixart_sigma_tpu_torch.scripts.train import main as train_main

    train_main(argv)


if __name__ == "__main__":
    main()
