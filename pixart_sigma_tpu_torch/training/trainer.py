"""The single-card training loop: config -> data -> steps -> checkpoints.

Port of pixart_sigma_tpu/training/trainer.py for one device: the iDDPM loss
with the learned range variance, the global-norm clip, CAME or AdamW under
the config's LR schedule (auto-scaled with the batch), EMA with warmup,
windowed metric logging, a NaN watchdog and `.pth` checkpoints in the
upstream dialect. Runs on the card unless `device="cpu"`; without a card it
raises. Not ported yet: validation sampling, resume, multi-host and sharded
training, the loss-second-moment timestep sampler, gradient accumulation and
the SNR objectives.

    python -m pixart_sigma_tpu_torch.training.trainer CONFIG --data-root DIR \\
        --features [--max-steps N] [--work-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from pixart_sigma_tpu_torch.config import Config, read_config
from pixart_sigma_tpu_torch.data.aspect import aspect_ratio_table
from pixart_sigma_tpu_torch.data.datasets import PixArtDataset, PixArtMSDataset
from pixart_sigma_tpu_torch.data.loader import DataLoader
from pixart_sigma_tpu_torch.data.sampler import AspectRatioBatchSampler, SimpleBatchSampler
from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
from pixart_sigma_tpu_torch.models.builder import build_model_from_config
from pixart_sigma_tpu_torch.models.pixart import init_weights
from pixart_sigma_tpu_torch.training.lr_schedule import build_lr_schedule
from pixart_sigma_tpu_torch.training.optim import auto_scale_lr, build_optimizer
from pixart_sigma_tpu_torch.training.train_state import TrainState
from pixart_sigma_tpu_torch.training.train_step import train_step
from pixart_sigma_tpu_torch.utils.checkpoint import load_pth, save_pth
from pixart_sigma_tpu_torch.utils.device import resolve_device

_MS_TYPES = ("PixArtMSDataset", "InternalDataMS", "InternalDataMSSigma")


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


def _unsupported(config: Config) -> Optional[str]:
    if config.get("gradient_accumulation_steps", 1) > 1:
        return "gradient_accumulation_steps > 1"
    if config.get("schedule_sampler"):
        return "schedule_sampler"
    if (config.get("resume_from") or {}).get("checkpoint"):
        return "resume_from"
    if config.get("visualize"):
        return "validation sampling (visualize)"
    if config.get("snr_loss") or config.get("snr_gamma") is not None:
        return "the SNR objectives (snr_loss, snr_gamma)"
    return None


class Trainer:
    """config -> data -> steps -> checkpoints on one device.

    `history` keeps one record per step: the step, the batch's latent
    (height, width), the host seconds of the step (it ends in a device
    sync, when the metrics are read) and the metrics."""

    def __init__(self, config: Config, work_dir: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        missing = _unsupported(config)
        if missing:
            raise NotImplementedError(f"{missing} is not ported yet (ROADMAP.md, Queue 1)")
        self.device = resolve_device(device)
        self.config = config
        self.work_dir = work_dir or config.work_dir
        os.makedirs(self.work_dir, exist_ok=True)
        config.dump(os.path.join(self.work_dir, "config.py.dump"))
        self.logger = _logger(self.work_dir)
        self.model = build_model_from_config(config, device=self.device, train=True)
        init_weights(self.model, torch.Generator(device=self.device).manual_seed(config.seed))
        if config.get("load_from"):
            self.logger.info(f"loading weights from {config.load_from}")
            load_pth(self.model, config.load_from)
        # t, noise and caption dropout are drawn from this stream in that order
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed + 1)
        self.diffusion = IDDPM(timestep_respacing=[config.train_sampling_steps],
                               learn_sigma=True, rescale_learned_sigmas=True)
        opt_cfg = dict(config.optimizer)
        if config.get("auto_lr"):
            self._base_lr, self.lr_scale_ratio = auto_scale_lr(
                opt_cfg.pop("lr"), config.train_batch_size, rule=config.auto_lr["rule"])
        else:
            self._base_lr, self.lr_scale_ratio = opt_cfg.pop("lr"), 1.0
        self._opt_cfg = opt_cfg
        self.state: Optional[TrainState] = None
        self.history: List[Dict[str, Any]] = []
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"model params: {n_params / 1e6:.1f} M on {self.device}")

    def build_state(self, total_steps: int) -> TrainState:
        """The LR schedule over `total_steps`, the optimizer and the EMA."""
        cfg = self.config
        schedule = build_lr_schedule(cfg.lr_schedule, self._base_lr,
                                     num_training_steps=total_steps,
                                     lr_scale_ratio=self.lr_scale_ratio,
                                     **cfg.get("lr_schedule_args", {}))
        opt_cfg = dict(self._opt_cfg)
        optimizer = build_optimizer(list(self.model.named_parameters()), name=opt_cfg.pop("type"),
                                    lr=schedule(0), **opt_cfg)
        self.state = TrainState(self.model, optimizer, schedule, ema=True,
                                ema_rate=cfg.ema_rate, ema_warmup=cfg.get("ema_warmup", True))
        return self.state

    def build_loader(self) -> DataLoader:
        cfg = self.config
        dataset = build_dataset(cfg)
        if cfg.get("multi_scale"):
            sampler = AspectRatioBatchSampler(
                dataset, cfg.train_batch_size,
                aspect_ratio_table(cfg.aspect_ratio_type or cfg.image_size),
                valid_num=cfg.get("valid_num", 0), seed=cfg.seed)
        else:
            sampler = SimpleBatchSampler(len(dataset), cfg.train_batch_size, seed=cfg.seed,
                                         dataset=dataset)
        return DataLoader(dataset, sampler, num_workers=cfg.get("num_workers", 4))

    def prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        to = lambda a: torch.from_numpy(np.asarray(a)).to(self.device, non_blocking=True)
        out = {"latents": to(np.asarray(batch["latents"], np.float32) * self.config.scale_factor),
               "y": to(batch["y"]), "y_mask": to(batch["y_mask"])}
        if self.model.cfg.micro_condition:
            out["img_hw"], out["aspect_ratio"] = to(batch["img_hw"]), to(batch["aspect_ratio"])
        return out

    def train(self, max_steps: Optional[int] = None) -> TrainState:
        cfg = self.config
        loader = self.build_loader()
        steps_per_epoch = cfg.get("steps_per_epoch") or len(loader)
        if self.state is None:
            self.build_state(steps_per_epoch * cfg.num_epochs)
        window: Dict[str, List[float]] = {}
        step = self.state.step
        for epoch in range(cfg.num_epochs):
            loader.batch_sampler.set_epoch(epoch)
            for batch in loader:
                batch_dev = self.prepare_batch(batch)
                t0 = time.perf_counter()
                metrics = train_step(self.state, self.diffusion, batch_dev,
                                     generator=self.generator, grad_clip=cfg.get("gradient_clip"))
                seconds = time.perf_counter() - t0
                step = self.state.step
                hw = tuple(batch_dev["latents"].shape[1:3])
                self.history.append(dict(metrics, step=step, hw=hw, seconds=seconds))
                for k, v in metrics.items():
                    window.setdefault(k, []).append(v)
                window.setdefault("seconds", []).append(seconds)
                if step % cfg.log_interval == 0 or not np.isfinite(metrics["loss"]):
                    self._log(epoch, step, {k: float(np.mean(v)) for k, v in window.items()})
                    window = {}
                if cfg.save_model_steps and step % cfg.save_model_steps == 0:
                    self.save(step, epoch)
                if max_steps and step >= max_steps:
                    return self.state
            if (epoch + 1) % cfg.get("save_model_epochs", 1) == 0:
                self.save(step, epoch + 1)
        return self.state

    def _log(self, epoch: int, step: int, avg: Dict[str, float]) -> None:
        self.logger.info(f"epoch {epoch} step {step}: " + " ".join(
            f"{k}={v:.4g}" for k, v in avg.items()))
        with open(os.path.join(self.work_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(dict(avg, step=step, time=time.time())) + "\n")
        if not np.isfinite(avg["loss"]):  # the NaN watchdog
            bad = [n for n, p in self.model.named_parameters()
                   if not bool(torch.isfinite(p).all())]
            self.logger.error(f"non-finite loss at step {step}; non-finite params: {bad[:8]}")
            raise FloatingPointError(f"non-finite loss at step {step}; params {bad[:8]}")

    def save(self, step: int, epoch: int) -> str:
        """Write checkpoints/epoch_{epoch}_step_{step}.pth (f32 weights, EMA,
        optimizer state), which `utils.checkpoint.load_pth` reads."""
        path = os.path.join(self.work_dir, "checkpoints", f"epoch_{epoch}_step_{step}.pth")
        save_pth(path, self.model.state_dict(), self.state.ema,
                 self.state.optimizer.state_dict(), step=step, epoch=epoch)
        self.logger.info(f"saved checkpoint: {path}")
        return path


def _logger(work_dir: str) -> logging.Logger:
    logger = logging.getLogger(f"pixart_sigma_tpu_torch.trainer.{work_dir}")
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        logger.propagate = False
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s", "%H:%M:%S")
        for handler in (logging.StreamHandler(), logging.FileHandler(
                os.path.join(work_dir, "train.log"))):
            handler.setFormatter(fmt)
            logger.addHandler(handler)
    return logger


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("config")
    parser.add_argument("--work-dir")
    parser.add_argument("--data-root", help="overrides the config's data_root")
    parser.add_argument("--features", action="store_true",
                        help="read precomputed VAE and T5 features "
                             "(load_vae_feat = load_t5_feat = True)")
    parser.add_argument("--max-steps", type=int)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    config = read_config(args.config)
    if args.data_root is not None:
        config.data_root = args.data_root
    if args.features:
        config.data = dict(config.data, load_vae_feat=True, load_t5_feat=True)
    Trainer(config, args.work_dir, device=args.device).train(args.max_steps)


if __name__ == "__main__":
    main()
