"""LCM distillation training CLI.

Port of scripts/train_pixart_lcm.py: the teacher (`--teacher`, a `.pth` or
a diffusers `.safetensors`) is loaded frozen in the compute dtype, the
student and its EMA target start from the same weights, and
`training.lcm_trainer`'s step runs over the config's feature dataset with
the config's optimizer, LR schedule and clip. The unconditional caption is
the student's current learned null caption. Checkpoints
(`WORK_DIR/checkpoints/step_<n>.pth`, the target as the EMA) every
`save_model_steps`.

    python -m pixart_sigma_tpu_torch.scripts.train_pixart_lcm CONFIG --teacher M.pth \\
        [--work-dir DIR] [--max-steps N] [--device cpu]

runs on the card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="LCM distillation of PixArt")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--teacher", required=True, help="pretrained .pth/safetensors")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Returns {"state", "teacher", "history"}; each step's metrics hold its
    `seconds` on the host's clock."""
    args = parse_args(argv)
    import torch

    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.scripts.finetune_common import (
        device_batch,
        feature_loader,
        load_model,
        optimizer_for,
    )
    from pixart_sigma_tpu_torch.training.lcm_trainer import make_lcm_train_step
    from pixart_sigma_tpu_torch.training.lr_schedule import build_lr_schedule
    from pixart_sigma_tpu_torch.training.train_state import TrainState
    from pixart_sigma_tpu_torch.utils.checkpoint import save_pth
    from pixart_sigma_tpu_torch.utils.device import resolve_device
    from pixart_sigma_tpu_torch.utils.logging import get_logger

    device = resolve_device(args.device)
    config = read_config(args.config)
    if args.work_dir:
        config.work_dir = args.work_dir
    os.makedirs(config.work_dir, exist_ok=True)
    logger = get_logger(config.work_dir)

    teacher = load_model(config, args.teacher, device, train=False)
    student = load_model(config, args.teacher, device, train=True).requires_grad_(True)
    diffusion = IDDPM(timestep_respacing=[config.train_sampling_steps], learn_sigma=True)
    opt_cfg = dict(config.optimizer)
    schedule = build_lr_schedule(config.lr_schedule, opt_cfg.pop("lr"),
                                 num_training_steps=args.max_steps or 100_000,
                                 **config.get("lr_schedule_args", {}))
    optimizer = optimizer_for(student, opt_cfg.pop("type"), schedule(0), **opt_cfg)
    state = TrainState(student, optimizer, schedule, ema=True)
    step_fn = make_lcm_train_step(student.cfg, diffusion,
                                  num_ddim_timesteps=config.num_ddim_timesteps,
                                  cfg_scale=config.get("cfg_scale", 4.5),
                                  loss_type=config.loss_type, huber_c=config.huber_c,
                                  ema_decay=config.ema_decay)
    gen = torch.Generator(device=device).manual_seed(config.seed)
    loader = feature_loader(config)
    L, history = student.cfg.model_max_length, []
    for epoch in range(config.num_epochs):
        loader.batch_sampler.set_epoch(epoch)
        for batch in loader:
            dev = device_batch(batch, config, student.cfg, device)
            B = dev["latents"].shape[0]
            uncond = student.y_embedder.y_embedding.detach()[None].expand(
                B, L, student.cfg.caption_channels).float()
            t0 = time.perf_counter()
            metrics = step_fn(state, teacher, uncond, dev, generator=gen,
                              grad_clip=config.get("gradient_clip"))
            metrics["seconds"] = time.perf_counter() - t0
            history.append(metrics)
            step = state.step
            if step % config.log_interval == 0:
                logger.info(f"step {step}: loss={metrics['loss']:.4f}")
            if config.save_model_steps and step % config.save_model_steps == 0:
                save_pth(os.path.join(config.work_dir, "checkpoints", f"step_{step}.pth"),
                         student.state_dict(), state.ema, step=step)
            if args.max_steps and step >= args.max_steps:
                return {"state": state, "teacher": teacher, "history": history}
    return {"state": state, "teacher": teacher, "history": history}


if __name__ == "__main__":
    main()
