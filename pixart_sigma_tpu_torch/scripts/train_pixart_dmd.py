"""DMD one-step distillation training CLI.

Port of scripts/train_pixart_dmd.py: three PixArts, the one-step generator
and the fake-score network (both starting from the teacher and trained,
each with its own optimizer, CAME or AdamW) and the frozen real-score
teacher (in `--teacher-dtype`); generator and fake-score steps alternate
over the DMD triplets of `--data-root` (written by
`tools.generate_dmd_data`). The generator's weights go to
`WORK_DIR/dmd_step_<n>.pth` every `--save-steps`.

    python -m pixart_sigma_tpu_torch.scripts.train_pixart_dmd --data-root DIR \\
        --teacher M.pth [--config CONFIG] [--batch-size 4] [--max-steps N] [--device cpu]

runs on the card unless given `--device cpu`. Without `--config` the model
is PixArtMS-XL-2 at `--image-size` with remat on.
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DMD one-step distillation of PixArt")
    p.add_argument("--data-root", required=True, help="DMD triplet dataset root")
    p.add_argument("--teacher", required=True, help="pretrained .pth/safetensors")
    p.add_argument("--config", default=None,
                   help="model config (else PixArtMS_XL_2 at --image-size)")
    p.add_argument("--work-dir", default="output/dmd")
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--max-length", type=int, default=120)
    p.add_argument("--caption-dir", default="caption_features",
                   help="caption .npz dir under data-root")
    p.add_argument("--sample-nums", type=int, default=0,
                   help=">0: train on the first N items only")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--optimizer", default="came", choices=["came", "adamw"])
    p.add_argument("--teacher-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="the frozen real-score model's weights")
    p.add_argument("--start-ts", type=int, default=400)
    p.add_argument("--cfg", type=float, default=4.5)
    p.add_argument("--max-steps", type=int, default=10000)
    p.add_argument("--save-steps", type=int, default=1000)
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def build_config(path, image_size: int, max_length: int):
    """The model config: the file at `path`, or else PixArtMS-XL-2 at
    `image_size` with remat on."""
    from pixart_sigma_tpu_torch.config import Config, read_config

    if path:
        return read_config(path)
    pe = {256: 0.5, 512: 1.0, 1024: 2.0}[image_size]
    return Config(model="PixArtMS_XL_2", image_size=image_size, pe_interpolation=pe,
                  model_max_length=max_length, grad_checkpointing=True)


def main(argv=None):
    """Returns {"generator", "fake", "real", "history"}; each step's metrics
    hold its `seconds` (generator and fake-score step) on the host's clock."""
    args = parse_args(argv)
    import torch

    from pixart_sigma_tpu_torch.data.dmd_dataset import DMDDataset
    from pixart_sigma_tpu_torch.data.loader import DataLoader
    from pixart_sigma_tpu_torch.data.sampler import SimpleBatchSampler
    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.scripts.finetune_common import (
        load_model,
        optimizer_for,
    )
    from pixart_sigma_tpu_torch.training.dmd import make_dmd_train_steps
    from pixart_sigma_tpu_torch.training.lora import adamw
    from pixart_sigma_tpu_torch.utils.checkpoint import save_pth
    from pixart_sigma_tpu_torch.utils.device import resolve_device
    from pixart_sigma_tpu_torch.utils.logging import get_logger

    device = resolve_device(args.device)
    os.makedirs(args.work_dir, exist_ok=True)
    logger = get_logger(args.work_dir)
    config = build_config(args.config, args.image_size, args.max_length)
    gen_model = load_model(config, args.teacher, device, train=True).requires_grad_(True)
    fake_model = load_model(config, args.teacher, device, train=True).requires_grad_(True)
    real_model = load_model(config, args.teacher, device, train=False)
    if args.teacher_dtype == "float32":
        real_model.float()
    max_length = gen_model.cfg.model_max_length

    def optimizer(model):
        if args.optimizer == "came":
            return optimizer_for(model, "came", args.lr)
        return adamw(model.parameters(), args.lr)

    diffusion = IDDPM(timestep_respacing=[1000], learn_sigma=True)
    gen_step, fake_step, _ = make_dmd_train_steps(
        gen_model.cfg, diffusion, start_ts=args.start_ts, cfg_scale=args.cfg,
        generator_optimizer=optimizer(gen_model), fake_optimizer=optimizer(fake_model))

    ds = DMDDataset(args.data_root, max_length=max_length, caption_dir=args.caption_dir)
    if args.sample_nums:
        ds.meta = ds.meta[: args.sample_nums]
    loader = DataLoader(ds, SimpleBatchSampler(len(ds), args.batch_size))
    gen = torch.Generator(device=device).manual_seed(0)
    to = lambda a: torch.from_numpy(a).to(device)
    step, history = 0, []
    while step < args.max_steps:
        for batch in loader:
            B = batch["init_noise"].shape[0]
            uncond = gen_model.y_embedder.y_embedding.detach()[None].expand(
                B, max_length, gen_model.cfg.caption_channels).float()
            dev = {"init_noise": to(batch["init_noise"]), "y": to(batch["y"]),
                   "y_mask": to(batch["y_mask"]), "uncond_y": uncond}
            t0 = time.perf_counter()
            metrics, x0 = gen_step(gen_model, real_model, fake_model, dev, generator=gen)
            metrics.update(fake_step(fake_model, x0, dev, generator=gen))
            metrics["seconds"] = time.perf_counter() - t0
            history.append(metrics)
            step += 1
            if step % args.log_interval == 0:
                logger.info(f"step {step}: dm={metrics['dm_loss']:.4f} "
                            f"sg={metrics['sg_loss']:.4f}")
            if step % args.save_steps == 0:
                save_pth(os.path.join(args.work_dir, f"dmd_step_{step}.pth"),
                             gen_model.state_dict())
            if step >= args.max_steps:
                break
    return {"generator": gen_model, "fake": fake_model, "real": real_model, "history": history}


if __name__ == "__main__":
    main()
