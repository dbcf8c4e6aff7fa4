"""LoRA / DoRA fine-tuning CLI.

Port of scripts/train_pixart_lora.py: the base weights (`--base`, a `.pth`
or a diffusers `.safetensors`) stay frozen; adapters of rank `--rank`
(default the config's `lora_rank`, else 4) on the modules of
`training.lora.DEFAULT_TARGETS` train with AdamW on the config's feature
dataset (latents times the scale factor), with Min-SNR weights when
`--snr-gamma` is set. The merged weights go to `WORK_DIR/lora_merged.pth`.
`--use-rslora` changes nothing without an alpha, as in JAX.

    python -m pixart_sigma_tpu_torch.scripts.train_pixart_lora CONFIG --base M.pth \\
        [--rank 4] [--use-dora] [--lr 1e-4] [--max-steps N] [--device cpu]

runs on the card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="LoRA / DoRA fine-tuning of PixArt")
    p.add_argument("config")
    p.add_argument("--work-dir", default="output/lora")
    p.add_argument("--base", required=True, help="pretrained .pth/safetensors")
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--use-dora", action="store_true")
    p.add_argument("--use-rslora", action="store_true")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--snr-gamma", type=float, default=None,
                   help="Min-SNR-gamma loss rebalancing (try 5.0)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Returns {"model", "base", "lora", "losses", "seconds", "merged_path"}:
    `seconds` per step on the host's clock, which the loss's read ends."""
    args = parse_args(argv)
    import torch

    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.scripts.finetune_common import (
        device_batch,
        feature_loader,
        load_model,
    )
    from pixart_sigma_tpu_torch.training.lora import (
        adamw,
        count_lora_params,
        init_lora_params,
        lora_parameters,
        make_lora_train_step,
        merge_lora,
    )
    from pixart_sigma_tpu_torch.utils.checkpoint import save_pth
    from pixart_sigma_tpu_torch.utils.device import resolve_device
    from pixart_sigma_tpu_torch.utils.logging import get_logger

    device = resolve_device(args.device)
    config = read_config(args.config)
    config.work_dir = args.work_dir
    os.makedirs(args.work_dir, exist_ok=True)
    logger = get_logger(args.work_dir)

    model = load_model(config, args.base, device, train=True)
    base = {n: p.detach() for n, p in model.named_parameters()}
    rank = args.rank or config.get("lora_rank", 4)
    gen = torch.Generator(device=device).manual_seed(config.seed)
    lora = init_lora_params(base, model.cfg, rank, generator=gen, use_dora=args.use_dora)
    logger.info(f"LoRA rank {rank}: {count_lora_params(lora) / 1e6:.2f}M params")

    diffusion = IDDPM(timestep_respacing=[config.train_sampling_steps], learn_sigma=True,
                      rescale_learned_sigmas=True)
    optimizer = adamw(list(lora_parameters(lora)), args.lr)
    step_fn = make_lora_train_step(model, diffusion, base, optimizer, snr_gamma=args.snr_gamma)
    loader = feature_loader(config)
    losses, seconds, step = [], [], 0
    for epoch in range(config.num_epochs):
        loader.batch_sampler.set_epoch(epoch)
        for batch in loader:
            t0 = time.perf_counter()
            loss = step_fn(lora, device_batch(batch, config, model.cfg, device), generator=gen)
            seconds.append(time.perf_counter() - t0)
            losses.append(loss)
            step += 1
            if step % config.log_interval == 0:
                logger.info(f"step {step}: loss={loss:.4f}")
            if args.max_steps and step >= args.max_steps:
                break
        if args.max_steps and step >= args.max_steps:
            break

    out = os.path.join(args.work_dir, "lora_merged.pth")
    save_pth(out, merge_lora(base, lora))
    logger.info(f"merged LoRA weights -> {out}")
    return {"model": model, "base": base, "lora": lora, "losses": losses, "seconds": seconds,
            "merged_path": out}


if __name__ == "__main__":
    main()
