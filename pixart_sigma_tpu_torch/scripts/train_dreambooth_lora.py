"""DreamBooth-LoRA subject-driven fine-tuning CLI.

Port of scripts/train_dreambooth_lora.py: a few instance images of one
subject (and, with `--class-dir`, class images for prior preservation),
LoRA on the DiT, loss = instance MSE + prior_loss_weight · class MSE. A
directory holds `.npy` latents [H/8, W/8, 4] or images (`.png`/`.jpg`,
encoded once by the `--vae-path` VAE, a posterior sample). Prompts are
encoded by `--t5-path` or read from `--prompt-embeds` (an npz of
y_instance, mask_instance[, y_class, mask_class]). The merged weights go
to `WORK_DIR/dreambooth_lora_merged.pth`.

    python -m pixart_sigma_tpu_torch.scripts.train_dreambooth_lora CONFIG --base M.pth \\
        --instance-dir DIR [--class-dir DIR] (--prompt-embeds P.npz | --t5-path T5) \\
        [--vae-path VAE.safetensors] [--max-steps N] [--device cpu]

runs on the card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DreamBooth-LoRA fine-tuning of PixArt")
    p.add_argument("config")
    p.add_argument("--work-dir", default="output/dreambooth")
    p.add_argument("--base", required=True, help="pretrained .pth/safetensors")
    p.add_argument("--instance-dir", required=True)
    p.add_argument("--instance-prompt", default="a photo of sks subject")
    p.add_argument("--class-dir", default=None, help="prior-preservation class images/latents")
    p.add_argument("--class-prompt", default="a photo of a subject")
    p.add_argument("--prior-loss-weight", type=float, default=1.0)
    p.add_argument("--prompt-embeds", default=None,
                   help="npz with y_instance/mask_instance[,y_class,mask_class]")
    p.add_argument("--t5-path", default=None)
    p.add_argument("--vae-path", default=None)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--use-dora", action="store_true")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=400)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _load_latents(path_dir: str, vae, image_size: int, device, noise=None,
                  generator=None) -> np.ndarray:
    """The `.npy` latents of a directory, or its images resized to
    image_size², in [-1, 1], encoded by the VAE as a posterior sample whose
    eps is `noise` or drawn from `generator`."""
    import torch

    from pixart_sigma_tpu_torch.models.vae import posterior_sample

    npys = sorted(glob.glob(os.path.join(path_dir, "*.npy")))
    if npys:
        return np.stack([np.load(f) for f in npys])
    imgs = sorted(f for ext in ("*.png", "*.jpg", "*.jpeg")
                  for f in glob.glob(os.path.join(path_dir, ext)))
    if not imgs:
        raise FileNotFoundError(f"no .npy latents or images in {path_dir}")
    if vae is None:
        raise ValueError(f"{path_dir} holds images but no --vae-path was given")
    from PIL import Image

    arr = [np.asarray(Image.open(f).convert("RGB").resize((image_size, image_size)),
                      np.float32) / 127.5 - 1.0 for f in imgs]
    with torch.no_grad():
        mean, logvar = vae.encode(torch.from_numpy(np.stack(arr)).to(device))
        if noise is None:
            gen_dev = generator.device if generator is not None else mean.device
            noise = torch.randn(mean.shape, generator=generator, device=gen_dev)
        return posterior_sample(mean, logvar, torch.as_tensor(noise)).float().cpu().numpy()


def main(argv=None):
    """Returns {"model", "base", "lora", "metrics", "merged_path"}; each
    step's metrics hold its `seconds` on the host's clock."""
    args = parse_args(argv)
    import torch

    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.scripts.finetune_common import load_model
    from pixart_sigma_tpu_torch.training.dreambooth import make_dreambooth_step
    from pixart_sigma_tpu_torch.training.lora import (
        adamw,
        count_lora_params,
        init_lora_params,
        lora_parameters,
        merge_lora,
    )
    from pixart_sigma_tpu_torch.utils.checkpoint import save_pth
    from pixart_sigma_tpu_torch.utils.device import resolve_device
    from pixart_sigma_tpu_torch.utils.logging import get_logger

    device = resolve_device(args.device)
    config = read_config(args.config)
    os.makedirs(args.work_dir, exist_ok=True)
    logger = get_logger(args.work_dir)
    model = load_model(config, args.base, device, train=True)
    base = {n: p.detach() for n, p in model.named_parameters()}

    vae = None
    if args.vae_path:
        from pixart_sigma_tpu_torch.models.vae import VAEConfig, load_diffusers_vae

        vae = load_diffusers_vae(args.vae_path, VAEConfig.sdxl(scaling_factor=config.scale_factor),
                                 device=device)
    enc_gen = torch.Generator(device=device).manual_seed(0)
    image_size = config.image_size
    inst = _load_latents(args.instance_dir, vae, image_size, device,
                         generator=enc_gen) * config.scale_factor
    with_prior = args.class_dir is not None
    cls = None
    if with_prior:
        cls = _load_latents(args.class_dir, vae, image_size, device,
                            generator=enc_gen) * config.scale_factor
    del vae

    y_cls = m_cls = None
    if args.prompt_embeds:
        z = np.load(args.prompt_embeds)
        y_inst, m_inst = z["y_instance"], z["mask_instance"]
        y_cls = z["y_class"] if "y_class" in z else None
        m_cls = z["mask_class"] if "mask_class" in z else None
    elif args.t5_path:
        from pixart_sigma_tpu_torch.models.t5 import T5Embedder

        t5 = T5Embedder.from_pretrained(args.t5_path, model_max_length=config.model_max_length,
                                        device=device)
        y, m = t5.get_text_embeddings([args.instance_prompt])
        y_inst, m_inst = y[0].float().cpu().numpy(), m[0].cpu().numpy()
        if with_prior:
            y, m = t5.get_text_embeddings([args.class_prompt])
            y_cls, m_cls = y[0].float().cpu().numpy(), m[0].cpu().numpy()
        del t5
    else:
        raise ValueError("need --prompt-embeds or --t5-path")
    if with_prior and y_cls is None:
        raise ValueError("--class-dir given but no class prompt embedding")
    if with_prior and m_cls is None:
        raise ValueError("--class-dir given but the prompt-embeds npz is missing 'mask_class' "
                         "(found 'y_class' without its attention mask)")

    rank = args.rank or config.get("lora_rank", 4)
    gen = torch.Generator(device=device).manual_seed(config.seed)
    lora = init_lora_params(base, model.cfg, rank, generator=gen, use_dora=args.use_dora)
    logger.info(f"DreamBooth LoRA rank {rank}: {count_lora_params(lora) / 1e6:.2f}M params; "
                f"{len(inst)} instance" + (f" + {len(cls)} class latents" if with_prior
                                           else " latents"))
    diffusion = IDDPM(timestep_respacing=[config.train_sampling_steps], learn_sigma=True,
                      rescale_learned_sigmas=True)
    optimizer = adamw(list(lora_parameters(lora)), args.lr)
    step_fn = make_dreambooth_step(model, diffusion, base, optimizer,
                                   with_prior_preservation=with_prior,
                                   prior_loss_weight=args.prior_loss_weight)

    bs = args.batch_size or config.get("train_batch_size", 2)
    rng = np.random.RandomState(config.seed)
    history = []
    for step in range(args.max_steps):
        pick_i = rng.randint(0, len(inst), size=bs)
        parts = [inst[pick_i]]
        ys = [np.broadcast_to(y_inst, (bs, *y_inst.shape))]
        ms = [np.broadcast_to(m_inst, (bs, *m_inst.shape))]
        if with_prior:
            pick_c = rng.randint(0, len(cls), size=bs)
            parts.append(cls[pick_c])
            ys.append(np.broadcast_to(y_cls, (bs, *y_cls.shape)))
            ms.append(np.broadcast_to(m_cls, (bs, *m_cls.shape)))
        batch = {"latents": torch.from_numpy(np.concatenate(parts).astype(np.float32)).to(device),
                 "y": torch.from_numpy(np.concatenate(ys).astype(np.float32)).to(device),
                 "y_mask": torch.from_numpy(np.concatenate(ms).astype(np.int32)).to(device)}
        t0 = time.perf_counter()
        metrics = step_fn(lora, batch, generator=gen)
        metrics["seconds"] = time.perf_counter() - t0
        history.append(metrics)
        if (step + 1) % config.get("log_interval", 50) == 0:
            logger.info(f"step {step + 1}: " + " ".join(f"{k}={v:.4f}"
                                                         for k, v in metrics.items()))

    out = os.path.join(args.work_dir, "dreambooth_lora_merged.pth")
    save_pth(out, merge_lora(base, lora))
    logger.info(f"merged weights -> {out}")
    return {"model": model, "base": base, "lora": lora, "metrics": history, "merged_path": out}


if __name__ == "__main__":
    main()
