"""Generate DMD training triplets: (fixed noise, teacher base latent) pairs.

Port of tools/generate_dmd_data.py: for each item of `data_info.json` (its
aspect ratio at most `--max-ratio`, the first `--sample-nums`), a fixed
init noise [h, w, 4] and the latent the teacher's 20-step DPM-Solver++
(CFG against its learned null caption) makes from exactly that noise, both
saved as `.npy` (HWC) under the item's file stem, which
`data.dmd_dataset.DMDDataset` reads back. Captions come from the stem-keyed
`.npz` of `--caption-dir` or, with `--pseudo-t5 DIM`, from hash embeddings
of the prompts. An item's noise is drawn from a generator seeded by
(`--seed`, its index), so any part of the dataset can be made again alone;
JAX folds the index into its key, so the numbers differ.

    python -m pixart_sigma_tpu_torch.tools.generate_dmd_data --data-root DIR \\
        --config CONFIG --model-path M.pth [--pseudo-t5 DIM] [--batch 16] [--device cpu]

runs on the card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DMD noise/latent pair generator")
    p.add_argument("--data-root", required=True, help="InternData dir holding data_info.json")
    p.add_argument("--config", default=None, help="teacher model config")
    p.add_argument("--model-path", required=True,
                   help="teacher checkpoint (.pth, safetensors, or an orbax step_N or run dir)")
    p.add_argument("--load-ema", action="store_true")
    p.add_argument("--image-size", type=int, default=512, help="used when no --config is given")
    p.add_argument("--caption-dir", default="caption_features",
                   help="caption .npz dir under data-root (stem-keyed)")
    p.add_argument("--pseudo-t5", type=int, default=0, metavar="DIM",
                   help=">0: hash-embed prompts instead of reading .npz")
    p.add_argument("--noise-dir", default="noise")
    p.add_argument("--base-latent-dir", default="base_latents")
    p.add_argument("--save-img", action="store_true",
                   help="also decode and save PNGs (needs --vae-flax or --vae-path)")
    p.add_argument("--vae-flax", default=None, help="a VAE directory of scripts.train_vae")
    p.add_argument("--vae-path", default=None, help="a diffusers VAE .safetensors")
    p.add_argument("--scale-factor", type=float, default=0.13025)
    p.add_argument("--img-dir", default="DMD_images")
    p.add_argument("--sample-nums", type=int, default=640_000, help="cap on items")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--cfg-scale", type=float, default=4.5)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-ratio", type=float, default=4.5,
                   help="drop items with aspect ratio above this")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _stem(item) -> str:
    return item["path"].rsplit("/", 1)[-1].rsplit(".", 1)[0]


def item_noise(seed: int, index: int, shape) -> np.ndarray:
    """The init noise of item `index`: N(0, 1) f32 from a CPU generator
    seeded by (seed, index)."""
    import torch

    s = int(np.random.SeedSequence([seed, index]).generate_state(1)[0])
    return torch.randn(shape, generator=torch.Generator().manual_seed(s)).numpy()


def main(argv=None):
    args = parse_args(argv)
    import torch

    from pixart_sigma_tpu_torch.models.builder import build_model_from_config
    from pixart_sigma_tpu_torch.pipelines.pipeline import PixArtPipeline
    from pixart_sigma_tpu_torch.scripts.train_pixart_dmd import build_config
    from pixart_sigma_tpu_torch.utils.checkpoint import load_checkpoint
    from pixart_sigma_tpu_torch.utils.device import resolve_device

    if args.save_img and not (args.vae_flax or args.vae_path):
        raise SystemExit("--save-img needs --vae-flax or --vae-path")
    device = resolve_device(args.device)
    with open(os.path.join(args.data_root, "data_info.json")) as f:
        meta = json.load(f)
    meta = [m for m in meta if m.get("ratio", 1.0) <= args.max_ratio][: args.sample_nums]
    if not meta:
        raise SystemExit("data_info.json matched no items")

    config = build_config(args.config, args.image_size, 120)  # JAX's default length
    image_size = config.get("image_size", args.image_size)
    model = load_checkpoint(args.model_path, build_model_from_config(config, device=device),
                            load_ema=args.load_ema)
    vae = None
    if args.save_img:
        from pixart_sigma_tpu_torch.models.vae import (
            VAEConfig,
            load_diffusers_vae,
            load_flax_vae,
        )

        vae = (load_flax_vae(args.vae_flax, device=device) if args.vae_flax else
               load_diffusers_vae(args.vae_path, VAEConfig.sdxl(scaling_factor=args.scale_factor),
                                  device=device))
    pipe = PixArtPipeline(model, vae=vae, scale_factor=args.scale_factor,
                          base_resolution=image_size, device=device)
    L = model.cfg.model_max_length
    pseudo = None
    if args.pseudo_t5 > 0:
        from pixart_sigma_tpu_torch.models.t5 import PseudoT5Embedder

        pseudo = PseudoT5Embedder(args.pseudo_t5, L)

    def captions(batch_meta):
        if pseudo is not None:
            return pseudo.get_text_embeddings([m.get("prompt", "") for m in batch_meta])
        ys, masks = [], []
        for m in batch_meta:
            npz = np.load(os.path.join(args.data_root, args.caption_dir, _stem(m) + ".npz"))
            fea = np.asarray(npz["caption_feature"], np.float32)
            fea = fea[0] if fea.ndim == 3 else fea
            mask = (np.asarray(npz["attention_mask"], np.int32).reshape(-1)
                    if "attention_mask" in npz else np.ones((fea.shape[0],), np.int32))
            n = min(fea.shape[0], L)
            y, mk = np.zeros((L, fea.shape[1]), np.float32), np.zeros((L,), np.int32)
            y[:n], mk[:n] = fea[:n], mask[:n]
            ys.append(y)
            masks.append(mk)
        return torch.from_numpy(np.stack(ys)), torch.from_numpy(np.stack(masks))

    null_emb = model.y_embedder.y_embedding.detach().float()
    noise_dir = os.path.join(args.data_root, args.noise_dir)
    latent_dir = os.path.join(args.data_root, args.base_latent_dir)
    os.makedirs(noise_dir, exist_ok=True)
    os.makedirs(latent_dir, exist_ok=True)
    if args.save_img:
        os.makedirs(os.path.join(args.data_root, args.img_dir), exist_ok=True)

    h = w = image_size // 8
    B = args.batch
    done = 0
    for start in range(0, len(meta), B):
        batch = meta[start:start + B]
        pad = B - len(batch)
        noise = np.stack([item_noise(args.seed, start + i, (h, w, 4))
                          for i in range(len(batch))])
        if pad:
            noise = np.concatenate([noise, np.repeat(noise[-1:], pad, 0)], axis=0)
        y, y_mask = captions(batch + [batch[-1]] * pad)
        latents = pipe([m.get("prompt", "") for m in batch] + [""] * pad,
                       num_inference_steps=args.steps, guidance_scale=args.cfg_scale,
                       sampler="dpm-solver", y=y.to(device), y_mask=y_mask.to(device),
                       y_null=null_emb[None].expand(B, *null_emb.shape),
                       latents=torch.from_numpy(noise).to(device), return_latents=True)
        for i, m in enumerate(batch):
            np.save(os.path.join(noise_dir, _stem(m) + ".npy"), noise[i])
            np.save(os.path.join(latent_dir, _stem(m) + ".npy"),
                    np.asarray(latents[i], np.float32))
        if vae is not None:
            imgs = pipe._latents_to_images(torch.from_numpy(latents).to(device))
            from PIL import Image

            for i, m in enumerate(batch):
                Image.fromarray(imgs[i]).save(
                    os.path.join(args.data_root, args.img_dir, _stem(m) + ".png"))
        done += len(batch)
        print(f"{done}/{len(meta)} pairs", flush=True)
    print(f"wrote {done} noise/latent pairs -> {noise_dir}, {latent_dir}")


if __name__ == "__main__":
    main()
