"""Precompute T5 caption features and VAE posteriors for feature-mode
training (port of tools/extract_features.py).

- Caption features: caption_features_new/<name>.npz with an fp16
  `caption_feature` [1, L, d_model] and an int16 `attention_mask` [1, L].
- VAE posteriors: img_sdxl_vae_features_{res}resolution_new/<name>.npy (with
  --multi-scale: ..._ms_new/, each image resized and cropped to its aspect
  bucket), the fp16 CHW concatenation [mean, std], encoded in groups of one
  image size.

    python -m pixart_sigma_tpu_torch.tools.extract_features --root DIR \\
        [--t5-path HF_DIR] [--vae-path VAE.safetensors] [--resolution 512] \\
        [--multi-scale] [--max-length 300] [--batch 8] [--device cpu]

Both halves read the data_info.json layout of the Sigma dialect
(`data.datasets`); images are read from the root with "InternData"
replaced by "InternImgs", as the datasets do. No tokenizer or weights ship
with the repository: `--t5-path` names a local HF T5 checkpoint directory
with its tokenizer, `--vae-path` a diffusers AutoencoderKL `.safetensors`
file.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from pixart_sigma_tpu_torch.data.aspect import aspect_ratio_table, get_closest_ratio
from pixart_sigma_tpu_torch.data.transforms import default_train, multiscale_train, open_image
from pixart_sigma_tpu_torch.models.vae import load_diffusers_vae


def _stem(item: Dict[str, Any]) -> str:
    return item["path"].rsplit("/", 1)[-1].rsplit(".", 1)[0]


def extract_caption_t5(root: str, meta: Sequence[Dict[str, Any]], t5, batch: int = 8) -> str:
    """Encode each item's `prompt` with `t5` (`get_text_embeddings`) and write
    its features; returns the output directory."""
    out_dir = os.path.join(root, "caption_features_new")
    os.makedirs(out_dir, exist_ok=True)
    for i in range(0, len(meta), batch):
        chunk = meta[i : i + batch]
        feats, masks = t5.get_text_embeddings([m["prompt"] for m in chunk])
        feats = feats.float().cpu().numpy().astype(np.float16)
        masks = masks.cpu().numpy().astype(np.int16)
        for m, f, am in zip(chunk, feats, masks):
            np.savez(os.path.join(out_dir, _stem(m) + ".npz"), caption_feature=f[None],
                     attention_mask=am[None])
    return out_dir


@torch.no_grad()
def extract_img_vae(root: str, meta: Sequence[Dict[str, Any]], vae, resolution: int,
                    multi_scale: bool = False, batch: int = 8) -> str:
    """Encode each item's image with `vae` (a port `AutoencoderKL`) at the
    resolution (single-scale: shorter side, center crop) or at its aspect
    bucket (multi-scale) and write the posterior's [mean, std]; returns the
    output directory."""
    suffix = "_ms_new" if multi_scale else "_new"
    out_dir = os.path.join(root, f"img_sdxl_vae_features_{resolution}resolution{suffix}")
    os.makedirs(out_dir, exist_ok=True)
    img_root = root.replace("InternData", "InternImgs")
    ratios = aspect_ratio_table(resolution) if multi_scale else None
    groups: Dict[tuple, List[Dict[str, Any]]] = {}
    for m in meta:  # one encode per image size
        if multi_scale:
            size, _ = get_closest_ratio(m["height"], m["width"], ratios)
            hw = (int(size[0]), int(size[1]))
        else:
            hw = (resolution, resolution)
        groups.setdefault(hw, []).append(m)
    dev = vae.quant_conv.weight.device
    for hw, items in groups.items():
        for i in range(0, len(items), batch):
            chunk = items[i : i + batch]
            arrs = []
            for m in chunk:
                with open_image(os.path.join(img_root, m["path"])) as im:
                    arrs.append(multiscale_train(im, hw) if multi_scale
                                else default_train(im, resolution))
            mean, logvar = vae.encode(torch.from_numpy(np.stack(arrs)).to(dev))
            mean = mean.float().cpu().numpy()
            std = torch.exp(0.5 * logvar.float()).cpu().numpy()
            for m, mu, sd in zip(chunk, mean, std):
                packed = np.concatenate([mu.transpose(2, 0, 1), sd.transpose(2, 0, 1)], axis=0)
                np.save(os.path.join(out_dir, _stem(m) + ".npy"), packed.astype(np.float16))
    return out_dir


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True, help="dataset root holding the JSON")
    p.add_argument("--json", default="data_info.json")
    p.add_argument("--t5-path", help="local HF T5 checkpoint directory: caption features")
    p.add_argument("--vae-path", help="diffusers VAE .safetensors: image latents")
    p.add_argument("--vae-flax", help="a JAX VAE training directory (not read by the port)")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--max-length", type=int, default=300)
    p.add_argument("--multi-scale", action="store_true")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.vae_flax:
        raise NotImplementedError("--vae-flax reads a JAX training directory, which the port "
                                  "does not read (ROADMAP.md, Queue 3: orbax checkpoints)")
    with open(os.path.join(args.root, args.json)) as f:
        meta = json.load(f)
    if args.t5_path:
        from pixart_sigma_tpu_torch.models.t5 import T5Embedder

        t5 = T5Embedder.from_pretrained(args.t5_path, model_max_length=args.max_length,
                                        device=args.device)
        print(f"caption features -> {extract_caption_t5(args.root, meta, t5, args.batch)}")
    if args.vae_path:
        vae = load_diffusers_vae(args.vae_path, device=args.device)
        out = extract_img_vae(args.root, meta, vae, args.resolution, args.multi_scale, args.batch)
        print(f"vae latents -> {out}")


if __name__ == "__main__":
    main()
