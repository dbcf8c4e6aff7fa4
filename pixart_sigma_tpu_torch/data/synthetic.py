"""Seeded synthetic datasets in the Sigma dialect, for runs and tests that
have no real data, laid out as `data/datasets.py` reads them:
`write_feature_dataset` writes data_info.json, SDXL-VAE [mean, std]
features and both caption feature directories; `write_image_dataset`
writes data_info.json, PNG images and captions for image- and prompt-mode
training and for `tools.extract_features`.
"""

from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

import numpy as np

from pixart_sigma_tpu_torch.data.aspect import aspect_ratio_table, get_closest_ratio
from pixart_sigma_tpu_torch.utils.png import write_png

_WORDS = ("a photo of the red fox small cactus with happy face mountain sunset lake "
          "astronaut jungle oil painting city street at night old wooden boat on calm "
          "water under stars bright colorful detailed soft light").split()


def write_feature_dataset(
    root: str,
    image_sizes: Sequence[Tuple[int, int]],  # (height, width) of each item's image
    *,
    resolution: int = 1024,
    multi_scale: bool = True,
    caption_channels: int = 4096,
    max_length: int = 300,
    valid_tokens: Tuple[int, int] = (3, 19),
    latent_channels: int = 4,
    seed: int = 0,
) -> str:
    """Write len(image_sizes) items under `root` and return it. Each item's
    VAE features have its aspect bucket's size (the image size at
    `resolution` when not multi-scale); each caption has a random number of
    valid tokens in `valid_tokens` (inclusive) out of `max_length`."""
    rng = np.random.default_rng(seed)
    table = aspect_ratio_table(resolution)
    vae_dir = f"img_sdxl_vae_features_{resolution}resolution{'_ms' if multi_scale else ''}_new"
    dirs = (vae_dir, "caption_features_new", "sharegpt4v_caption_features_new")
    for d in dirs:
        os.makedirs(os.path.join(root, d), exist_ok=True)
    meta = []
    for i, (height, width) in enumerate(image_sizes):
        name = f"{i:06d}"
        meta.append({"path": f"part0/{name}.png", "height": height, "width": width,
                     "ratio": height / width, "prompt": f"synthetic caption {i}",
                     "sharegpt4v": f"a longer synthetic caption {i}"})
        h, w = (get_closest_ratio(height, width, table)[0] if multi_scale
                else (resolution, resolution))
        shape = (latent_channels, int(h) // 8, int(w) // 8)
        mean = rng.standard_normal(shape).astype(np.float32)
        std = (0.05 + 0.1 * rng.random(shape)).astype(np.float32)
        np.save(os.path.join(root, vae_dir, f"{name}.npy"), np.concatenate([mean, std]))
        for d in dirs[1:]:
            n = int(rng.integers(valid_tokens[0], valid_tokens[1] + 1))
            mask = (np.arange(max_length) < n).astype(np.int64)[None]
            feat = rng.standard_normal((1, max_length, caption_channels)).astype(np.float16)
            np.savez(os.path.join(root, d, f"{name}.npz"), caption_feature=feat,
                     attention_mask=mask)
    with open(os.path.join(root, "data_info.json"), "w") as f:
        json.dump(meta, f)
    return root


def write_image_dataset(root: str, image_sizes: Sequence[Tuple[int, int]], *,
                        seed: int = 0) -> str:
    """Write len(image_sizes) RGB PNG images of the given (height, width)
    under `root`/part0/ (smooth colour fields with noise) and a
    data_info.json whose items carry two captions of 4-40 words (`prompt`
    and `sharegpt4v`); return `root`."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "part0"), exist_ok=True)
    meta = []
    for i, (height, width) in enumerate(image_sizes):
        name = f"{i:06d}.png"
        yy, xx = np.mgrid[0:height, 0:width] / max(height, width)
        freq, phase = 2 + 6 * rng.random((2, 3)), 6.28 * rng.random(3)
        img = (127.5 + 90 * np.sin(freq[0] * xx[..., None] + freq[1] * yy[..., None] + phase)
               + 20 * rng.standard_normal((height, width, 3)))
        write_png(os.path.join(root, "part0", name), np.clip(img, 0, 255).astype(np.uint8))
        captions = [" ".join(rng.choice(_WORDS, int(rng.integers(4, 41)))) for _ in range(2)]
        meta.append({"path": f"part0/{name}", "height": height, "width": width,
                     "ratio": height / width, "prompt": captions[0],
                     "sharegpt4v": captions[1]})
    with open(os.path.join(root, "data_info.json"), "w") as f:
        json.dump(meta, f)
    return root
