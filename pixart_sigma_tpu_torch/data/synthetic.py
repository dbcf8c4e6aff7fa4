"""A seeded synthetic feature dataset in the Sigma dialect, for runs and tests
that have no real data: data_info.json, SDXL-VAE [mean, std] features and
both caption feature directories, laid out as `data/datasets.py` reads them.
"""

from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

import numpy as np

from pixart_sigma_tpu_torch.data.aspect import aspect_ratio_table, get_closest_ratio


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
