"""Generate a synthetic text-to-image toy dataset in the Sigma data layout.

Port of tools/make_toy_dataset.py, byte for byte the same files for the same
arguments: coloured geometric shapes with templated captions ("a red circle
on a black background"), written as InternImgs/toy_<i>.png and
InternData/data_info.json, which `data.datasets` (dialect "sigma") reads.
`--pseudo-t5` also writes caption features, InternData/caption_features_new/
toy_<i>.npz: per-word hash embeddings of dimension `--caption-dim`
(`models.t5.pseudo_word_vector`), an offline stand-in for T5 that is a
pure function of the caption, so a DiT trained on them learns text
conditioning.

    python -m pixart_sigma_tpu_torch.tools.make_toy_dataset --out /tmp/toy --n 2048 \\
        --size 128 --pseudo-t5 --caption-dim 64

Then `tools.extract_features --vae-flax` with a VAE from `scripts.train_vae`
writes the latents (docs/toy_workflow.md).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
from PIL import Image, ImageDraw

from pixart_sigma_tpu_torch.models.t5 import pseudo_word_vector

SHAPES = ("circle", "square", "triangle")
COLORS = {
    "red": (220, 40, 40),
    "green": (40, 200, 70),
    "blue": (50, 90, 230),
    "yellow": (235, 210, 50),
}
BACKGROUNDS = {"black": (12, 12, 12), "white": (240, 240, 240)}


def draw_sample(rng: np.random.Generator, size: int):
    """(PIL image, prompt): a shape of jittered centre and radius."""
    shape = SHAPES[rng.integers(len(SHAPES))]
    color_name = list(COLORS)[rng.integers(len(COLORS))]
    bg_name = list(BACKGROUNDS)[rng.integers(len(BACKGROUNDS))]
    img = Image.new("RGB", (size, size), BACKGROUNDS[bg_name])
    d = ImageDraw.Draw(img)
    r = int(size * rng.uniform(0.18, 0.32))
    cx = int(rng.uniform(r + 2, size - r - 2))
    cy = int(rng.uniform(r + 2, size - r - 2))
    col = COLORS[color_name]
    if shape == "circle":
        d.ellipse([cx - r, cy - r, cx + r, cy + r], fill=col)
    elif shape == "square":
        d.rectangle([cx - r, cy - r, cx + r, cy + r], fill=col)
    else:
        d.polygon([(cx, cy - r), (cx - r, cy + r), (cx + r, cy + r)], fill=col)
    return img, f"a {color_name} {shape} on a {bg_name} background"


def pseudo_t5_features(prompt: str, dim: int, max_length: int):
    """(features [n, dim] fp16, mask [n] int16) of the first `max_length`
    words, unpadded."""
    rows = [pseudo_word_vector(w, dim) for w in prompt.split()[:max_length]]
    return np.stack(rows), np.ones((len(rows),), np.int16)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Write a synthetic shapes dataset")
    p.add_argument("--out", required=True, help="dataset root to create")
    p.add_argument("--n", type=int, default=2048)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pseudo-t5", action="store_true",
                   help="write hash-embedding caption features (no T5 weights)")
    p.add_argument("--caption-dim", type=int, default=64)
    p.add_argument("--max-length", type=int, default=12)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    img_dir = os.path.join(args.out, "InternImgs")
    data_dir = os.path.join(args.out, "InternData")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(data_dir, exist_ok=True)
    cap_dir = os.path.join(data_dir, "caption_features_new")
    if args.pseudo_t5:
        os.makedirs(cap_dir, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    meta = []
    for i in range(args.n):
        img, prompt = draw_sample(rng, args.size)
        name = f"toy_{i:06d}.png"
        img.save(os.path.join(img_dir, name))
        meta.append({"path": name, "prompt": prompt, "height": args.size, "width": args.size,
                     "ratio": 1.0})
        if args.pseudo_t5:
            fea, mask = pseudo_t5_features(prompt, args.caption_dim, args.max_length)
            np.savez(os.path.join(cap_dir, name.replace(".png", ".npz")),
                     caption_feature=fea[None], attention_mask=mask[None])
    with open(os.path.join(data_dir, "data_info.json"), "w") as f:
        json.dump(meta, f)
    print(f"{args.n} samples -> {args.out} (InternImgs/ + InternData/data_info.json"
          f"{' + caption_features_new/' if args.pseudo_t5 else ''})")


if __name__ == "__main__":
    main()
