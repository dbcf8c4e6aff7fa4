"""FID between two sets of images: InceptionV3 activations and the Fréchet
distance.

Port of tools/compute_fid.py. Each side is a directory of images or an
`.npz` holding `activations` [N, D]:

    python -m pixart_sigma_tpu_torch.tools.compute_fid REAL FAKE \\
        [--weights pt_inception-2015-12-05.pth] [--batch 32] [--save-acts DIR]

The activations are computed on the card (`--device cpu` on the CPU). With
`--weights` they come from pytorch-fid's InceptionV3 and the number is
comparable to published FIDs; without, from the fixed-seed random
extractor, a relative statistic labelled `FID[random(seed=N)]`.
FID = |mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), in float64 numpy with
the PSD eigendecomposition square root.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a PSD matrix via eigendecomposition."""
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(acts1: np.ndarray, acts2: np.ndarray) -> float:
    mu1, mu2 = acts1.mean(0), acts2.mean(0)
    s1 = np.cov(acts1, rowvar=False)
    s2 = np.cov(acts2, rowvar=False)
    diff = mu1 - mu2
    # Tr sqrt(S1 S2) via sqrt(S1) S2 sqrt(S1) (PSD-symmetric form)
    rs1 = _sqrtm_psd(s1)
    covmean = _sqrtm_psd(rs1 @ s2 @ rs1)
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean))


def load_image_dir(path: str) -> np.ndarray:
    """Every image of `path` (sorted by name) as [N, H, W, 3] f32 in [0, 1]."""
    from PIL import Image

    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.lower().endswith(IMG_EXTS))
    if not files:
        raise ValueError(f"no images found in {path}")
    imgs = []
    for f in files:
        with Image.open(f) as im:
            imgs.append(np.asarray(im.convert("RGB"), np.float32) / 255.0)
    return np.stack(imgs)


def activations(source: str, args, model_cache: dict) -> np.ndarray:
    """f64 activations of a directory (extracted, optionally saved) or an
    `.npz`; the extractor is built once into `model_cache`."""
    if source.endswith(".npz"):
        return np.load(source)["activations"].astype(np.float64)
    from pixart_sigma_tpu_torch.models.inception import (
        extract_activations,
        load_fid_inception,
        random_inception_params,
    )

    if "model" not in model_cache:
        if args.weights:
            model_cache["model"] = load_fid_inception(args.weights, device=args.device)
            model_cache["tag"] = "pt_inception"
        else:
            model_cache["model"] = random_inception_params(seed=args.seed, device=args.device)
            model_cache["tag"] = f"random(seed={args.seed})"
    acts = extract_activations(model_cache["model"], load_image_dir(source), batch=args.batch)
    if args.save_acts:
        os.makedirs(args.save_acts, exist_ok=True)
        out = os.path.join(args.save_acts, os.path.basename(source.rstrip("/")) + "_acts.npz")
        np.savez(out, activations=acts)
        print(f"activations -> {out}")
    return acts.astype(np.float64)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FID between two image sets")
    p.add_argument("real", help="image dir or .npz with 'activations' [N, D]")
    p.add_argument("fake", help="image dir or .npz with 'activations' [N, D]")
    p.add_argument("--weights", default=None,
                   help="pt_inception .pth (comparable to published FIDs)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random extractor when no weights")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--save-acts", default=None, help="dir to save .npz acts")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    args = p.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    return args


def main(argv=None) -> float:
    args = parse_args(argv)
    cache: dict = {}
    a1 = activations(args.real, args, cache)
    a2 = activations(args.fake, args, cache)
    fid = frechet_distance(a1, a2)
    print(f"FID[{cache.get('tag', 'precomputed')}] = {fid:.4f}")
    return fid


if __name__ == "__main__":
    main()
