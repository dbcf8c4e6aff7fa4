"""Train an AutoencoderKL (KL-VAE) from scratch on a folder of images.

Port of scripts/train_vae.py: the L2 reconstruction plus `--kl-weight`
times the posterior's KL to N(0, I) (the non-adversarial part of
latent-diffusion first-stage training), Adam, the images held in memory
after a PIL resize to `--resolution`, batches drawn as the JAX script draws
them (numpy's default_rng(seed)). It writes the JAX script's directory,
`vae_params.msgpack` (flax msgpack) and `vae_config.json`, which
`--vae-flax` of `scripts.inference`, `scripts.serve` and
`tools.extract_features`, and a `vae_pretrained` directory of
`scripts.train`, read; so does the JAX package.

    python -m pixart_sigma_tpu_torch.scripts.train_vae --data-root /tmp/toy/InternImgs \\
        --resolution 128 --preset small --steps 3000 --out /tmp/toy_vae

runs on the card unless given `--device cpu`. The initial weights are
flax's default init drawn from a CPU generator seeded `--seed`, and each
step's posterior eps from a device generator seeded `--seed`; JAX splits
keys instead, so the numbers differ (a test passes JAX's in through
`main(init_state=, eps_fn=)`).
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Callable, Dict, Optional

PRESETS = {
    # downsample x8 in every preset (4 levels); channels scale capacity
    "small": dict(block_out_channels=(32, 64, 64, 64), layers_per_block=1, norm_num_groups=8),
    "base": dict(block_out_channels=(64, 128, 256, 256), layers_per_block=2, norm_num_groups=32),
    "sdxl": dict(),  # full-size architecture (VAEConfig defaults)
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a KL-VAE on a folder of images")
    p.add_argument("--data-root", required=True, help="folder of images")
    p.add_argument("--out", required=True, help="output dir for params+config")
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--preset", choices=sorted(PRESETS), default="small")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--kl-weight", type=float, default=1e-6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def image_files(root: str) -> list:
    return sorted(f for ext in ("*.png", "*.jpg", "*.jpeg")
                  for f in glob.glob(os.path.join(root, ext)))


def load_images(files, resolution: int):
    """[N, r, r, 3] f32 in [-1, 1]: each image RGB, PIL-resized to r x r."""
    import numpy as np
    from PIL import Image

    def load(f):
        with Image.open(f) as im:
            im = im.convert("RGB").resize((resolution, resolution))
            return np.asarray(im, np.float32) / 127.5 - 1.0

    return np.stack([load(f) for f in files])


def vae_losses(vae, batch, eps):
    """(rec, kl): the reconstruction's MSE through the posterior sample
    mean + exp(logvar / 2) * eps, and 0.5 * mean(mean^2 + var - 1 - logvar)."""
    import torch

    mean, logvar = vae.encode(batch)
    recon = vae.decode(mean + torch.exp(0.5 * logvar) * eps)
    rec = ((recon - batch) ** 2).mean()
    kl = 0.5 * (mean.square() + logvar.exp() - 1.0 - logvar).mean()
    return rec, kl


def make_train_step(vae, optimizer, kl_weight: float) -> Callable:
    """step(batch [B, r, r, 3], eps [B, r/8, r/8, C]) -> (loss, rec, kl),
    detached device scalars, after one update of `vae` by `optimizer`."""
    def step(batch, eps):
        rec, kl = vae_losses(vae, batch, eps)
        loss = rec + kl_weight * kl
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), rec.detach(), kl.detach()

    return step


def main(argv=None, init_state: Optional[Dict] = None,
         eps_fn: Optional[Callable] = None) -> dict:
    """Train and write the directory. `init_state` (a state dict) replaces
    the seeded init, `eps_fn(step, shape)` the generator's eps. Returns
    {"vae", "history": [(step, loss, rec, kl)] and "elapsed": the seconds
    from the loop's start, both at the logged steps and the last (reading
    the loss waits for the step)}."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.models.vae import (
        AutoencoderKL,
        VAEConfig,
        init_vae_weights,
        save_flax_vae,
    )
    from pixart_sigma_tpu_torch.utils.device import resolve_device
    from pixart_sigma_tpu_torch.utils.logging import get_logger

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    logger = get_logger(work_dir=args.out)
    files = image_files(args.data_root)
    if not files:
        raise FileNotFoundError(f"no images under {args.data_root}")
    logger.info(f"{len(files)} images; resolution {args.resolution}")

    cfg = VAEConfig(**PRESETS[args.preset])
    vae = AutoencoderKL(cfg)
    if init_state is None:
        init_vae_weights(vae, torch.Generator().manual_seed(args.seed))
    else:
        vae.load_state_dict(init_state, strict=True)
    vae = vae.to(dev).train()
    n_params = sum(p.numel() for p in vae.parameters())
    logger.info(f"VAE preset={args.preset}: {n_params/1e6:.2f}M params")
    step_fn = make_train_step(vae, torch.optim.Adam(vae.parameters(), lr=args.lr),
                              args.kl_weight)

    data = load_images(files, args.resolution)
    logger.info(f"data in memory: {data.nbytes/1e6:.0f} MB")
    np_rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    lat = args.resolution // 8
    history, elapsed = [], []
    t0 = time.time()
    start = time.perf_counter()
    for step in range(1, args.steps + 1):
        idx = np_rng.integers(0, len(data), size=args.batch)
        batch = torch.from_numpy(data[idx]).to(dev)
        shape = (args.batch, lat, lat, cfg.latent_channels)
        eps = (torch.randn(shape, generator=gen, device=dev) if eps_fn is None
               else eps_fn(step, shape).to(dev))
        loss, rec, kl = step_fn(batch, eps)
        logged = step % args.log_interval == 0 or step == 1
        if logged or step == args.steps:
            loss, rec, kl = float(loss), float(rec), float(kl)
            history.append((step, loss, rec, kl))
            elapsed.append(time.perf_counter() - start)
        if logged:
            dt = time.time() - t0
            logger.info(f"step {step}/{args.steps} loss {loss:.5f} rec {rec:.5f} "
                        f"kl {kl:.3f} ({step * args.batch / dt:.1f} img/s)")

    vae.eval().requires_grad_(False)
    save_flax_vae(vae, args.out)
    logger.info(f"saved -> {args.out}/vae_params.msgpack + vae_config.json")
    return {"vae": vae, "history": history, "elapsed": elapsed}


if __name__ == "__main__":
    main()
