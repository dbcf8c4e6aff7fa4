"""Batch txt2img inference: a prompt file to images.

Port of scripts/inference.py: reads a prompt file (one prompt per line,
optional `--ar h:w` / `--hw h:w` flags inside a prompt), runs it in chunks
of `--bs` with the seed `seed + index of the chunk's first prompt`, and
writes JPGs through the VAE, or the latents as `.npy` without one.

    python -m pixart_sigma_tpu_torch.scripts.inference --model-path model.pth \\
        --txt-file prompts.txt --pseudo-t5 4096 --vae-path sdxl_vae.safetensors --turbo

runs on the card; `--device cpu` runs on the CPU. The model comes from
`--config`, or is PixArtMS-XL-2 at `--image-size` (`--version` alpha adds
the micro-conditions at 1024px). `--turbo` is `--int8` plus block caching
at interval 2 for dpm-solver; `--block-cache-threshold` and
`--block-cache-schedule` pick the other refresh policies, over the layers of
`--cache-span`. `--seq-parallel N` splits each trajectory's tokens over N
ranks under torchrun (`torchrun --nproc-per-node N -m pixart_sigma_tpu_torch.
scripts.inference --seq-parallel N ...`): every rank runs every chunk, and
rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import os

from pixart_sigma_tpu_torch.scripts.serve import add_seq_parallel_args, load_encoders, seq_mesh

PE_INTERP = {256: 0.5, 512: 1.0, 1024: 2.0, 2048: 4.0}
DEFAULT_STEPS = {"dpm-solver": 20, "deis": 20, "sde-dpm-solver": 20,
                 "iddpm": 100, "sa-solver": 25, "lcm": 4, "dmd": 1}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PixArt-Sigma batch inference")
    p.add_argument("--config", default=None,
                   help="model config (else PixArtMS-XL-2 at --image-size)")
    p.add_argument("--model-path", required=True,
                   help="an upstream-dialect .pth, a diffusers .safetensors, or a JAX run's "
                        "orbax step_N, checkpoints/ or run directory")
    p.add_argument("--t5-path", default=None, help="a local HF T5 encoder directory")
    p.add_argument("--vae-path", default=None, help="a diffusers VAE .safetensors")
    p.add_argument("--image-size", type=int, default=1024, choices=[256, 512, 1024, 2048])
    p.add_argument("--version", default="sigma", choices=["alpha", "sigma"])
    p.add_argument("--txt-file", required=True, help="one prompt per line")
    p.add_argument("--save-root", default="output/samples")
    p.add_argument("--sampling-algo", default="dpm-solver", choices=list(DEFAULT_STEPS))
    p.add_argument("--steps", type=int, default=None,
                   help="default: dpm 20 / iddpm 100 / sa 25 / lcm 4")
    p.add_argument("--cfg-scale", type=float, default=4.5)
    p.add_argument("--bs", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--block-cache-interval", type=int, default=0,
                   help=">= 2 turns on delta block caching (dpm-solver only): the "
                        "--cache-span layers are recomputed every N model calls")
    p.add_argument("--block-cache-threshold", type=float, default=None,
                   help="adaptive block caching: refresh when the accumulated latent drift "
                        "crosses this (overrides the interval)")
    p.add_argument("--block-cache-schedule", type=str, default=None,
                   help="comma-separated model calls that refresh the cache, 0 among them "
                        "(overrides the interval)")
    p.add_argument("--cache-span", type=str, default="7:21",
                   help="k1:k2 layer span cached by block caching")
    p.add_argument("--vae-flax", default=None,
                   help="a VAE directory of scripts.train_vae (vae_config.json + "
                        "vae_params.msgpack); instead of --vae-path")
    p.add_argument("--pseudo-t5", type=int, default=None, metavar="DIM",
                   help="hash-embedding text encoder of this dim; the CFG null is the "
                        "model's learned null caption")
    p.add_argument("--scale-factor", type=float, default=None,
                   help="latent scale override (default per version)")
    p.add_argument("--turbo", action="store_true",
                   help="--int8 + --block-cache-interval 2 (dpm-solver only)")
    p.add_argument("--int8", action="store_true",
                   help="dynamic int8 (W8A8) projection and MLP matmuls")
    add_seq_parallel_args(p)
    p.add_argument("--load-ema", action="store_true", help="load the checkpoint's EMA weights")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def build_model(args, device):
    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.models.builder import build_model_from_config
    from pixart_sigma_tpu_torch.models.pixart import PixArtMS_XL_2

    extra = {}
    if args.int8:
        extra["quant_int8"] = True
    if (args.block_cache_interval >= 2 or args.block_cache_threshold is not None
            or args.block_cache_schedule):
        k1, k2 = (int(v) for v in args.cache_span.split(":"))
        extra["cache_span"] = (k1, k2)
    if args.config:
        config = read_config(args.config)
        return build_model_from_config(config, device=device, **extra), \
            config.get("image_size", args.image_size)
    model = PixArtMS_XL_2(
        device=device, input_size=args.image_size // 8,
        pe_interpolation=PE_INTERP[args.image_size],
        model_max_length=300 if args.version == "sigma" else 120,
        micro_condition=args.version == "alpha" and args.image_size == 1024, **extra)
    return model, args.image_size


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.data.aspect import get_chunks
    from pixart_sigma_tpu_torch.pipelines import PixArtPipeline
    from pixart_sigma_tpu_torch.utils.checkpoint import load_checkpoint
    from pixart_sigma_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    mesh = seq_mesh(args, device)
    if args.turbo:
        args.int8 = True
        if args.sampling_algo == "dpm-solver":
            args.block_cache_interval = max(args.block_cache_interval, 2)
        else:
            # block caching is dpm-solver only; other samplers run int8 only
            print(f"--turbo: {args.sampling_algo} does not support block caching; "
                  "running int8 only", flush=True)
    model, base_res = build_model(args, device)
    load_checkpoint(args.model_path, model, load_ema=args.load_ema)
    scale = args.scale_factor or (0.13025 if args.version == "sigma" else 0.18215)
    t5, y_null_row, vae = load_encoders(args, model, scale, device)
    pipe = PixArtPipeline(model, t5=t5, vae=vae, scale_factor=scale, base_resolution=base_res,
                          device=device, mesh=mesh)
    writes = mesh is None or torch.distributed.get_rank() == 0

    with open(args.txt_file) as f:
        prompts = [ln.strip() for ln in f if ln.strip()]
    if writes:
        os.makedirs(args.save_root, exist_ok=True)
    steps = args.steps or DEFAULT_STEPS[args.sampling_algo]
    schedule = (None if not args.block_cache_schedule
                else [int(v) for v in args.block_cache_schedule.split(",")])
    idx = 0
    for chunk in get_chunks(prompts, args.bs):
        y_null = (None if y_null_row is None
                  else y_null_row[None].expand(len(chunk), *y_null_row.shape))
        images = pipe(chunk, num_inference_steps=steps, guidance_scale=args.cfg_scale,
                      sampler=args.sampling_algo, seed=args.seed + idx, y_null=y_null,
                      return_latents=vae is None,
                      block_cache_interval=args.block_cache_interval,
                      block_cache_threshold=args.block_cache_threshold,
                      block_cache_schedule=schedule)
        for j, img in enumerate(images if writes else ()):
            name = f"{idx + j:05d}_{args.sampling_algo}_{steps}.jpg"
            if vae is None:
                np.save(os.path.join(args.save_root, name + ".npy"), img)
            else:
                from PIL import Image

                Image.fromarray(img).save(os.path.join(args.save_root, name))
        idx += len(chunk)
    if writes:
        print(f"wrote {idx} samples to {args.save_root}")


if __name__ == "__main__":
    main()
