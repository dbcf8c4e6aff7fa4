"""The training CLI: a config file to a trained run.

Port of scripts/train.py. `--load-from` starts the weights from a `.pth` or
a diffusers `.safetensors`; `--resume-from` (a checkpoint, or "latest" of
the run) restores the weights (not the EMA), the optimizer and the LR
schedule's position; `--debug` trains at batch 2 and logs every step. The
VAE comes from the config's `vae_pretrained` (a diffusers `.safetensors`,
or a directory `scripts.train_vae` wrote) when it is set, for image-mode
batches and validation images; T5 from `t5_pretrained` (a local HF
directory) when the data holds prompts (`load_t5_feat=False`).

    python -m pixart_sigma_tpu_torch.scripts.train CONFIG [--work-dir DIR] \\
        [--load-from M.pth] [--resume-from latest] [--max-steps N] [--debug] \\
        [--data-root DIR] [--features] [--device cpu]

runs on the card unless given `--device cpu`. Under torchrun,

    torchrun --nproc-per-node N -m pixart_sigma_tpu_torch.scripts.train CONFIG

trains on N cards (NCCL), or over gloo with `--device cpu`, sharded as the
config's `mesh`, `use_fsdp` and `use_tensor_parallel` say; `train_batch_size`
is then the batch of one rank.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train PixArt on one card or, under torchrun, "
                                             "on several")
    p.add_argument("config", help="python config file")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--load-from", default=None, help=".pth/safetensors weights")
    p.add_argument("--resume-from", default=None, help="a .pth checkpoint or 'latest'")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--debug", action="store_true", help="batch 2, log every step")
    p.add_argument("--data-root", default=None, help="overrides the config's data_root")
    p.add_argument("--features", action="store_true",
                   help="read precomputed VAE and T5 features "
                        "(load_vae_feat = load_t5_feat = True)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def load_vae(config, device):
    """The config's `vae_pretrained`: a diffusers `.safetensors` as an SDXL
    VAE at the config's scale factor, or a `scripts.train_vae` directory;
    None when unset."""
    path = config.get("vae_pretrained")
    if not path:
        return None
    from pixart_sigma_tpu_torch.models.vae import VAEConfig, load_diffusers_vae, load_flax_vae

    if os.path.isdir(path):
        return load_flax_vae(path, device=device)

    return load_diffusers_vae(path, VAEConfig.sdxl(scaling_factor=config.scale_factor),
                              device=device)


def main(argv=None):
    args = parse_args(argv)
    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.parallel.dist import initialize_distributed
    from pixart_sigma_tpu_torch.training.trainer import Trainer, refuse_parallelism
    from pixart_sigma_tpu_torch.utils.device import resolve_device

    config = read_config(args.config)
    refuse_parallelism(config)
    device = resolve_device(args.device)
    initialize_distributed(device=device)
    if args.work_dir:
        config.work_dir = args.work_dir
    if args.load_from:
        config.load_from = args.load_from
    if args.resume_from:
        config.resume_from = dict(checkpoint=args.resume_from, load_ema=False,
                                  resume_optimizer=True, resume_lr_scheduler=True)
    if args.debug:
        config.train_batch_size = 2
        config.log_interval = 1
    if args.data_root is not None:
        config.data_root = args.data_root
    if args.features:
        config.data = dict(config.data, load_vae_feat=True, load_t5_feat=True)

    vae = load_vae(config, device)
    t5 = None
    data_cfg = config.get("data", {}) or {}
    if not data_cfg.get("load_t5_feat", True) and config.get("t5_pretrained"):
        from pixart_sigma_tpu_torch.models.t5 import T5Embedder

        t5 = T5Embedder.from_pretrained(config.t5_pretrained,
                                        model_max_length=config.model_max_length, device=device)
    trainer = Trainer(config, device=device, vae=vae, t5=t5)
    trainer.train(max_steps=args.max_steps)
    return trainer


if __name__ == "__main__":
    main()
