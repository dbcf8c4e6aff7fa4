"""Checkpoint conversion CLI: upstream `.pth` <-> diffusers `.safetensors`,
and the weighted average of two `.pth`.

Port of tools/convert_checkpoint.py over the name maps of
`utils.checkpoint`. Tensors are read as f32, as JAX's tool reads them.

    python -m pixart_sigma_tpu_torch.tools.convert_checkpoint to-diffusers model.pth out.safetensors
    python -m pixart_sigma_tpu_torch.tools.convert_checkpoint to-pth transformer_dir out.pth
    python -m pixart_sigma_tpu_torch.tools.convert_checkpoint merge a.pth b.pth out.pth --alpha 0.5
"""

from __future__ import annotations

import argparse

import torch

from pixart_sigma_tpu_torch.utils.checkpoint import (
    diffusers_to_torch_state_dict,
    load_safetensors_state_dict,
    save_pth,
    save_safetensors,
    torch_to_diffusers_state_dict,
)


def load_torch_state_dict(path: str):
    """A `.pth`'s weights ({"state_dict": ...} or a bare state dict) as f32."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: v.float() for k, v in ckpt.items()}


def to_diffusers(args):
    dsd = torch_to_diffusers_state_dict(load_torch_state_dict(args.src))
    save_safetensors(args.dst, dsd)
    print(f"wrote {len(dsd)} tensors to {args.dst}")


def to_pth(args):
    dsd = load_safetensors_state_dict(args.src)
    depth = max(int(k.split(".")[1]) for k in dsd if k.startswith("transformer_blocks.")) + 1
    sd = diffusers_to_torch_state_dict(dsd, depth=depth)
    save_pth(args.dst, sd)
    print(f"wrote {len(sd)} tensors to {args.dst}")


def merge(args):
    """alpha · a + (1 - alpha) · b over the keys both hold, in f32 numpy as
    JAX's tool computes it."""
    a, b = load_torch_state_dict(args.src), load_torch_state_dict(args.src2)
    merged = {k: torch.from_numpy(args.alpha * a[k].numpy() + (1 - args.alpha) * b[k].numpy())
              for k in a if k in b}
    save_pth(args.dst, merged)
    print(f"merged {len(merged)} tensors (alpha={args.alpha}) -> {args.dst}")


def main(argv=None):
    p = argparse.ArgumentParser(description="PixArt checkpoint conversion")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("to-diffusers", "to-pth"):
        s = sub.add_parser(name)
        s.add_argument("src")
        s.add_argument("dst")
    m = sub.add_parser("merge")
    m.add_argument("src")
    m.add_argument("src2")
    m.add_argument("dst")
    m.add_argument("--alpha", type=float, default=0.5)
    args = p.parse_args(argv)
    {"to-diffusers": to_diffusers, "to-pth": to_pth, "merge": merge}[args.cmd](args)


if __name__ == "__main__":
    main()
