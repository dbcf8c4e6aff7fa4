"""MAE-style token masking for masked training: random, group, FFT- or
Laplacian-weighted keep sets, and the gather/scatter of kept tokens.

Port of pixart_sigma_tpu/ops/masking.py. The draw (a uniform [B, L] for
random/group, a Gumbel [B, L] for fft/laplacian) comes from the caller's
`torch.Generator`, or is passed in as `noise`: the same noise gives JAX's
ids exactly (the tests pass JAX's draw).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def get_mask(batch: int, length: int, mask_ratio: float, mask_type: str = "random",
             strength: Optional[torch.Tensor] = None, extra_len: int = 0, *,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """{'mask' [B, L] (0 keep, 1 remove), 'ids_keep', 'ids_restore',
    'ids_removed'}; `strength` [B, L] weights the fft/laplacian draw."""
    if mask_type not in ("random", "group", "fft", "laplacian"):
        raise ValueError(f"unknown mask_type {mask_type!r}")
    len_keep = int(length * (1 - mask_ratio)) - extra_len
    if device is None:
        device = noise.device if noise is not None else torch.device("cpu")
    if mask_type in ("random", "group"):
        if noise is None:
            gen_dev = generator.device if generator is not None else device
            noise = torch.rand((batch, length), generator=generator, device=gen_dev).to(device)
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    else:
        if strength is None:
            raise ValueError("fft/laplacian masking needs strengths")
        p = strength / (strength.max(dim=1, keepdim=True).values + 1e-5)
        p = torch.clamp(p, 1e-5, 1.0)
        if noise is None:  # Gumbel(0, 1)
            gen_dev = generator.device if generator is not None else device
            u = torch.rand((batch, length), generator=generator, device=gen_dev).to(device)
            noise = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        ids_shuffle = torch.argsort(-(torch.log(p) + noise), dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    mask = torch.ones((batch, length), device=ids_shuffle.device)
    mask[:, :len_keep] = 0
    return {"mask": torch.gather(mask, 1, ids_restore), "ids_keep": ids_shuffle[:, :len_keep],
            "ids_restore": ids_restore, "ids_removed": ids_shuffle[:, len_keep:]}


def fft_strength(img: torch.Tensor, patch: int) -> torch.Tensor:
    """Per-patch FFT magnitude: [B, H, W, C] -> [B, L]."""
    B, H, W, C = img.shape
    x = img.reshape(B, H // patch, patch, W // patch, patch, C)
    return torch.fft.fftn(x, dim=(2, 4)).abs().sum((2, 4, 5)).reshape(B, -1)


def laplacian_strength(img: torch.Tensor, patch: int) -> torch.Tensor:
    """Per-patch response of the 3x3 Laplacian (depthwise, zero padded)."""
    B, H, W, C = img.shape
    kernel = torch.tensor([[-1.0, -1, -1], [-1, 8, -1], [-1, -1, -1]], device=img.device)
    kernel = kernel.to(img.dtype).expand(C, 1, 3, 3)
    resp = F.conv2d(img.permute(0, 3, 1, 2), kernel, padding=1, groups=C).permute(0, 2, 3, 1)
    x = resp.reshape(B, H // patch, patch, W // patch, patch, C)
    return x.sum((2, 4, 5)).reshape(B, -1)


def mask_out_token(x: torch.Tensor, ids_keep: torch.Tensor) -> torch.Tensor:
    """[B, L, D] -> [B, len_keep, D], the kept tokens in ids_keep's order."""
    return torch.gather(x, 1, ids_keep[..., None].expand(-1, -1, x.shape[-1]))


def unmask_tokens(x: torch.Tensor, ids_restore: torch.Tensor,
                  mask_token: torch.Tensor) -> torch.Tensor:
    """Scatter kept tokens back to their places; removed ones get mask_token."""
    B, kept, D = x.shape
    L = ids_restore.shape[1]
    fill = mask_token.reshape(1, 1, D).to(x.dtype).expand(B, L - kept, D)
    x = torch.cat([x, fill], dim=1)
    return torch.gather(x, 1, ids_restore[..., None].expand(-1, -1, D))
