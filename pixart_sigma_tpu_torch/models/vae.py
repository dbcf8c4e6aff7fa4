"""AutoencoderKL decoder (SD / SDXL VAE).

Port of the decode half of pixart_sigma_tpu/models/vae.py. Module names
follow diffusers' AutoencoderKL (`decoder.mid_block.resnets.0.conv1`, ...),
so `utils.checkpoint.vae_state_dict_from_jax` and diffusers checkpoints load
directly. NHWC at the public boundary, NCHW inside. The encoder and the
tiled 2K/4K decode are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from pixart_sigma_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.13025  # SDXL; SD1.5 uses 0.18215
    dtype: torch.dtype = torch.float32

    @classmethod
    def sdxl(cls, **kw) -> "VAEConfig":
        return cls(**kw)

    @classmethod
    def small_test(cls, **kw) -> "VAEConfig":
        base = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)
        base.update(kw)
        return cls(**base)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = _conv3(cin, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = _conv3(cout, cout)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention of the mid block (plain matmuls)."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).flatten(2).transpose(1, 2)  # [B, HW, C]
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        logits = torch.bmm(q, k.transpose(1, 2)).float() * C**-0.5
        h = torch.bmm(torch.softmax(logits, dim=-1).to(v.dtype), v)
        h = self.to_out[0](h)
        return x + h.transpose(1, 2).reshape(B, C, H, W)


class _MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(channels, channels, groups), ResnetBlock(channels, channels, groups)])
        self.attentions = nn.ModuleList([AttnBlock(channels, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv3(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n_resnets: int, groups: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(cin if j == 0 else cout, cout, groups) for j in range(n_resnets))
        if upsample:
            self.upsamplers = nn.ModuleList([_Upsample(cout)])

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = _conv3(cfg.latent_channels, ch[-1])
        self.mid_block = _MidBlock(ch[-1], g)
        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList(
            _UpBlock(rev[max(i - 1, 0)], c, cfg.layers_per_block + 1, g, i < len(ch) - 1)
            for i, c in enumerate(rev))
        self.conv_norm_out = nn.GroupNorm(g, ch[0], eps=1e-6)
        self.conv_out = _conv3(ch[0], cfg.in_channels)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """decode: [B, h, w, 4] unscaled latent -> [B, 8h, 8w, 3] image in ~[-1, 1]."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = z.to(self.post_quant_conv.weight.dtype).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)

    def load_diffusers_state_dict(self, sd) -> None:
        """Load the decoder half of a diffusers AutoencoderKL state dict."""
        keep = ("decoder.", "post_quant_conv.")
        self.load_state_dict({k: v for k, v in sd.items() if k.startswith(keep)}, strict=True)


def build_vae(cfg: VAEConfig, device: Union[str, torch.device] = "cuda") -> AutoencoderKL:
    dev = resolve_device(device)
    with dev:
        vae = AutoencoderKL(cfg)
    return vae.to(cfg.dtype).eval().requires_grad_(False)
