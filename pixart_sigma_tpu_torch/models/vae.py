"""AutoencoderKL (SD / SDXL VAE): the encoder and the decoder.

Port of pixart_sigma_tpu/models/vae.py. Module names follow diffusers'
AutoencoderKL (`decoder.mid_block.resnets.0.conv1`, ...), so
`utils.checkpoint.vae_state_dict_from_jax` and diffusers checkpoints load
directly. NHWC at the public boundary, NCHW inside. `tiled_decode` decodes
2K/4K latents tile by tile. The mid blocks' single-head attention is plain
matmuls over all H/8 x W/8 tokens, as in the JAX package: its f32 logits
take 64 MiB per image at 512px, 1 GiB at 1024px and 16 GiB at 2048px.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

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


class _Downsample(nn.Module):
    """Stride-2 conv after a (0, 1) x (0, 1) zero pad, as diffusers."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n_resnets: int, groups: int, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(cin if j == 0 else cout, cout, groups) for j in range(n_resnets))
        if downsample:
            self.downsamplers = nn.ModuleList([_Downsample(cout)])

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        return x


class Encoder(nn.Module):
    """[B, 3, H, W] -> [B, 2 * latent_channels, H/8, W/8] moments."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = _conv3(cfg.in_channels, ch[0])
        self.down_blocks = nn.ModuleList(
            _DownBlock(ch[max(i - 1, 0)], c, cfg.layers_per_block, g, i < len(ch) - 1)
            for i, c in enumerate(ch))
        self.mid_block = _MidBlock(ch[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = _conv3(ch[-1], 2 * cfg.latent_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


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
    """encode: [B, H, W, 3] image in [-1, 1] -> (mean, logvar), each
    [B, H/8, W/8, 4]; decode: [B, h, w, 4] unscaled latent -> [B, 8h, 8w, 3]
    image in ~[-1, 1]."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.decoder = Decoder(cfg)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def encode(self, x: torch.Tensor):
        """The posterior's mean and log-variance (clamped to [-30, 20])."""
        x = x.to(self.quant_conv.weight.dtype).permute(0, 3, 1, 2)
        moments = self.quant_conv(self.encoder(x)).permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = z.to(self.post_quant_conv.weight.dtype).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)

    def load_diffusers_state_dict(self, sd) -> None:
        """Load a diffusers AutoencoderKL state dict; every key must match."""
        self.load_state_dict(sd, strict=True)


def posterior_sample(mean: torch.Tensor, logvar: torch.Tensor,
                     noise: torch.Tensor) -> torch.Tensor:
    """The posterior's sample mean + exp(logvar / 2) * noise."""
    return mean + torch.exp(0.5 * logvar) * noise.to(mean.device, mean.dtype)


def build_vae(cfg: VAEConfig, device: Union[str, torch.device] = "cuda") -> AutoencoderKL:
    dev = resolve_device(device)
    with dev:
        vae = AutoencoderKL(cfg)
    return vae.to(cfg.dtype).eval().requires_grad_(False)


def load_diffusers_vae(path: str, cfg: Optional[VAEConfig] = None,
                       device: Union[str, torch.device] = "cuda") -> AutoencoderKL:
    """A VAE (default: the SDXL one) from a diffusers AutoencoderKL
    `.safetensors` file."""
    try:
        from safetensors.torch import load_file
    except ImportError as e:
        raise ImportError(f"reading {path} needs `safetensors`") from e
    vae = build_vae(cfg or VAEConfig.sdxl(), device=device)
    vae.load_diffusers_state_dict(load_file(path))
    return vae


def _blend_profile(size: int, fade_lo: bool, fade_hi: bool, ramp: int, device) -> torch.Tensor:
    """[size] f32 weights: min(1, (i + 0.5) / ramp) rising from a faded low
    edge and the mirror image towards a faded high edge."""
    prof = torch.ones(size, dtype=torch.float32, device=device)
    ramp = min(ramp, size)
    if ramp > 1:
        idx = torch.arange(size, dtype=torch.float32, device=device)
        if fade_lo:
            prof = torch.minimum(prof, (idx + 0.5) / ramp)
        if fade_hi:
            prof = torch.minimum(prof, (size - 0.5 - idx) / ramp)
    return prof


def tiled_decode(
    decode_fn: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,  # [B, h, w, C] latents
    tile: int = 64,
    overlap: int = 16,
) -> torch.Tensor:
    """Decode latents tile by tile with linear blending on the overlaps ->
    [B, h * f, w * f, out_c] f32 (f: the decoder's upscale).

    The semantics of the JAX package's `make_tiled_decode` and `tiled_decode`:
    tiles of `tile` latents at a stride of tile - overlap, the last ones
    clamped to the edge so that every tile is full-size; each decoded tile is
    weighted by min(1, (i + 0.5) / ramp) ramps (ramp = overlap * f) on its
    interior edges, summed into an f32 canvas and weight map, and the canvas
    is divided by max(weights, 1e-8). A host loop over tiles; each call
    decodes all B images of one tile, so memory stays at one tile's decoder
    activations plus the canvas (200 MB at 4K). Latents within one tile are
    decoded whole.
    """
    B, h, w, _ = z.shape
    if h <= tile and w <= tile:
        return decode_fn(z).float()
    stride = tile - overlap
    out = weight = None
    for y0 in range(0, max(h - overlap, 1), stride):
        for x0 in range(0, max(w - overlap, 1), stride):
            y1, x1 = min(y0 + tile, h), min(x0 + tile, w)
            ya, xa = max(0, y1 - tile), max(0, x1 - tile)
            dec = decode_fn(z[:, ya:y1, xa:x1]).float()
            f = dec.shape[1] // (y1 - ya)
            if out is None:
                out = torch.zeros((B, h * f, w * f, dec.shape[-1]), dtype=torch.float32,
                                  device=dec.device)
                weight = torch.zeros((1, h * f, w * f, 1), dtype=torch.float32,
                                     device=dec.device)
            wy = _blend_profile(dec.shape[1], ya > 0, y1 < h, overlap * f, dec.device)
            wx = _blend_profile(dec.shape[2], xa > 0, x1 < w, overlap * f, dec.device)
            wmap = (wy[:, None] * wx[None, :])[None, :, :, None]
            out[:, ya * f : y1 * f, xa * f : x1 * f] += dec * wmap
            weight[:, ya * f : y1 * f, xa * f : x1 * f] += wmap
    return out / weight.clamp_min(1e-8)
