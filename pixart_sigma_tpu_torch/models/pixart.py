"""PixArt / PixArtMS diffusion transformers.

Port of pixart_sigma_tpu/models/pixart.py: the same config fields, NHWC
latents in and an f32 NHWC prediction out, the blocks unrolled in an
`nn.ModuleList` (`blocks.<i>`, the upstream `.pth` names). The model
computes in `cfg.dtype` whatever its weights' dtype: an inference model is
cast to it, a training model keeps f32 master weights (`train=True` in the
builders), as the JAX package's flax modules keep f32 params under a bf16
compute dtype.

`grad_checkpointing` recomputes each block in the backward
(`torch.utils.checkpoint`) under the JAX package's `remat_policy`:
"nothing" keeps only the block's inputs; "dots" and "dots_no_batch" also
keep the outputs of the matmuls (with or without batch dims: bmm or mm);
"save_attn" keeps the attention kernels' outputs, so the recompute skips
their launches; "everything" keeps all, as no checkpointing does. The
last three are selective-checkpoint policies over the dispatched ops, the
attention launches being ops of their own (`ATTENTION_FORWARD_OPS`).

`mask_ratio > 0` adds the `mask_token` parameter and, in training, runs the
blocks on a random subset of the tokens (MAE-style), returning
(output, token_mask). Not ported yet: block caching and int8 matmuls; a
config that asks for them raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from pixart_sigma_tpu_torch.models.layers import (
    CaptionEmbedder,
    Linear,
    PatchEmbed,
    PixArtBlock,
    SizeEmbedder,
    T2IFinalLayer,
    TimestepEmbedder,
)
from pixart_sigma_tpu_torch.ops.flash_attention import ATTENTION_FORWARD_OPS
from pixart_sigma_tpu_torch.ops.masking import get_mask, mask_out_token, unmask_tokens
from pixart_sigma_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed
from pixart_sigma_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PixArtConfig:
    """All architecture knobs; the fields of the JAX package's PixArtConfig."""

    input_size: int = 32  # latent grid (input px / 8)
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    class_dropout_prob: float = 0.1
    pred_sigma: bool = True
    caption_channels: int = 4096
    pe_interpolation: float = 1.0
    model_max_length: int = 120
    micro_condition: bool = False
    qk_norm: bool = False
    kv_compress_sampling: Optional[str] = None  # 'conv'|'ave'|'uniform'|'uniform_every'
    kv_compress_scale: int = 1
    kv_compress_layers: Tuple[int, ...] = ()
    multi_scale: bool = True
    mask_ratio: float = 0.0
    mask_type: str = "random"
    dtype: torch.dtype = torch.bfloat16
    fp32_attention: bool = False  # the softmax is always f32 here
    attn_impl: str = "auto"
    quant_int8: bool = False
    grad_checkpointing: bool = False
    remat_policy: str = "nothing"
    scan_blocks: bool = True  # layout of the JAX param tree; blocks run unrolled
    cache_span: Optional[Tuple[int, int]] = None

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.pred_sigma else self.in_channels

    @property
    def base_size(self) -> int:
        return self.input_size // self.patch_size

    def sr_ratio(self, layer: int) -> int:
        if layer in self.kv_compress_layers and self.kv_compress_sampling:
            return int(self.kv_compress_scale)
        return 1

    def block_groups(self) -> list[tuple[int, int]]:
        """Runs of consecutive layers with identical sr_ratio: [(sr, count)]
        (the JAX package's scan groups; `cache_span` splits them)."""
        splits = set(self.cache_span) if self.cache_span is not None else set()
        groups: list[tuple[int, int]] = []
        for i in range(self.depth):
            sr = self.sr_ratio(i)
            if groups and groups[-1][0] == sr and i not in splits:
                groups[-1] = (sr, groups[-1][1] + 1)
            else:
                groups.append((sr, 1))
        return groups


_NOT_PORTED = {"quant_int8": False, "cache_span": None}
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_MATMULS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
# remat_policy -> the ops whose outputs a checkpointed block keeps (None: only
# its inputs; "all": everything, so the block is not checkpointed)
REMAT_SAVED = {
    "nothing": None,
    "dots": _MATMULS + _BATCHED_MATMULS,
    "dots_no_batch": _MATMULS,
    "save_attn": ATTENTION_FORWARD_OPS,
    "everything": "all",
}


def _save_ops(ops, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE


class PixArt(nn.Module):
    """The DiT denoiser. Call with NHWC latents; returns the f32 NHWC prediction."""

    def __init__(self, cfg: PixArtConfig):
        super().__init__()
        for name, default in _NOT_PORTED.items():
            if getattr(cfg, name) != default:
                raise NotImplementedError(
                    f"PixArtConfig.{name} is not ported yet (ROADMAP.md, Queue 1)")
        if cfg.remat_policy not in REMAT_SAVED:
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; expected one of "
                             f"{sorted(REMAT_SAVED)}")
        self.cfg = cfg
        self._pos_cache: dict = {}
        D, dt = cfg.hidden_size, cfg.dtype
        self.x_embedder = PatchEmbed(cfg.patch_size, cfg.in_channels, D, dtype=dt)
        self.t_embedder = TimestepEmbedder(D, dtype=dt)
        if cfg.micro_condition:
            self.csize_embedder = SizeEmbedder(D // 3, dtype=dt)
            self.ar_embedder = SizeEmbedder(D // 3, dtype=dt)
        self.t_block = nn.Sequential(nn.SiLU(), Linear(D, 6 * D))
        self.y_embedder = CaptionEmbedder(cfg.caption_channels, D, cfg.model_max_length,
                                          uncond_prob=cfg.class_dropout_prob, dtype=dt)
        self.blocks = nn.ModuleList(
            PixArtBlock(
                D, cfg.num_heads, cfg.mlp_ratio, sampling=cfg.kv_compress_sampling,
                sr_ratio=cfg.sr_ratio(i), qk_norm=cfg.qk_norm, attn_impl=cfg.attn_impl,
            )
            for i in range(cfg.depth)
        )
        self.final_layer = T2IFinalLayer(D, cfg.patch_size, cfg.out_channels)
        if cfg.mask_ratio > 0:  # in the tree whenever masking is on, train or eval
            self.mask_token = nn.Parameter(torch.zeros(1, 1, D))

    def forward(
        self,
        x: torch.Tensor,  # [B, H, W, in_channels]
        timestep: torch.Tensor,  # [B]
        y: torch.Tensor,  # [B, L, caption_channels]
        y_mask: Optional[torch.Tensor] = None,  # [B, L]; 1 = valid token
        img_hw: Optional[torch.Tensor] = None,  # [B, 2] micro-cond size
        aspect_ratio: Optional[torch.Tensor] = None,  # [B, 1]
        force_drop_ids: Optional[torch.Tensor] = None,
        cross_kv: Optional[Sequence[torch.Tensor]] = None,  # per layer [B, L, 2D]
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        mask_noise: Optional[torch.Tensor] = None,  # [B, h * w] uniform, masked training
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """`cross_kv` (from `precompute_cross_kv`) replaces the caption
        embedder and every block's kv_linear, which depend on the captions
        only and so are paid once per trajectory. `train` turns on random
        caption dropout and, with `mask_ratio`, token masking, drawn from
        `generator` in that order: the mask first (or `mask_noise`, the
        uniform draw that orders the tokens), then the drops. A masked
        training call returns (output, token_mask [B, h * w], 1 = removed)."""
        cfg = self.cfg
        B, H, W, _ = x.shape
        p = cfg.patch_size
        h, w = H // p, W // p
        if not cfg.multi_scale and h != w:
            raise ValueError("fixed-resolution PixArt expects a square grid")
        if train and cross_kv is not None:
            raise ValueError("cross_kv hoisting is an inference-only path")
        x = self.x_embedder(x) + self.pos_embed(h, w, x.device)[None]
        mask_info = None
        if train and cfg.mask_ratio > 0:
            if cfg.mask_type not in ("random", "group"):
                raise ValueError(f"mask_type {cfg.mask_type!r}: training masks 'random' or "
                                 "'group'")
            if any(cfg.sr_ratio(i) != 1 for i in range(cfg.depth)):
                raise ValueError("mask_ratio is incompatible with KV compression (the kept "
                                 "token subset has no spatial grid to downsample)")
            mask_info = get_mask(B, h * w, cfg.mask_ratio, cfg.mask_type, generator=generator,
                                 noise=mask_noise, device=x.device)
            x = mask_out_token(x, mask_info["ids_keep"])
        t = self.t_embedder(timestep)  # [B, D]
        if cfg.micro_condition:
            if img_hw is None or aspect_ratio is None:
                raise ValueError("micro_condition needs img_hw and aspect_ratio")
            csize = self.csize_embedder(img_hw)
            ar = self.ar_embedder(aspect_ratio)
            t = t + torch.cat([csize, ar], dim=1)
        t0 = self.t_block(t)
        if cross_kv is None:
            y = self.y_embedder(y, force_drop_ids, train=train, generator=generator)
        if y_mask is None:
            y_mask = torch.ones(y.shape[:2], dtype=torch.int32, device=y.device)
        saved = REMAT_SAVED[cfg.remat_policy]
        remat = cfg.grad_checkpointing and torch.is_grad_enabled() and saved != "all"
        context_fn = noop_context_fn if saved is None else functools.partial(
            create_selective_checkpoint_contexts, functools.partial(_save_ops, saved))
        for i, block in enumerate(self.blocks):
            kv = None if cross_kv is None else cross_kv[i]
            if remat:  # recompute the block in the backward, keeping what the policy saves
                x = checkpoint(block, x, y, t0, y_mask, kv, (h, w), use_reentrant=False,
                               preserve_rng_state=False, context_fn=context_fn)
            else:
                x = block(x, y, t0, y_mask, cross_kv=kv, hw=(h, w))
        if mask_info is not None:
            x = unmask_tokens(x, mask_info["ids_restore"], self.mask_token)
        x = self.final_layer(x, t)
        out = self.unpatchify(x, h, w).float()
        return out if mask_info is None else (out, mask_info["mask"])

    def pos_embed(self, h: int, w: int, device: torch.device) -> torch.Tensor:
        """[h * w, D] sin-cos positional embedding in cfg.dtype on `device`,
        converted and copied once per (h, w, dtype, device) and kept (75 MB of
        f32 host data per call at 2K, 302 MB at 4K)."""
        cfg = self.cfg
        key = (h, w, cfg.dtype, torch.device(device))
        if key not in self._pos_cache:
            pos = get_2d_sincos_pos_embed(cfg.hidden_size, h, w,
                                          pe_interpolation=cfg.pe_interpolation,
                                          base_size=cfg.base_size)
            self._pos_cache[key] = torch.from_numpy(pos).to(device, cfg.dtype)
        return self._pos_cache[key]

    def unpatchify(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """[B, h*w, p*p*C] -> [B, h*p, w*p, C] (token vector order (p, q, c))."""
        p, c = self.cfg.patch_size, self.cfg.out_channels
        x = x.reshape(x.shape[0], h, w, p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(x.shape[0], h * p, w * p, c)

    def forward_with_dpmsolver(self, x, timestep, y, y_mask=None, **kwargs):
        """Only the eps half of the output."""
        return self(x, timestep, y, y_mask, **kwargs)[..., : self.cfg.in_channels]


def precompute_cross_kv(model: PixArt, y: torch.Tensor) -> list:
    """Caption K/V of every block, [B, L, 2D] each, once per trajectory:
    y -> y_proj MLP -> each block's kv_linear. Inference only."""
    emb = model.y_embedder.y_proj(y.to(model.cfg.dtype))
    return [block.cross_attn.kv_linear(emb) for block in model.blocks]


@torch.no_grad()
def init_weights(model: PixArt, generator: torch.Generator) -> PixArt:
    """Random weights drawn as the JAX package initialises them: xavier
    linears, N(0, 0.02) embedders, zero cross-attention `proj` and final
    `linear` (blocks start as identity), averaging KV-compression convs."""
    D = model.cfg.hidden_size
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            if name.startswith(("t_embedder", "csize_embedder", "ar_embedder",
                                "t_block", "y_embedder")):
                mod.weight.normal_(0.0, 0.02, generator=generator)
            elif name.endswith("cross_attn.proj") or name == "final_layer.linear":
                mod.weight.zero_()
            else:
                nn.init.xavier_uniform_(mod.weight, generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm) and mod.weight is not None:
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    proj = model.x_embedder.proj
    nn.init.xavier_uniform_(proj.weight.view(D, -1), generator=generator)
    proj.bias.zero_()
    for block in model.blocks:
        if hasattr(block.attn, "sr"):
            block.attn.sr.weight.fill_(1.0 / block.attn.sr_ratio**2)
            block.attn.sr.bias.zero_()
        block.scale_shift_table.normal_(0.0, D**-0.5, generator=generator)
    model.final_layer.scale_shift_table.normal_(0.0, D**-0.5, generator=generator)
    if hasattr(model, "mask_token"):
        model.mask_token.normal_(0.0, 0.02, generator=generator)
    c = model.cfg.caption_channels
    model.y_embedder.y_embedding.normal_(0.0, c**-0.5, generator=generator)
    return model


def _build(overrides: dict, device: Union[str, torch.device], train: bool) -> PixArt:
    """An inference model (weights cast to cfg.dtype, frozen) or, with
    `train`, a training model (f32 master weights that take gradients)."""
    dev = resolve_device(device)
    cfg = PixArtConfig(**overrides)
    with dev:
        model = PixArt(cfg)
    if train:
        return model.float().train().requires_grad_(True)
    return model.to(cfg.dtype).eval().requires_grad_(False)


def PixArt_XL_2(device: Union[str, torch.device] = "cuda", train: bool = False,
                **overrides) -> PixArt:
    """0.6B fixed-resolution model."""
    overrides.setdefault("multi_scale", False)
    kw = dict(depth=28, hidden_size=1152, patch_size=2, num_heads=16)
    kw.update(overrides)
    return _build(kw, device, train)


def PixArtMS_XL_2(device: Union[str, torch.device] = "cuda", train: bool = False,
                  **overrides) -> PixArt:
    """0.6B multi-scale model."""
    overrides.setdefault("multi_scale", True)
    kw = dict(depth=28, hidden_size=1152, patch_size=2, num_heads=16)
    kw.update(overrides)
    return _build(kw, device, train)
