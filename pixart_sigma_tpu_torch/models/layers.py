"""DiT building blocks: embedders, adaLN-single modulation, attention layers.

Port of pixart_sigma_tpu/models/layers.py. Parameter names follow the
upstream PixArt `.pth` checkpoints (`attn.qkv`, `attn.sr`, `attn.norm`,
`t_embedder.mlp.0`, ...), the names `utils.checkpoint.state_dict_from_jax`
emits. Token tensors are [B, N, C]; latents NHWC.

LayerNorms use eps 1e-6 as the JAX package does (flax's default; torch's is
1e-5). The KV-compression conv is depthwise, stride sr, no padding, and one
conv serves both K and V.

Every layer computes in the dtype of its input and casts its weights to it
at use (`Linear`, `Conv2d`, `LayerNorm`), as flax's `Dense(dtype=bf16)` uses
f32 params in bf16: a training model keeps f32 master weights and receives
f32 gradients, and for an inference model cast to bf16 the casts are no-ops.
The embedders that take raw inputs cast them to `dtype` (default: their
weights' dtype).

`quant=True` (the config's `quant_int8`, a serving mode) builds the block's
projections and MLP as `QuantLinear`, dynamic int8 (W8A8) products, where
the JAX package's `_dense(quant=)` builds `QuantDense`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pixart_sigma_tpu_torch.ops.attention import attention, seq_attention
from pixart_sigma_tpu_torch.ops.quant import int8_matmul_quantized, quantize_weight


class Linear(nn.Linear):
    """nn.Linear in its input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class QuantLinear(Linear):
    """`Linear` with a dynamic int8 (W8A8) product (`ops/quant.py`), the
    counterpart of JAX's `QuantDense`: the same parameter names and shapes,
    so every checkpoint loads unchanged.

    As `QuantDense` declares its kernel and bias f32 whatever the compute
    dtype, the weight and bias stay f32 when the module is cast (`.to(bf16)`
    moves them to the device only): the int8 weight is quantized from the
    f32 master, not from its bf16 cast, and the bias is added in f32. The
    quantized weight is kept per module, keyed on the weight's storage and
    version, so loading or changing the weight quantizes it anew.
    `Linear.forward(module, x)` is the unquantized product in the input's
    dtype (the caption K/V hoist takes it, as the JAX hoist does)."""

    def _apply(self, fn, recurse=True):
        # the target device, from an empty tensor: no cast copy of the weight
        return super()._apply(
            lambda t: t.to(fn(t.new_empty(0)).device) if t.is_floating_point() else fn(t),
            recurse)

    def quantized_weight(self):
        w = self.weight
        key = (w.data_ptr(), w.device, w._version)
        cached = getattr(self, "_qweight", None)
        if cached is None or cached[0] != key:
            with torch.no_grad():
                cached = (key, *quantize_weight(w.detach().float()))
            self._qweight = cached
        return cached[1], cached[2]

    def forward(self, x):
        qw, sw = self.quantized_weight()
        return int8_matmul_quantized(x, qw, sw, self.bias, out_dtype=x.dtype)


def _linear(in_features: int, out_features: int, quant: bool) -> Linear:
    return (QuantLinear if quant else Linear)(in_features, out_features)


class Conv2d(nn.Conv2d):
    """nn.Conv2d in its input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm in its input's dtype."""

    def forward(self, x):
        cast = lambda p: None if p is None else p.to(x.dtype)
        return F.layer_norm(x, self.normalized_shape, cast(self.weight), cast(self.bias),
                            self.eps)


def t2i_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor):
    """adaLN-single modulation: x * (1 + scale) + shift (broadcast over tokens)."""
    return x * (1 + scale) + shift


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class Mlp(nn.Module):
    """fc1 -> gelu(tanh) -> fc2."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 quant: bool = False):
        super().__init__()
        self.fc1 = _linear(in_features, hidden_features, quant)
        self.fc2 = _linear(hidden_features, out_features, quant)

    def forward(self, x):
        return self.fc2(gelu_tanh(self.fc1(x)))


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal features, [B] -> [B, dim] float32; cos first."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """Sinusoidal(256) -> Linear -> SiLU -> Linear."""

    def __init__(self, hidden_size: int, freq_embed_size: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.freq_embed_size = freq_embed_size
        self.dtype = dtype
        self.mlp = nn.Sequential(
            Linear(freq_embed_size, hidden_size), nn.SiLU(),
            Linear(hidden_size, hidden_size),
        )

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = timestep_embedding(t, self.freq_embed_size)
        return self.mlp(x.to(self.dtype or self.mlp[0].weight.dtype))


class SizeEmbedder(TimestepEmbedder):
    """Embed per-sample size scalars; [B, d] -> [B, d * hidden_size]."""

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        if s.ndim == 1:
            s = s[:, None]
        b, dims = s.shape
        return super().forward(s.reshape(-1)).reshape(b, -1)


class CaptionEmbedder(nn.Module):
    """Project caption features to the hidden size, with classifier-free
    caption dropout.

    `y_embedding` is the learned null caption. `force_drop_ids == 1` swaps a
    sample's caption for it; in training, without `force_drop_ids`, each
    sample is swapped with probability `uncond_prob`, drawn from `generator`
    (the JAX package draws from its 'caption_drop' rng stream, so the two
    drop different samples for the same seed).
    """

    def __init__(self, in_channels: int, hidden_size: int, token_num: int = 120,
                 uncond_prob: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.uncond_prob = uncond_prob
        self.dtype = dtype
        self.y_embedding = nn.Parameter(torch.randn(token_num, in_channels) / in_channels**0.5)
        self.y_proj = Mlp(in_channels, hidden_size, hidden_size)

    def forward(self, caption: torch.Tensor, force_drop_ids: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        drop = None
        if force_drop_ids is not None:
            drop = force_drop_ids == 1
        elif train and self.uncond_prob > 0:
            dev = generator.device if generator is not None else caption.device
            u = torch.rand((caption.shape[0],), generator=generator, device=dev)
            drop = (u < self.uncond_prob).to(caption.device)
        if drop is not None:
            caption = torch.where(drop[:, None, None], self.y_embedding.to(caption.dtype), caption)
        return self.y_proj(caption.to(self.dtype or self.y_proj.fc1.weight.dtype))


class PatchEmbed(nn.Module):
    """Patchify + linear: [B, H, W, C] -> [B, H/p * W/p, D] (a stride-p conv)."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = Conv2d(in_channels, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        p = self.patch_size
        if H % p or W % p:
            raise ValueError(f"{(H, W)} not divisible by patch size {p}")
        x = x.to(self.dtype or self.proj.weight.dtype).permute(0, 3, 1, 2)
        return self.proj(x).flatten(2).transpose(1, 2)


class SelfAttentionKVCompress(nn.Module):
    """Self-attention with optional Sigma KV token compression and QK-norm.

    KV compression downsamples K and V spatially by sr_ratio before attention:
    'conv' (depthwise conv k = s = sr, then a learned LayerNorm), 'ave' /
    'uniform' (strided subsample), 'uniform_every' (every sr-th token).
    QK-norm is a LayerNorm over the full model dim before the head split.

    `seq` (a `parallel.mesh.SeqContext`, set by `models.pixart.
    set_seq_parallel`) makes x this rank's token shard of the (h, w) grid
    `hw`: the keys are compressed on the shard when its rows are whole and
    divide by sr (then the compressed K/V are gathered, sr^2 times fewer
    bytes), else gathered first and compressed whole; `ops.attention.
    seq_attention` runs the attention.
    """

    seq = None

    def __init__(self, dim: int, num_heads: int, sampling: Optional[str] = None,
                 sr_ratio: int = 1, qk_norm: bool = False, attn_impl: str = "auto",
                 quant: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.sampling = sampling
        self.sr_ratio = sr_ratio
        self.attn_impl = attn_impl
        self.qkv = _linear(dim, 3 * dim, quant)
        self.proj = _linear(dim, dim, quant)
        if qk_norm:
            self.q_norm = LayerNorm(dim, eps=1e-6)
            self.k_norm = LayerNorm(dim, eps=1e-6)
        self.compress = sr_ratio > 1 and sampling is not None
        if self.compress and sampling == "conv":
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio, groups=dim)
            self.norm = LayerNorm(dim, eps=1e-6)
        elif self.compress and sampling not in ("ave", "uniform", "uniform_every"):
            raise ValueError(f"unknown sampling {sampling}")

    def _downsample(self, t: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """[B, N, C] -> [B, N / sr^2, C]."""
        sr = self.sr_ratio
        B, N, C = t.shape
        if self.sampling == "uniform_every":
            return t[:, ::sr]
        t = t.reshape(B, H, W, C)
        if self.sampling in ("ave", "uniform"):
            return t[:, ::sr, ::sr, :].reshape(B, -1, C)
        t = self.sr(t.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        return self.norm(t)

    def _local_rows(self, H: int, W: int) -> bool:
        """Whether each seq shard compresses its own tokens to its share of
        the whole grid's compressed keys."""
        s, sr = self.seq.size, self.sr_ratio
        if (H * W) % s:
            return False
        if self.sampling == "uniform_every":
            return (H * W // s) % sr == 0
        return H % s == 0 and (H // s) % sr == 0

    def forward(self, x: torch.Tensor, hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        B, N, C = x.shape
        H, W = hw if hw is not None else (int(N**0.5), int(N**0.5))
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        if hasattr(self, "q_norm"):
            q, k = self.q_norm(q), self.k_norm(k)
        heads = lambda t: t.unflatten(-1, (self.num_heads, C // self.num_heads))
        if self.seq is not None:
            return self.proj(self._seq_attention(heads, q, k, v, H, W).reshape(B, N, C))
        if self.compress:
            k, v = self._downsample(k, H, W), self._downsample(v, H, W)
        out = attention(heads(q), heads(k), heads(v), impl=self.attn_impl)
        return self.proj(out.reshape(B, N, C))

    def _seq_attention(self, heads, q, k, v, H: int, W: int) -> torch.Tensor:
        n_tokens, kv_sharded = H * W, True
        n_keys = n_tokens
        if self.compress and self._local_rows(H, W):
            k, v = (self._downsample(t, H // self.seq.size, W) for t in (k, v))
            n_keys = k.shape[1] * self.seq.size
        elif self.compress:
            k, v = (self._downsample(self.seq.gather_kv(t, n_tokens), H, W) for t in (k, v))
            n_keys, kv_sharded = k.shape[1], False
        return seq_attention(heads(q), heads(k), heads(v), self.seq, n_tokens=n_tokens,
                             n_keys=n_keys, kv_sharded=kv_sharded, impl=self.attn_impl)


class MultiHeadCrossAttention(nn.Module):
    """Image queries attend to padded caption keys / values.

    `kv` [B, L, 2C]: caption K/V computed once per trajectory
    (`models.pixart.precompute_cross_kv`); `proj` starts at zero.
    """

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "auto",
                 quant: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.q_linear = _linear(dim, dim, quant)
        self.kv_linear = _linear(dim, 2 * dim, quant)
        self.proj = _linear(dim, dim, quant)

    def forward(self, x, cond, mask=None, kv=None):
        B, N, C = x.shape
        q = self.q_linear(x)
        kv = self.kv_linear(cond) if kv is None else kv.to(q.dtype)
        k, v = kv.chunk(2, dim=-1)
        heads = lambda t: t.unflatten(-1, (self.num_heads, C // self.num_heads))
        out = attention(
            heads(q), heads(k), heads(v),
            key_mask=None if mask is None else mask.bool(), impl=self.attn_impl,
        )
        return self.proj(out.reshape(B, N, C))


class T2IFinalLayer(nn.Module):
    """Final LN + 2-way scale/shift from the t-embedding + projection."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.scale_shift_table = nn.Parameter(torch.randn(2, hidden_size) / hidden_size**0.5)
        self.norm_final = nn.LayerNorm(hidden_size, elementwise_affine=False, eps=1e-6)
        self.linear = Linear(hidden_size, patch_size**2 * out_channels)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        ss = self.scale_shift_table[None].to(x.dtype) + t[:, None].to(x.dtype)
        shift, scale = ss[:, 0:1], ss[:, 1:2]
        return self.linear(t2i_modulate(self.norm_final(x), shift, scale))


class PixArtBlock(nn.Module):
    """DiT block: adaLN-single self-attn + caption cross-attn + MLP."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 sampling: Optional[str] = None, sr_ratio: int = 1,
                 qk_norm: bool = False, attn_impl: str = "auto", quant: bool = False):
        super().__init__()
        D = hidden_size
        self.norm1 = nn.LayerNorm(D, elementwise_affine=False, eps=1e-6)
        self.attn = SelfAttentionKVCompress(D, num_heads, sampling, sr_ratio, qk_norm, attn_impl,
                                            quant)
        self.cross_attn = MultiHeadCrossAttention(D, num_heads, attn_impl, quant)
        self.norm2 = nn.LayerNorm(D, elementwise_affine=False, eps=1e-6)
        self.mlp = Mlp(D, int(D * mlp_ratio), D, quant)
        self.scale_shift_table = nn.Parameter(torch.randn(6, D) / D**0.5)

    def forward(
        self,
        x: torch.Tensor,  # [B, N, D]
        y: torch.Tensor,  # [B, L, D]
        t0: torch.Tensor,  # [B, 6 * D]
        y_mask: Optional[torch.Tensor] = None,  # [B, L]
        cross_kv: Optional[torch.Tensor] = None,  # [B, L, 2D] hoisted K/V
        hw: Optional[Tuple[int, int]] = None,
    ) -> torch.Tensor:
        B, N, D = x.shape
        mods = self.scale_shift_table[None].to(x.dtype) + t0.reshape(B, 6, D).to(x.dtype)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods.split(1, dim=1)
        x = x + gate_msa * self.attn(t2i_modulate(self.norm1(x), shift_msa, scale_msa), hw)
        x = x + self.cross_attn(x, y, y_mask, kv=cross_kv)
        return x + gate_mlp * self.mlp(t2i_modulate(self.norm2(x), shift_mlp, scale_mlp))


# The auxiliary blocks of the JAX package (models/layers.py:531-705), with
# the upstream PixArt_blocks.py module names; `utils.checkpoint.
# aux_state_dict_from_jax` carries a JAX param tree of any of them over.


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Classic DiT adaLN modulation, [B, D] shift and scale over the tokens."""
    return x * (1 + scale[:, None]) + shift[:, None]


class _AdaLNProjection(nn.Module):
    """LayerNorm (no affine), then adaLN modulation from the conditioning
    (SiLU -> Linear to 2 x `width`), then a Linear."""

    norm_name = "norm_final"

    def __init__(self, width: int, cond_width: int, out_features: int):
        super().__init__()
        self.add_module(self.norm_name, nn.LayerNorm(width, elementwise_affine=False, eps=1e-6))
        self.linear = Linear(width, out_features)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(cond_width, 2 * width))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c.to(x.dtype)).chunk(2, dim=-1)
        x = getattr(self, self.norm_name)(x)
        return self.linear(modulate(x, shift, scale))


class FinalLayer(_AdaLNProjection):
    """DiT final layer with per-sample adaLN: shift and scale from the
    conditioning through SiLU + Linear (T2IFinalLayer uses a shared table)."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__(hidden_size, hidden_size, patch_size**2 * out_channels)


class MaskFinalLayer(_AdaLNProjection):
    """The final layer of masked-token decoding, whose conditioning width
    `c_emb_size` may differ from the feature width."""

    def __init__(self, final_hidden_size: int, c_emb_size: int, patch_size: int,
                 out_channels: int):
        super().__init__(final_hidden_size, c_emb_size, patch_size**2 * out_channels)


class DecoderLayer(_AdaLNProjection):
    """adaLN-modulated projection into a decoder width (MAE-style heads)."""

    norm_name = "norm_decoder"

    def __init__(self, hidden_size: int, decoder_hidden_size: int):
        super().__init__(hidden_size, hidden_size, decoder_hidden_size)


class LabelEmbedder(nn.Module):
    """Class-label embedding with classifier-free label dropout: row
    `num_classes` is the learned null class, there when `dropout_prob` > 0.
    In training each label is dropped with probability `dropout_prob`,
    drawn from `generator`; `force_drop_ids == 1` drops it."""

    def __init__(self, num_classes: int, hidden_size: int, dropout_prob: float = 0.0):
        super().__init__()
        self.num_classes, self.dropout_prob = num_classes, dropout_prob
        self.embedding_table = nn.Embedding(num_classes + int(dropout_prob > 0), hidden_size)

    def forward(self, labels: torch.Tensor, train: bool = False,
                force_drop_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if (train and self.dropout_prob > 0) or force_drop_ids is not None:
            if self.dropout_prob <= 0:
                raise ValueError("force_drop_ids requires dropout_prob > 0 (the null-class "
                                 "embedding row only exists when CFG dropout is enabled)")
            if force_drop_ids is None:
                dev = generator.device if generator is not None else labels.device
                u = torch.rand(labels.shape, generator=generator, device=dev)
                drop = (u < self.dropout_prob).to(labels.device)
            else:
                drop = force_drop_ids == 1
            labels = torch.where(drop, self.num_classes, labels)
        return self.embedding_table(labels)


class CaptionEmbedderDoubleBr(nn.Module):
    """Double-branch caption embedder: a global embedding of the token
    mean (projected by an MLP) beside the per-token caption, each with its
    own learned null (`embedding`, `y_embedding`) swapped in when the
    caption is dropped (probability `uncond_prob` in training, from
    `generator`; or `force_drop_ids == 1`). Returns (global embedding
    [B, hidden], caption [B, 1, L, C])."""

    def __init__(self, in_channels: int, hidden_size: int, uncond_prob: float = 0.1,
                 token_num: int = 120):
        super().__init__()
        self.uncond_prob = uncond_prob
        self.embedding = nn.Parameter(torch.randn(1, in_channels) / 10**0.5)
        self.y_embedding = nn.Parameter(torch.randn(token_num, in_channels) / 10**0.5)
        self.proj = Mlp(in_channels, hidden_size, hidden_size)

    def forward(self, caption: torch.Tensor, train: bool = False,
                force_drop_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if caption.ndim == 3:
            caption = caption[:, None]
        global_caption = caption.mean(dim=2).reshape(caption.shape[0], -1)
        if (train and self.uncond_prob > 0) or force_drop_ids is not None:
            if force_drop_ids is None:
                dev = generator.device if generator is not None else caption.device
                u = torch.rand((caption.shape[0],), generator=generator, device=dev)
                drop = (u < self.uncond_prob).to(caption.device)
            else:
                drop = force_drop_ids == 1
            global_caption = torch.where(drop[:, None], self.embedding.to(global_caption.dtype),
                                         global_caption)
            caption = torch.where(drop[:, None, None, None], self.y_embedding.to(caption.dtype),
                                  caption)
        return self.proj(global_caption), caption
