"""Text encoders: the T5 v1.1 encoder (T5-XXL) behind `T5Embedder`, and
the offline hash embedding `PseudoT5Embedder`.

Port of pixart_sigma_tpu/models/t5.py. The encoder follows the JAX
package's numerics: RMS layer norms in f32 returned in the compute dtype,
relative-position-bias attention with no 1/sqrt(d_kv) scale (layer 0 owns
the bias table and passes the bias down), f32 logits from f32-cast q and
k, masked keys set to -1e9, probabilities cast to the compute dtype before
the product with V, and a gated-GELU (tanh) feed-forward. The attention is
plain matmuls, as in the JAX package, which runs no kernel here either.
Module and parameter names are those of HF `T5EncoderModel`
(`shared.weight`, `encoder.block.{i}.layer.0.SelfAttention.q.weight`, ...),
so a released checkpoint loads directly.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pixart_sigma_tpu_torch.utils.device import resolve_device
from pixart_sigma_tpu_torch.utils.prompt import clean_caption


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def xxl(cls, **kw) -> "T5Config":
        return cls(**kw)

    @classmethod
    def small_test(cls, **kw) -> "T5Config":
        base = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
                    dtype=torch.float32)
        base.update(kw)
        return cls(**base)


class T5LayerNorm(nn.Module):
    """RMSNorm without bias or mean subtraction, in f32; returns `dtype`."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        x = x.float()
        x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + self.eps)
        return (x * self.weight.float()).to(self.dtype)


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 relative-position bucketing (host numpy)."""
    ret = np.zeros_like(relative_position)
    n = num_buckets // 2
    ret += (relative_position > 0).astype(np.int64) * n
    rp = np.abs(relative_position)
    max_exact = n // 2
    is_small = rp < max_exact
    large = max_exact + (
        np.log(np.maximum(rp, 1) / max_exact) / np.log(max_distance / max_exact)
        * (n - max_exact)).astype(np.int64)
    large = np.minimum(large, n - 1)
    ret += np.where(is_small, rp, large)
    return ret


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A bias-free Dense computed in `dtype`, as flax's Dense(dtype=...)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:  # only layer 0 owns the relative position bias table
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                        cfg.num_heads)

    def position_bias(self, L: int, device) -> torch.Tensor:
        """[1, H, L, L] from the bucket table (rows: queries, cols: keys)."""
        cfg = self.cfg
        pos = np.arange(L)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           cfg.relative_attention_num_buckets,
                                           cfg.relative_attention_max_distance)
        bias = self.relative_attention_bias.weight[torch.from_numpy(buckets).to(device)]
        return bias.permute(2, 0, 1)[None]

    def forward(self, x, mask, pos_bias=None):
        cfg = self.cfg
        B, L, _ = x.shape
        split = lambda t: t.view(B, L, cfg.num_heads, cfg.d_kv)
        q, k, v = (split(_linear(x, m, cfg.dtype)) for m in (self.q, self.k, self.v))
        if hasattr(self, "relative_attention_bias"):
            pos_bias = self.position_bias(L, x.device)
        # no 1/sqrt(d_kv) scale in T5
        logits = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) + pos_bias.float()
        logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
        probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
        out = torch.einsum("bhlm,bmhd->blhd", probs, v).reshape(B, L, -1)
        return _linear(out, self.o, cfg.dtype), pos_bias


class _SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype)


class _DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)


class _FeedForwardLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _DenseGatedGelu(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype)


class T5Block(nn.Module):
    """Pre-norm self-attention and gated-GELU feed-forward, each residual."""

    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.cfg = cfg
        self.layer = nn.ModuleList([_SelfAttentionLayer(cfg, has_bias), _FeedForwardLayer(cfg)])

    def forward(self, x, mask, pos_bias=None):
        attn, ff = self.layer
        out, pos_bias = attn.SelfAttention(attn.layer_norm(x), mask, pos_bias)
        x = x + out
        h = ff.layer_norm(x)
        dense, dt = ff.DenseReluDense, self.cfg.dtype
        h = F.gelu(_linear(h, dense.wi_0, dt), approximate="tanh") * _linear(h, dense.wi_1, dt)
        return x + _linear(h, dense.wo, dt), pos_bias


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList(T5Block(cfg, has_bias=(i == 0))
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, cfg.dtype)


class T5Encoder(nn.Module):
    """input_ids [B, L], attention_mask [B, L] -> final hidden states
    [B, L, d_model] in the config's dtype (the PixArt conditioning)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _Stack(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.shared.weight[input_ids].to(self.cfg.dtype)
        mask = attention_mask.bool()
        pos_bias = None
        for block in self.encoder.block:
            x, pos_bias = block(x, mask, pos_bias)
        return self.encoder.final_layer_norm(x)

    def load_hf_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """An HF `T5EncoderModel` state dict (`encoder.embed_tokens.weight`,
        tied to `shared.weight`, is dropped); every other key must match."""
        sd = {k: v for k, v in sd.items() if k != "encoder.embed_tokens.weight"}
        self.load_state_dict(sd, strict=True)


def build_t5(cfg: T5Config, device: Union[str, torch.device] = "cuda",
             param_dtype: Optional[torch.dtype] = None) -> T5Encoder:
    """An encoder on `device` with parameters in `param_dtype` (default: the
    compute dtype; T5-XXL's 4.76 B parameters take 9.5 GB in bf16), for
    inference."""
    with resolve_device(device):
        model = T5Encoder(cfg)
    return model.to(param_dtype or cfg.dtype).eval().requires_grad_(False)


@torch.no_grad()
def init_weights(model: T5Encoder, generator: torch.Generator) -> None:
    """Seeded random weights at HF's T5 initialisation scales (factor 1):
    the embedding N(0, 1); q N(0, (d_model d_kv)^-1/2), k and v
    N(0, d_model^-1/2), o N(0, (H d_kv)^-1/2); wi N(0, d_model^-1/2), wo
    N(0, d_ff^-1/2); norms 1. The bias table is N(0, 1), the JAX package's
    initialiser, where HF's N(0, d_model^-1/2) would leave the logits
    (~N(0, 1) at these scales) all but unbiased."""
    cfg = model.cfg
    std = {"q": (cfg.d_model * cfg.d_kv) ** -0.5, "k": cfg.d_model ** -0.5,
           "v": cfg.d_model ** -0.5, "o": (cfg.num_heads * cfg.d_kv) ** -0.5,
           "relative_attention_bias": 1.0, "wi_0": cfg.d_model ** -0.5,
           "wi_1": cfg.d_model ** -0.5, "wo": cfg.d_ff ** -0.5, "shared": 1.0}
    for name, p in model.named_parameters():
        module = name.rsplit(".", 2)[-2]
        if name.endswith("layer_norm.weight"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, std[module], generator=generator)


class T5Embedder:
    """Prompts -> (y [B, L, d_model], mask [B, L]) on the encoder's device:
    `clean_caption`, then `tokenizer(texts, max_length=model_max_length,
    padding="max_length", truncation=True, return_tensors="np")` (an HF
    tokenizer, or any object called the same way that returns `input_ids`
    and `attention_mask`), then the encoder. y is in the encoder's dtype
    (bf16 for T5-XXL)."""

    def __init__(self, encoder: T5Encoder, tokenizer, model_max_length: int = 300):
        self.encoder = encoder
        self.cfg = encoder.cfg
        self.tokenizer = tokenizer
        self.model_max_length = model_max_length

    @classmethod
    def from_pretrained(cls, path: str, model_max_length: int = 300,
                        dtype: torch.dtype = torch.bfloat16,
                        config: Optional[T5Config] = None,
                        device: Union[str, torch.device] = "cuda") -> "T5Embedder":
        """The tokenizer and weights of a local HF checkpoint directory
        (`*.safetensors` or `*.bin`); parameters in `dtype`. `config`
        overrides the architecture (default T5-XXL)."""
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError("T5Embedder.from_pretrained needs `transformers` for the "
                              "tokenizer") from e
        tokenizer = AutoTokenizer.from_pretrained(path)
        cfg = config if config is not None else T5Config.xxl(dtype=dtype)
        encoder = build_t5(cfg, device=device, param_dtype=dtype)
        encoder.load_hf_state_dict(_load_hf_state_dict(path))
        return cls(encoder, tokenizer, model_max_length)

    @torch.no_grad()
    def get_text_embeddings(self, texts):
        texts = [clean_caption(t) for t in texts]
        enc = self.tokenizer(texts, max_length=self.model_max_length, padding="max_length",
                             truncation=True, return_tensors="np")
        dev = self.encoder.shared.weight.device
        ids = torch.from_numpy(np.asarray(enc["input_ids"])).to(dev)
        mask = torch.from_numpy(np.asarray(enc["attention_mask"])).to(dev)
        return self.encoder(ids, mask), mask


def _load_hf_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Every `*.safetensors` file under `path`, else every `*.bin` file."""
    names = sorted(os.listdir(path))
    sd: Dict[str, torch.Tensor] = {}
    if any(f.endswith(".safetensors") for f in names):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"reading {path} needs `safetensors`") from e
        for f in names:
            if f.endswith(".safetensors"):
                sd.update(load_file(os.path.join(path, f)))
        return sd
    for f in names:
        if f.endswith(".bin"):
            sd.update(torch.load(os.path.join(path, f), map_location="cpu", weights_only=True))
    if not sd:
        raise FileNotFoundError(f"no *.safetensors or *.bin weights under {path}")
    return sd


class PseudoT5Embedder:
    """Offline hash embedding: each word maps to a fixed unit-variance fp16
    vector seeded by a stable hash, padded to model_max_length; the same
    features as the JAX package's embedder. Returns (y [B, L, dim] float32,
    mask [B, L] int32) on the CPU."""

    def __init__(self, dim: int = 64, model_max_length: int = 12):
        self.dim = dim
        self.model_max_length = model_max_length

    def get_text_embeddings(self, texts):
        B, L = len(texts), self.model_max_length
        y = np.zeros((B, L, self.dim), np.float32)
        mask = np.zeros((B, L), np.int32)
        for i, text in enumerate(texts):
            for j, word in enumerate(text.split()[:L]):
                seed = int.from_bytes(hashlib.sha256(word.encode()).digest()[:4], "little")
                y[i, j] = np.random.RandomState(seed).randn(self.dim).astype(np.float16)
                mask[i, j] = 1
        return torch.from_numpy(y), torch.from_numpy(mask)
