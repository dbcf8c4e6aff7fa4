"""Attention dispatcher over [B, N, H, Dh] (batch, tokens, heads, head dim).

The counterpart of pixart_sigma_tpu/ops/attention.py for one device. Padded
captions ride a [B, M] key mask (True = valid key).

impl:
- "reference": the plain einsum-softmax math (f32 softmax, masked keys at
  -1e30), the same function as the onepass and allheads kernels' plain
  version;
- "onepass": the self-attention kernel (`onepass_attention`);
- "allheads": the flat-layout masked cross-attention kernel;
- "flash": the long-sequence kernel (`flash_attention`, the JAX
  `flash_attention`'s function);
- "headsmajor": the forward-only masked cross-attention kernel
  (`crossattn_headsmajor`);
- "auto": on a CUDA tensor, `choose_impl`; on a CPU tensor, "reference".

Every choice but "headsmajor" is differentiable: the kernels through their
autograd Functions, whose backward runs the flash backward kernels, and
"reference" through torch's own autograd of the plain math.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from pixart_sigma_tpu_torch.ops.flash_attention import (
    allheads_supported,
    attention_reference,
    crossattn_allheads,
    crossattn_headsmajor,
    flash_attention,
    onepass_attention,
    onepass_supported,
)

KERNEL_IMPLS = ("onepass", "allheads", "flash", "headsmajor")
IMPLS = ("auto", "reference") + KERNEL_IMPLS
CROSSATTN_ENV = "PIXART_CROSSATTN_IMPL"


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_mask: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh) + mask) v -> [B, N, H, Dh]."""
    choice = _dispatch(q, k, v, key_mask) if impl == "auto" else impl
    if choice == "reference":
        return attention_reference(q, k, v, key_mask)
    if choice == "onepass":
        return onepass_attention(q, k, v, key_mask)
    if choice == "allheads":
        B, N, H, Dh = q.shape
        out = crossattn_allheads(
            q.flatten(2), k.flatten(2), v.flatten(2), key_mask, H)
        return out.unflatten(-1, (H, Dh))
    if choice == "flash":
        return flash_attention(q, k, v, key_mask=key_mask)
    if choice == "headsmajor":
        return crossattn_headsmajor(q, k, v, key_mask)
    raise ValueError(f"unknown attention impl {choice!r}; expected one of {IMPLS}")


def choose_impl(n: int, m: int, dh: int, masked: bool, needs_grad: bool = False) -> str:
    """The kernel "auto" takes on a CUDA tensor. Masked attention within the
    onepass gate honours `PIXART_CROSSATTN_IMPL` first, as the JAX dispatch
    does: it must name a kernel, and a forced "headsmajor" gives way to the
    differentiable kernels when a gradient is needed, as JAX training falls
    back to allheads. Then "allheads" (masked, <= 512 padded keys), "onepass"
    (<= 4096 padded keys), and "flash" for everything longer, masked or not.
    The TPU gates would pick XLA for short sequences; the port has no XLA and
    runs the kernels there too."""
    if masked and onepass_supported(n, m, dh):
        forced = os.environ.get(CROSSATTN_ENV)
        if forced and forced not in KERNEL_IMPLS:
            raise ValueError(f"unknown attention impl {forced!r} in {CROSSATTN_ENV}; "
                             f"expected one of {KERNEL_IMPLS}")
        if forced and not (forced == "headsmajor" and needs_grad):
            return forced
    if allheads_supported(n, m, True if masked else None):
        return "allheads"
    if onepass_supported(n, m, dh):
        return "onepass"
    return "flash"


def _dispatch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask) -> str:
    if q.device.type != "cuda":
        return "reference"
    needs_grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    return choose_impl(q.shape[1], k.shape[1], q.shape[-1], key_mask is not None, needs_grad)
