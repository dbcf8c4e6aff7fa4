"""Attention dispatcher over [B, N, H, Dh] (batch, tokens, heads, head dim).

The counterpart of pixart_sigma_tpu/ops/attention.py for one device. Padded
captions ride a [B, M] key mask (True = valid key).

impl:
- "reference": the plain einsum-softmax math (f32 softmax, masked keys at
  -1e30), the same function as the kernels' plain version;
- "onepass": the self-attention kernel (`onepass_attention`);
- "allheads": the flat-layout masked cross-attention kernel;
- "auto": on a CUDA tensor, "allheads" for masked attention over <= 512
  padded keys, else "onepass" while its gate holds (<= 4096 padded keys),
  the same choice the TPU dispatch makes at 1024px; longer key sequences
  need the flash kernel, which is not ported yet, and raise. On a CPU tensor
  "auto" runs "reference".

Every choice is differentiable: "onepass" and "allheads" through their
autograd Functions, whose backward runs the flash backward kernels, and
"reference" through torch's own autograd of the plain math.
"""

from __future__ import annotations

from typing import Optional

import torch

from pixart_sigma_tpu_torch.ops.flash_attention import (
    allheads_supported,
    attention_reference,
    crossattn_allheads,
    onepass_attention,
    onepass_supported,
)

IMPLS = ("auto", "reference", "onepass", "allheads")


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_mask: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh) + mask) v -> [B, N, H, Dh]."""
    choice = _dispatch(q, k, key_mask) if impl == "auto" else impl
    if choice == "reference":
        return attention_reference(q, k, v, key_mask)
    if choice == "onepass":
        return onepass_attention(q, k, v, key_mask)
    if choice == "allheads":
        B, N, H, Dh = q.shape
        out = crossattn_allheads(
            q.flatten(2), k.flatten(2), v.flatten(2), key_mask, H)
        return out.unflatten(-1, (H, Dh))
    raise ValueError(f"unknown attention impl {impl!r}; expected one of {IMPLS}")


def _dispatch(q: torch.Tensor, k: torch.Tensor, key_mask) -> str:
    if q.device.type != "cuda":
        return "reference"
    N, M, Dh = q.shape[1], k.shape[1], q.shape[-1]
    if allheads_supported(N, M, key_mask):
        return "allheads"
    if onepass_supported(N, M, Dh):
        return "onepass"
    raise NotImplementedError(
        f"attention over {M} keys needs the flash kernel (_fwd_kernel), which "
        "is not ported yet (ROADMAP.md, Queue 1: 2K/4K sampling)"
    )
