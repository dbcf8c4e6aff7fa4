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
- "chunked": `chunked_attention`, plain PyTorch online softmax over key
  chunks;
- "auto": on a CUDA tensor, `choose_impl`; on a CPU tensor, "reference".

Every choice but "headsmajor" is differentiable: the kernels through their
autograd Functions, whose backward runs the flash backward kernels, and
"reference" through torch's own autograd of the plain math.

Sequence (context) parallelism, the counterparts of the JAX module's
shard_map paths, over this rank's token shards and a seq group
(`parallel.mesh.SeqContext`):
- `seq_sharded_attention`: K/V gathered over the group, then the
  single-device dispatch (the kernels on a CUDA tensor) on the local query
  shard;
- `ring_attention`: K/V kept sharded and passed around the ring, plain
  PyTorch online softmax;
- `chunked_attention`: single-device online softmax over key chunks, plain
  PyTorch (JAX's is XLA);
- `seq_dispatch` picks among them by JAX's rule, and `seq_attention` runs
  the self-attention of a token shard through the pick.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from pixart_sigma_tpu_torch.ops.flash_attention import (
    NEG_INF,
    allheads_supported,
    attention_reference,
    crossattn_allheads,
    crossattn_headsmajor,
    flash_attention,
    onepass_attention,
    onepass_supported,
)

KERNEL_IMPLS = ("onepass", "allheads", "flash", "headsmajor")
IMPLS = ("auto", "reference", "chunked") + KERNEL_IMPLS
CROSSATTN_ENV = "PIXART_CROSSATTN_IMPL"
# seqshard gathers K/V whole on every rank; past this many bytes of gathered
# bf16 K+V the dispatch keeps them sharded and runs the ring (8K+ grids).
# Module-level so tests can lower it, as JAX's.
RING_KV_BYTES = 1 << 30
CAPTION_KEYS = 512  # keys up to which attention stays on the shard's own queries


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
    if choice == "chunked":
        return chunked_attention(q, k, v, key_mask=key_mask)
    raise ValueError(f"unknown attention impl {choice!r}; expected one of {IMPLS}")


def choose_impl(n: int, m: int, dh: int, masked: bool, needs_grad: bool = False) -> str:
    """The kernel "auto" takes on a CUDA tensor. Masked attention within the
    onepass gate honours `PIXART_CROSSATTN_IMPL` first, as the JAX dispatch
    does: it must name a kernel, and a forced "headsmajor" gives way to the
    differentiable kernels when a gradient is needed, as JAX training falls
    back to allheads. Then "allheads" (masked, <= 512 padded keys), "onepass"
    (<= 4096 padded keys, a head dim below its 128-lane padding), and "flash"
    for everything longer, masked or not, and for head dims on a multiple of
    128. The TPU gates would pick XLA for short sequences; the port has no
    XLA and runs the kernels there too. Every head dim runs: up to 256 the
    kernels' narrow forms, past it their wide form (Dh 288 onepass, 384
    flash, as the gates say)."""
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


def _online_softmax_step(state, q, kc, vc, mc, scale: float, dtype):
    """One key block of the online softmax, JAX's arithmetic: f32 logits
    and running max, sum and accumulator, the probabilities rounded to the
    input dtype for the product with V."""
    m, l, acc = state
    logits = torch.einsum("bnhd,bmhd->bhnm", q, kc.float()) * scale
    if mc is not None:
        logits = torch.where(mc[:, None, None, :].bool(), logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l = l * corr + p.sum(-1)
    pv = torch.einsum("bhnm,bmhd->bhnd", p.to(dtype).float(), vc.float())
    return m_new, l, acc * corr[..., None] + pv


def _online_softmax(q, blocks, dtype):
    """softmax(q k^T / sqrt(Dh)) v over the key blocks `blocks` (an iterable
    of (k, v, mask or None)) -> [B, N, H, Dh] in `dtype`."""
    B, N, H, Dh = q.shape
    state = (torch.full((B, H, N), NEG_INF, dtype=torch.float32, device=q.device),
             torch.zeros((B, H, N), dtype=torch.float32, device=q.device),
             torch.zeros((B, H, N, Dh), dtype=torch.float32, device=q.device))
    qf = q.float()
    for kc, vc, mc in blocks:
        state = _online_softmax_step(state, qf, kc, vc, mc, Dh**-0.5, dtype)
    _, l, acc = state
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      key_mask: Optional[torch.Tensor] = None, chunk: int = 1024
                      ) -> torch.Tensor:
    """Online-softmax attention over key chunks in plain PyTorch, the JAX
    `chunked_attention` (XLA there): no [N, M] logits, the live buffer is
    [B, H, N, chunk]. Keys are padded to a multiple of the chunk with
    masked zeros, as JAX pads them. Differentiable by autograd."""
    B, M = k.shape[0], k.shape[1]
    chunk = min(chunk, M)
    pad = (-M) % chunk
    if pad:
        if key_mask is None:
            key_mask = torch.ones((B, M), dtype=torch.bool, device=k.device)
        zeros = lambda t: t.new_zeros((B, pad) + t.shape[2:])
        k, v = torch.cat([k, zeros(k)], 1), torch.cat([v, zeros(v)], 1)
        key_mask = torch.cat([key_mask.bool(), zeros(key_mask).bool()], 1)
    blocks = ((k[:, i:i + chunk], v[:, i:i + chunk],
               None if key_mask is None else key_mask[:, i:i + chunk])
              for i in range(0, M + pad, chunk))
    return _online_softmax(q, blocks, q.dtype)


def seq_sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, seq,
                          key_mask: Optional[torch.Tensor] = None, inner_impl: str = "auto",
                          n_keys: Optional[int] = None) -> torch.Tensor:
    """Context-parallel attention with the keys gathered (JAX's
    `seq_sharded_attention`): q, k, v (and `key_mask`) are this rank's token
    shards; K/V are gathered whole over `seq`'s group (their first `n_keys`,
    all by default) and the single-device `attention` runs on the local
    queries with `inner_impl`, the kernels on a CUDA tensor. The backward
    reduce-scatters each rank's partial dK/dV to the owner."""
    n = k.shape[1] * seq.size if n_keys is None else n_keys
    k, v = seq.gather_kv(k, n), seq.gather_kv(v, n)
    if key_mask is not None:
        key_mask = seq.gather_kv(key_mask.to(torch.uint8), n).bool()
    return attention(q, k, v, key_mask=key_mask, impl=inner_impl)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, seq,
                   key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ring attention (JAX's `ring_attention`): q, k, v (and `key_mask`)
    are this rank's token shards and K/V stay sharded; each of the `size`
    steps folds the K/V block held into the online softmax (f32 running
    max, sum and accumulator, as JAX) and passes it, with its mask, to the
    right neighbour (`parallel.dist.ring_shift`). Plain PyTorch,
    differentiable by autograd: the backward passes the gradients back
    around the ring."""
    from pixart_sigma_tpu_torch.parallel.dist import ring_shift

    def blocks():
        kc, vc = k, v
        mc = None if key_mask is None else key_mask.to(torch.uint8)
        for _ in range(seq.size):
            yield kc, vc, mc
            kc, vc = ring_shift(kc, seq.group), ring_shift(vc, seq.group)
            if mc is not None:
                mc = ring_shift(mc, seq.group)

    return _online_softmax(q, blocks(), q.dtype)


def seq_dispatch(n_tokens: int, n_keys: int, batch: int, heads: int, head_dim: int,
                 seq_size: int) -> str:
    """JAX's sequence-parallel dispatch (`_dispatch` under a seq mesh), on
    the global token and key counts and the local batch: keys up to 512
    (captions) stay "local" (JAX's plain path; the shard's queries against
    whole keys); tokens that do not divide the group take "chunked"; past
    `RING_KV_BYTES` of gathered bf16 K+V, with keys that divide the group,
    "ring"; else "seqshard"."""
    if n_keys <= CAPTION_KEYS:
        return "local"
    if n_tokens % seq_size:
        return "chunked"
    if 2 * 2 * batch * n_keys * heads * head_dim > RING_KV_BYTES and n_keys % seq_size == 0:
        return "ring"
    return "seqshard"


def seq_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq, *, n_tokens: int,
                  n_keys: int, kv_sharded: bool = True, impl: str = "auto") -> torch.Tensor:
    """The self-attention of this rank's query shard [b, n, H, Dh] of
    `n_tokens` tokens against `n_keys` keys: k and v are this rank's shards
    (`kv_sharded`) or the whole keys. "auto" takes `seq_dispatch`'s pick; a
    kernel or "reference" named by `impl` runs on the shard as "seqshard"
    would, or "chunked" when the tokens do not divide the group, as JAX
    redirects a forced kernel through its shard_map. "local" and
    "seqshard" are one computation here: the keys gathered whole, the
    single-device dispatch on the shard."""
    b, _, heads, dh = q.shape
    if impl == "auto":
        choice = seq_dispatch(n_tokens, n_keys, b, heads, dh, seq.size)
        inner = "auto"
    else:
        choice = "seqshard" if n_tokens % seq.size == 0 else "chunked"
        inner = impl
    if choice == "ring":
        if not kv_sharded:
            k, v = seq.shard(k), seq.shard(v)
        return ring_attention(q, k, v, seq=seq)
    if choice == "chunked":
        inner = "chunked"
    if kv_sharded:
        return seq_sharded_attention(q, k, v, seq=seq, inner_impl=inner, n_keys=n_keys)
    return attention(q, k, v, impl=inner)
