"""The two attention kernels of the sampling path, each beside its plain version.

- `onepass_attention` (self-attention, [B, N, H, Dh]) runs
  `csrc/onepass_attention.cu`, the counterpart of the TPU kernel
  `_onepass_kernel` (pixart_sigma_tpu/ops/flash_attention.py).
- `crossattn_allheads` (masked caption cross-attention on the flat [B, N, C]
  layout) runs `csrc/allheads_attention.cu`, the counterpart of
  `_allheads_kernel`.

Both compute softmax(q k^T / sqrt(Dh) + mask) v with an f32 softmax; masked
keys get the finite logit -1e30, as in the TPU kernels, so a row whose keys
are all masked averages its values instead of turning into NaN. They take
bf16 or f32 and return the input dtype; f32 inputs are rounded to bf16 for
the two tensor-core products (the precision of an f32 dot at default
precision on the TPU), while the softmax and accumulation stay f32. On a CPU
tensor each wrapper runs the plain PyTorch version (`attention_reference`);
on a CUDA tensor it launches its kernel or raises. Each wrapper counts its
launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from pixart_sigma_tpu_torch.ops import _build

NEG_INF = -1e30  # finite stand-in for -inf, as in the TPU kernels
LOG2E = 1.4426950408889634
ONEPASS_MAX_KV = 4096  # padded keys, as the TPU gate (onepass_supported)
ALLHEADS_MAX_KV = 512  # keys the allheads kernel keeps in shared memory
MAX_HEAD_DIM = 80  # the kernels pad the head dim to 80 in shared memory

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _pad128(n: int) -> int:
    return max(128, -(-n // 128) * 128)


def onepass_supported(n: int, m: int, dh: int) -> bool:
    """The TPU gate: padded keys <= 4096 and a head dim below its padding."""
    return _pad128(m) <= ONEPASS_MAX_KV and dh < _pad128(dh)


def allheads_supported(n: int, m: int, key_mask) -> bool:
    """Masked attention over at most 512 padded keys."""
    return key_mask is not None and _pad128(m) <= ALLHEADS_MAX_KV


def mask_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """[B, M] bool / int key mask -> f32 additive bias, 0 or -1e30."""
    bias = torch.zeros(key_mask.shape, dtype=torch.float32, device=key_mask.device)
    return bias.masked_fill_(~key_mask.bool(), NEG_INF)


def attention_reference(q, k, v, key_mask: Optional[torch.Tensor] = None):
    """Plain version of both kernels over [B, N, H, Dh] / [B, M, H, Dh].

    f32 logits and softmax; the probabilities are rounded to the input dtype
    before the P.V product, as the JAX package's einsum path does.
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if key_mask is not None:
        logits = logits + mask_bias(key_mask)[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(q.dtype).float()
    return torch.einsum("bhnm,bmhd->bnhd", probs, v.float()).to(q.dtype)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; expected cpu or cuda")
    dtype = tensors[0].dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16 or float32, got {dtype}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: tensors of {t.dtype} and {dtype}")


def _check_head_dim(name: str, dh: int) -> None:
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {dh} must be a multiple of 8 and <= 80")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernel can read it in 16-byte rows, else a copy."""
    if (
        x.stride(-1) == 1
        and all(s * x.element_size() % 16 == 0 for s in x.stride()[:-1])
        and x.data_ptr() % 16 == 0
    ):
        return x
    return x.clone(memory_format=torch.contiguous_format)


@functools.cache
def _onepass_lib() -> ctypes.CDLL:
    lib = _build.load("onepass_attention")
    lib.onepass_attention.argtypes = [_P] * 5 + [_I] * 6 + [_L] * 12 + [_F, _P]
    lib.onepass_attention.restype = _I
    return lib


@functools.cache
def _allheads_lib() -> ctypes.CDLL:
    lib = _build.load("allheads_attention")
    lib.allheads_attention.argtypes = [_P] * 5 + [_I] * 6 + [_L] * 8 + [_F, _P]
    lib.allheads_attention.restype = _I
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def onepass_attention(
    q: torch.Tensor,  # [B, N, H, Dh]
    k: torch.Tensor,  # [B, M, H, Dh]
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,  # [B, M], True = valid
) -> torch.Tensor:
    """Self-attention over strided [B, N, H, Dh] views -> contiguous [B, N, H, Dh]."""
    B, N, H, Dh = q.shape
    M = k.shape[1]
    if k.shape != (B, M, H, Dh) or v.shape != k.shape:
        raise ValueError(f"onepass_attention: q {q.shape}, k {k.shape}, v {v.shape}")
    if key_mask is not None and key_mask.shape != (B, M):
        raise ValueError(f"onepass_attention: key_mask {key_mask.shape} != {(B, M)}")
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_mask)
    _check_cuda("onepass_attention", q, k, v)
    _check_head_dim("onepass_attention", Dh)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    madd = None if key_mask is None else mask_bias(key_mask)
    out = torch.empty((B, N, H, Dh), dtype=q.dtype, device=q.device)
    err = _onepass_lib().onepass_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if madd is None else madd.data_ptr(), out.data_ptr(),
        q.dtype == torch.float32, B, H, N, M, Dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], Dh**-0.5 * LOG2E, _stream(q),
    )
    if err:
        raise RuntimeError(f"onepass_attention kernel launch failed: CUDA error {err}")
    onepass_attention.launches += 1
    return out


onepass_attention.launches = 0


def crossattn_allheads(
    q: torch.Tensor,  # [B, N, C]
    k: torch.Tensor,  # [B, M, C]
    v: torch.Tensor,
    key_mask: torch.Tensor,  # [B, M], True = valid
    n_heads: int,
) -> torch.Tensor:
    """Masked cross-attention on the flat layout -> contiguous [B, N, C]."""
    B, N, C = q.shape
    M = k.shape[1]
    Dh = C // n_heads
    if C % n_heads or k.shape != (B, M, C) or v.shape != k.shape:
        raise ValueError(f"crossattn_allheads: q {q.shape}, k {k.shape}, v {v.shape}")
    if key_mask is None or key_mask.shape != (B, M):
        raise ValueError(f"crossattn_allheads: needs a [B, M] key_mask, got {key_mask}")
    if q.device.type == "cpu":
        split = lambda x: x.unflatten(-1, (n_heads, Dh))
        return attention_reference(split(q), split(k), split(v), key_mask).flatten(2)
    _check_cuda("crossattn_allheads", q, k, v)
    _check_head_dim("crossattn_allheads", Dh)
    if M > ALLHEADS_MAX_KV:
        raise ValueError(f"crossattn_allheads: {M} keys > {ALLHEADS_MAX_KV}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    madd = mask_bias(key_mask)
    out = torch.empty((B, N, C), dtype=q.dtype, device=q.device)
    err = _allheads_lib().allheads_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), madd.data_ptr(), out.data_ptr(),
        q.dtype == torch.float32, B, n_heads, N, M, Dh, *q.stride()[:2], *k.stride()[:2], *v.stride()[:2],
        *out.stride()[:2], Dh**-0.5 * LOG2E, _stream(q),
    )
    if err:
        raise RuntimeError(f"crossattn_allheads kernel launch failed: CUDA error {err}")
    crossattn_allheads.launches += 1
    return out


crossattn_allheads.launches = 0
