"""The attention kernels of the sampling and training paths, each beside its
plain version.

- `onepass_attention` (self-attention, [B, N, H, Dh]) runs
  `csrc/onepass_attention.cu`, the counterpart of the TPU kernel
  `_onepass_kernel` (pixart_sigma_tpu/ops/flash_attention.py). When a
  gradient is needed it also writes the row logsumexp (log2 units).
- `crossattn_allheads` (masked caption cross-attention on the flat [B, N, C]
  layout) runs `csrc/allheads_attention.cu`, the counterpart of
  `_allheads_kernel`.
- Their gradients run `csrc/flash_backward.cu`: `flash_bwd_dkv` and
  `flash_bwd_dq`, the counterparts of `_bwd_dkv_kernel` and `_bwd_dq_kernel`.
  As in the JAX package, the backward of `crossattn_allheads` recomputes the
  output and logsumexp through `onepass_attention` on [B, N, H, Dh] views of
  the flat tensors.

All compute softmax(q k^T / sqrt(Dh) + mask) v with an f32 softmax in log2
units; masked keys get the finite logit -1e30, as in the TPU kernels, and the
TPU kernels' padding of K/V to a multiple of 128 keys (zero values, logit
-1e30) is accounted for, so a row whose keys are all masked gives
sum(V) / pad128(M) as they do. They take bf16 or f32 and return the input
dtype; f32 inputs are rounded to bf16 for the tensor-core products (the
precision of an f32 dot at default precision on the TPU), while the softmax
and accumulation stay f32. On a CPU tensor each wrapper runs its plain
PyTorch version (`onepass_reference_with_lse`, `flash_backward_reference`);
on a CUDA tensor it launches its kernel or raises. Each wrapper counts its
launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

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


def _logits(q, k, madd):
    """[B, H, N, M] f32 logits in log2 units: q.k * Dh^-0.5 * log2(e) + madd."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * (q.shape[-1] ** -0.5 * LOG2E)
    return s if madd is None else s + madd[:, None, None, :]


def _plain_forward(q, k, v, madd) -> Tuple[torch.Tensor, torch.Tensor]:
    """The arithmetic of both forward kernels: (out [B, N, H, Dh] in q's dtype,
    lse [B, H, N] f32 in log2 units). The probabilities are rounded to the
    input dtype before the P.V product, as the JAX einsum path does."""
    M = k.shape[1]
    s = _logits(q, k, madd)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    # the TPU kernels' padded keys: logit -1e30, zero values
    l = p.sum(-1, keepdim=True) + (_pad128(M) - M) * torch.exp2(NEG_INF - m)
    probs = (p / l).to(q.dtype).float()
    out = torch.einsum("bhnm,bmhd->bnhd", probs, v.float()).to(q.dtype)
    return out, (m + torch.log2(l)).squeeze(-1)


def onepass_reference_with_lse(q, k, v, key_mask: Optional[torch.Tensor] = None):
    """Plain version of the onepass kernel with its logsumexp output:
    (out [B, N, H, Dh], lse [B, H, N] f32, log2 units)."""
    return _plain_forward(q, k, v, None if key_mask is None else mask_bias(key_mask))


def attention_reference(q, k, v, key_mask: Optional[torch.Tensor] = None):
    """Plain version of both forward kernels over [B, N, H, Dh] / [B, M, H, Dh]
    (differentiable by torch's own autograd)."""
    return onepass_reference_with_lse(q, k, v, key_mask)[0]


def flash_backward_reference(q, k, v, madd, lse, delta, do):
    """Plain version of both backward kernels: (dq, dk, dv) in q's dtype.

    Recomputes P = exp2(s - lse) from the forward's logsumexp (lse and
    delta = rowsum(dO * O) are [B, H, N] f32); P and dS are rounded to the
    input dtype before their products, as the TPU kernels round them.
    """
    dt = q.dtype
    p = torch.exp2(_logits(q, k, madd) - lse[..., None])
    dv = torch.einsum("bhnm,bnhd->bmhd", p.to(dt).float(), do.float())
    dp = torch.einsum("bnhd,bmhd->bhnm", do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * q.shape[-1] ** -0.5).to(dt).float()
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q.float())
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


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


def _f32_rows(x: Optional[torch.Tensor], shape, name: str) -> Optional[torch.Tensor]:
    """An f32 side input (mask bias, lse, delta) as the kernels read it."""
    if x is None:
        return None
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} != {tuple(shape)}")
    return x.float().contiguous()


@functools.cache
def _onepass_lib() -> ctypes.CDLL:
    lib = _build.load("onepass_attention")
    lib.onepass_attention.argtypes = [_P] * 6 + [_I] * 6 + [_L] * 12 + [_F, _P]
    lib.onepass_attention.restype = _I
    return lib


@functools.cache
def _allheads_lib() -> ctypes.CDLL:
    lib = _build.load("allheads_attention")
    lib.allheads_attention.argtypes = [_P] * 5 + [_I] * 6 + [_L] * 8 + [_F, _P]
    lib.allheads_attention.restype = _I
    return lib


@functools.cache
def _backward_lib() -> ctypes.CDLL:
    lib = _build.load("flash_backward")
    strides = ctypes.POINTER(_L)
    lib.flash_bwd_dkv.argtypes = [_P] * 9 + [_I] * 6 + [strides, _F, _F, _P]
    lib.flash_bwd_dq.argtypes = [_P] * 8 + [_I] * 6 + [strides, _F, _F, _P]
    lib.flash_bwd_dkv.restype = lib.flash_bwd_dq.restype = _I
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _grad_needed(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ---------------------------------------------------------------- onepass


def _onepass_forward(q, k, v, madd, with_lse: bool):
    """(out, lse or None) of the onepass kernel, or of its plain version on
    CPU tensors (which always gives the lse)."""
    if q.device.type == "cpu":
        return _plain_forward(q, k, v, madd)
    B, N, H, Dh = q.shape
    M = k.shape[1]
    _check_cuda("onepass_attention", q, k, v)
    _check_head_dim("onepass_attention", Dh)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    madd = _f32_rows(madd, (B, M), "onepass_attention madd")
    out = torch.empty((B, N, H, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device) if with_lse else None
    err = _onepass_lib().onepass_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(madd), out.data_ptr(), _ptr(lse),
        q.dtype == torch.float32, B, H, N, M, Dh, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], Dh**-0.5 * LOG2E, _stream(q),
    )
    if err:
        raise RuntimeError(f"onepass_attention kernel launch failed: CUDA error {err}")
    onepass_attention.launches += 1
    return out, lse


def onepass_attention(
    q: torch.Tensor,  # [B, N, H, Dh]
    k: torch.Tensor,  # [B, M, H, Dh]
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,  # [B, M], True = valid
) -> torch.Tensor:
    """Self-attention over strided [B, N, H, Dh] views -> contiguous [B, N, H, Dh].
    Differentiable: the backward runs `flash_bwd_dkv` and `flash_bwd_dq`."""
    B, N, H, Dh = q.shape
    M = k.shape[1]
    if k.shape != (B, M, H, Dh) or v.shape != k.shape:
        raise ValueError(f"onepass_attention: q {q.shape}, k {k.shape}, v {v.shape}")
    if key_mask is not None and key_mask.shape != (B, M):
        raise ValueError(f"onepass_attention: key_mask {key_mask.shape} != {(B, M)}")
    madd = None if key_mask is None else mask_bias(key_mask)
    if _grad_needed(q, k, v):
        return _OnepassAttention.apply(q, k, v, madd)
    return _onepass_forward(q, k, v, madd, with_lse=False)[0]


onepass_attention.launches = 0


# ---------------------------------------------------------------- allheads


def _allheads_forward(q, k, v, madd, n_heads: int):
    B, N, C = q.shape
    M = k.shape[1]
    Dh = C // n_heads
    if q.device.type == "cpu":
        split = lambda x: x.unflatten(-1, (n_heads, Dh))
        return _plain_forward(split(q), split(k), split(v), madd)[0].flatten(2)
    _check_cuda("crossattn_allheads", q, k, v)
    _check_head_dim("crossattn_allheads", Dh)
    if M > ALLHEADS_MAX_KV:
        raise ValueError(f"crossattn_allheads: {M} keys > {ALLHEADS_MAX_KV}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    madd = _f32_rows(madd, (B, M), "crossattn_allheads madd")
    out = torch.empty((B, N, C), dtype=q.dtype, device=q.device)
    err = _allheads_lib().allheads_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), madd.data_ptr(), out.data_ptr(),
        q.dtype == torch.float32, B, n_heads, N, M, Dh, *q.stride()[:2], *k.stride()[:2],
        *v.stride()[:2], *out.stride()[:2], Dh**-0.5 * LOG2E, _stream(q),
    )
    if err:
        raise RuntimeError(f"crossattn_allheads kernel launch failed: CUDA error {err}")
    crossattn_allheads.launches += 1
    return out


def crossattn_allheads(
    q: torch.Tensor,  # [B, N, C]
    k: torch.Tensor,  # [B, M, C]
    v: torch.Tensor,
    key_mask: torch.Tensor,  # [B, M], True = valid
    n_heads: int,
) -> torch.Tensor:
    """Masked cross-attention on the flat layout -> contiguous [B, N, C].
    Differentiable: the backward recomputes through the onepass kernel and
    runs `flash_bwd_dkv` and `flash_bwd_dq`."""
    B, N, C = q.shape
    M = k.shape[1]
    if C % n_heads or k.shape != (B, M, C) or v.shape != k.shape:
        raise ValueError(f"crossattn_allheads: q {q.shape}, k {k.shape}, v {v.shape}")
    if key_mask is None or key_mask.shape != (B, M):
        raise ValueError(f"crossattn_allheads: needs a [B, M] key_mask, got {key_mask}")
    madd = mask_bias(key_mask)
    if _grad_needed(q, k, v):
        return _AllheadsAttention.apply(q, k, v, madd, n_heads)
    return _allheads_forward(q, k, v, madd, n_heads)


crossattn_allheads.launches = 0


# ---------------------------------------------------------------- backward


def _backward_args(name, q, k, v, do, madd, lse, delta):
    B, N, H, Dh = q.shape
    M = k.shape[1]
    _check_cuda(name, q, k, v, do)
    _check_head_dim(name, Dh)
    if do.shape != q.shape:
        raise ValueError(f"{name}: dout {do.shape} != q {q.shape}")
    return ((_aligned(q), _aligned(k), _aligned(v), _aligned(do)),
            _f32_rows(madd, (B, M), f"{name} madd"), _f32_rows(lse, (B, H, N), f"{name} lse"),
            _f32_rows(delta, (B, H, N), f"{name} delta"))


def _strides(*tensors) -> ctypes.Array:
    """(batch, row, head) strides of q, k, v, dout, dq, dk, dv (None -> 0)."""
    vals = []
    for t in tensors:
        vals += [0, 0, 0] if t is None else list(t.stride()[:3])
    return (_L * len(vals))(*vals)


def flash_bwd_dkv(q, k, v, do, madd, lse, delta):
    """(dk, dv) [B, M, H, Dh] of attention with forward logsumexp `lse` and
    delta = rowsum(dO * O) ([B, H, N] f32 each); madd is [B, M] f32 or None."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, madd, lse, delta, do)[1:]
    (q, k, v, do), madd, lse, delta = _backward_args("flash_bwd_dkv", q, k, v, do, madd, lse,
                                                     delta)
    B, N, H, Dh = q.shape
    M = k.shape[1]
    dk = torch.empty((B, M, H, Dh), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    err = _backward_lib().flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), _ptr(madd), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), q.dtype == torch.float32,
        B, H, N, M, Dh, _strides(q, k, v, do, None, dk, dv), Dh**-0.5 * LOG2E, Dh**-0.5,
        _stream(q),
    )
    if err:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: CUDA error {err}")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_dq(q, k, v, do, madd, lse, delta):
    """dq [B, N, H, Dh]; the arguments of `flash_bwd_dkv`."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, madd, lse, delta, do)[0]
    (q, k, v, do), madd, lse, delta = _backward_args("flash_bwd_dq", q, k, v, do, madd, lse,
                                                     delta)
    B, N, H, Dh = q.shape
    M = k.shape[1]
    dq = torch.empty((B, N, H, Dh), dtype=q.dtype, device=q.device)
    err = _backward_lib().flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), _ptr(madd), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), q.dtype == torch.float32,
        B, H, N, M, Dh, _strides(q, k, v, do, dq, None, None), Dh**-0.5 * LOG2E, Dh**-0.5,
        _stream(q),
    )
    if err:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: CUDA error {err}")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def _flash_backward(q, k, v, madd, out, lse, do):
    """(dq, dk, dv) from the forward's out and lse, as the TPU `_flash_bwd`.

    The mask bias is rounded to q's dtype first: the TPU backward carries it
    in a spare lane of K, so in bf16 a row with no valid key recomputes
    P = exp2(bf16(-1e30) - (-1e30)) = 0 there, and P = 1 in f32.
    """
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()  # [B, H, N]
    madd = None if madd is None else madd.to(q.dtype).float()
    dk, dv = flash_bwd_dkv(q, k, v, do, madd, lse, delta)
    return flash_bwd_dq(q, k, v, do, madd, lse, delta), dk, dv


class _OnepassAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, madd):
        out, lse = _onepass_forward(q, k, v, madd, with_lse=True)
        ctx.save_for_backward(q, k, v, madd, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, madd, out, lse = ctx.saved_tensors
        return (*_flash_backward(q, k, v, madd, out, lse, do), None)


class _AllheadsAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, madd, n_heads):
        ctx.n_heads = n_heads
        ctx.save_for_backward(q, k, v, madd)
        return _allheads_forward(q, k, v, madd, n_heads)

    @staticmethod
    def backward(ctx, do):
        q, k, v, madd = ctx.saved_tensors
        split = lambda x: x.unflatten(-1, (ctx.n_heads, -1))
        q4, k4, v4, do4 = split(q), split(k), split(v), split(do)
        out, lse = _onepass_forward(q4, k4, v4, madd, with_lse=True)
        dq, dk, dv = _flash_backward(q4, k4, v4, madd, out, lse, do4)
        return dq.flatten(2), dk.flatten(2), dv.flatten(2), None, None
