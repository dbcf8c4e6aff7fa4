"""Dynamic int8 (W8A8) matmul for the quantized serving path.

Port of pixart_sigma_tpu/ops/quant.py, the same scheme:
  - weights:     symmetric per-OUTPUT-channel scales, round-to-nearest
  - activations: symmetric per-TOKEN (row) scales computed on the fly
  - y = (q_x @ q_w) * (s_x . s_w) + b   accumulated in int32, scaled in f32

A scale is absmax / 127 + 1e-8 (the eps added after the division), values
round half to even (`torch.round`, as `jnp.round`) and clip to +-127. The
127 is a tensor on the input's device: PyTorch's CUDA division by a Python
scalar multiplies by its reciprocal, which rounds some scales one ulp away
from the IEEE division that JAX and the CPU do; dividing by a tensor keeps
the card's quantized values equal to the CPU's.

The int32 product of a CUDA tensor is `torch._int_mm` (cuBLASLt), a library
product as JAX's `dot_general(preferred_element_type=int32)` is an XLA one:
no port kernel replaces a Pallas kernel here. `_int_mm` takes only some
shapes (`check_int_mm`); a call outside them raises rather than compute
another way. On a CPU tensor the product is `int8_accumulate_reference`, an
f64 matmul of the int8 values: every product is an integer of magnitude at
most 127^2 and every partial sum stays below 2^53 for K < 5e11, so the f64
sums are exact in any order and equal the card's int32 accumulator bit for
bit. The quantize passes and the f32 epilogue are plain PyTorch on both.
"""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-8


def _scale(absmax: torch.Tensor, eps: float) -> torch.Tensor:
    return absmax.float() / torch.full((), 127.0, device=absmax.device) + eps


def quantize_rows(x: torch.Tensor, eps: float = EPS):
    """Per-row symmetric int8 quantization over the last dim.
    Returns (q [int8], scale [..., 1] f32)."""
    scale = _scale(x.abs().amax(dim=-1, keepdim=True), eps)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_cols(w: torch.Tensor, eps: float = EPS):
    """Per-output-channel (last dim) symmetric int8 quantization of an
    [in, out] kernel. Returns (q [int8], scale [out] f32)."""
    scale = _scale(w.abs().amax(dim=0), eps)
    q = torch.clamp(torch.round(w.float() / scale[None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_weight(weight: torch.Tensor, eps: float = EPS):
    """A torch Linear weight [out, in] quantized per output channel (a max
    over dim 1). Returns (q [in, out] int8, column-major: the transpose of
    an [out, in] row-major copy, scale [out] f32)."""
    q, scale = quantize_cols(weight.t(), eps)
    return q.t().contiguous().t(), scale


def check_int_mm(qx: torch.Tensor, qw: torch.Tensor) -> None:
    """Raise unless `torch._int_mm(qx, qw)` takes these operands on the card
    (found on the H100, torch 2.11, CUDA 12.8): int8 [M, K] and [K, N] with
    M > 16 and K, N multiples of 8, each row- or column-major but not both
    column-major (cuBLASLt answers NOT_SUPPORTED)."""
    if qx.dtype != torch.int8 or qw.dtype != torch.int8 or qx.dim() != 2 or qw.dim() != 2:
        raise ValueError(f"_int_mm takes 2-D int8 operands, got {qx.dtype} {tuple(qx.shape)} "
                         f"and {qw.dtype} {tuple(qw.shape)}")
    (M, K), (K2, N) = qx.shape, qw.shape
    if K != K2:
        raise ValueError(f"inner dims differ: {tuple(qx.shape)} @ {tuple(qw.shape)}")
    if M <= 16 or K % 8 or N % 8:
        raise ValueError(f"torch._int_mm needs M > 16 and K, N multiples of 8; got M={M} "
                         f"K={K} N={N}")
    row = lambda t: t.is_contiguous()
    col = lambda t: t.t().is_contiguous()
    if not (row(qx) or col(qx)) or not (row(qw) or col(qw)) or \
            (col(qx) and not row(qx) and col(qw) and not row(qw)):
        raise ValueError("torch._int_mm operands: each row- or column-major, not both "
                         "column-major")


def int8_accumulate_reference(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """The plain version of the int32 product: exact through f64 (module
    docstring)."""
    return (qx.double() @ qw.double()).to(torch.int32)


def int8_accumulate(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [K, N] int8 -> [M, N] int32: `torch._int_mm` on the card,
    the plain version for CPU tensors."""
    if qx.device.type == "cpu":
        return int8_accumulate_reference(qx, qw)
    if qx.device.type != "cuda":
        raise ValueError(f"int8 product on {qx.device}: only cuda and cpu")
    check_int_mm(qx, qw)
    return torch._int_mm(qx, qw)


def int8_matmul_quantized(x: torch.Tensor, qw: torch.Tensor, sw: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x @ W + bias with W given quantized (`quantize_cols` or
    `quantize_weight`): x is quantized per row here, the int32 product
    scaled in f32, the bias added in f32, then cast to `out_dtype`."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    qx, sx = quantize_rows(x.reshape(-1, x.shape[-1]))
    acc = int8_accumulate(qx, qw)
    y = acc.float() * sx * sw[None]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*lead, qw.shape[1])


def int8_matmul(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dynamic W8A8 y = x @ kernel + bias; `kernel` is [in, out] (f32 or bf16
    storage), quantized here per output channel, as JAX's `int8_matmul`."""
    qw, sw = quantize_cols(kernel)
    return int8_matmul_quantized(x, qw, sw, bias, out_dtype)
