"""The attention kernels of the sampling and training paths, each beside its
plain version.

- `onepass_attention` (self-attention, [B, N, H, Dh]) runs
  `csrc/onepass_attention.cu`, the counterpart of the TPU kernel
  `_onepass_kernel` (pixart_sigma_tpu/ops/flash_attention.py). When a
  gradient is needed it also writes the row logsumexp (log2 units).
- `crossattn_allheads` (masked caption cross-attention on the flat [B, N, C]
  layout) runs `allheads_attention` of `csrc/cross_attention.cu`, the
  counterpart of `_allheads_kernel`. It visits only the key tiles up to
  each batch element's last valid caption key (`caption_key_extent`), and
  builds the mask biases in the kernel from the boolean mask.
- `flash_attention` (long sequences, [B, N, H, Dh]) runs
  `csrc/flash_forward.cu`, the counterpart of `_fwd_kernel`, with the JAX
  `flash_attention`'s function (q scaled in its dtype, the mask in K's dtype,
  the key-block tail; see its docstring).
- `crossattn_headsmajor` (masked cross-attention, [B, N, H, Dh], forward
  only) runs `headsmajor_attention` of the same library, the counterpart of
  `_headsmajor_kernel`: the same function and the same kernel body as
  `crossattn_allheads`, on other views.
- Their gradients run `csrc/flash_backward.cu`: `flash_bwd_dkv` and
  `flash_bwd_dq`, the counterparts of `_bwd_dkv_kernel` and `_bwd_dq_kernel`.
  With a key mask both visit only the key tiles up to each batch element's
  last valid key (`caption_key_extent`), found in the kernel from the bias.
  As in the JAX package, the backward of `crossattn_allheads` recomputes the
  output and logsumexp through `onepass_attention` on [B, N, H, Dh] views of
  the flat tensors.

All compute softmax(q k^T / sqrt(Dh) + mask) v with an f32 softmax in log2
units; masked keys get the finite logit -1e30, as in the TPU kernels, and the
TPU kernels' padding of K/V (zero values, logit -1e30; to a multiple of 128
keys, or of the key block for `flash_attention`) is accounted for, so a row
whose keys are all masked gives what they give: sum(V) / pad128(M) for
onepass, allheads and headsmajor. They take bf16 or f32 and return the input
dtype; f32 inputs are rounded to bf16 for the tensor-core products (the
precision of an f32 dot at default precision on the TPU), while the softmax
and accumulation stay f32. On a CPU tensor each wrapper runs its plain
PyTorch version (`onepass_reference_with_lse`, `flash_reference_with_lse`,
`headsmajor_reference`, `flash_backward_reference`); on a CUDA tensor it
launches its kernel or raises. Each wrapper counts its launches in
`<wrapper>.launches`.

The kernels take every head dim up to 128 (MAX_HEAD_DIM), each run at the
padded width 64, 80 or 128 (`head_dim_width`); a head dim that is not a
multiple of 8 is zero-padded to one by the wrapper (`pad_head_dim`), with the
softmax scale kept the true head dim's, and the outputs and gradients are
sliced back. A wider head dim raises a ValueError.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from pixart_sigma_tpu_torch.ops import _build

NEG_INF = -1e30  # finite stand-in for -inf, as in the TPU kernels
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
ONEPASS_MAX_KV = 4096  # padded keys, as the TPU gate (onepass_supported)
ALLHEADS_MAX_KV = 512  # caption keys the allheads kernel takes
HEADSMAJOR_MAX_KV = 512  # caption keys the headsmajor kernel takes
HEADSMAJOR_ROWS = 128  # unit of headsmajor's block_q (the kernel's query tile)
MAX_HEAD_DIM = 128  # the widest head dim the kernels take
# The padded head dims the kernels are built for (csrc/hopper_common.cuh):
# a head dim runs at the first that holds it
WIDTHS = (64, 80, 128)
KEY_TILE = 128  # keys per tile of the onepass and flash kernels (csrc/hopper_attention.cuh)
# depth of their K/V ring at each width; both are checked against the library at load
KEY_STAGES = {64: 3, 80: 3, 128: 3}
# The allheads and headsmajor kernels: keys per tile, the unit of the key
# extent they visit, and the K/V stages that hold an extent resident (longer
# ones stream) at each width; checked against the library at load
CROSS_KEY_TILE = 128
CROSS_KEY_STAGES = {64: 2, 80: 2, 128: 2}
# The backward pair: keys per K/V tile (the unit of its key extent, and the
# keys of one dK/dV item) and the depth of dq's K/V ring over long key sweeps
# at each width; checked at load
BWD_KEY_TILE = 128
BWD_KEY_STAGES = {64: 3, 80: 3, 128: 2}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _pad128(n: int) -> int:
    return max(128, -(-n // 128) * 128)


def onepass_supported(n: int, m: int, dh: int) -> bool:
    """The TPU gate: padded keys <= 4096 and a head dim below its padding."""
    return _pad128(m) <= ONEPASS_MAX_KV and dh < _pad128(dh)


def allheads_supported(n: int, m: int, key_mask) -> bool:
    """Masked attention over at most 512 padded keys."""
    return key_mask is not None and _pad128(m) <= ALLHEADS_MAX_KV


def headsmajor_supported(n: int, m: int, key_mask) -> bool:
    """The TPU gate: masked attention, >= 512 queries, <= 512 padded keys."""
    return key_mask is not None and n >= 512 and _pad128(m) <= HEADSMAJOR_MAX_KV


def mask_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """[B, M] bool / int key mask -> f32 additive bias, 0 or -1e30."""
    bias = torch.zeros(key_mask.shape, dtype=torch.float32, device=key_mask.device)
    return bias.masked_fill_(~key_mask.bool(), NEG_INF)


def caption_key_extent(key_mask: torch.Tensor, tile: int = CROSS_KEY_TILE) -> torch.Tensor:
    """Plain version of the allheads/headsmajor kernels' key extent: for each
    row of the [B, M] key mask (True or nonzero = valid), the keys a row with
    a valid key can weigh, the last valid key, plus one, rounded up to `tile`
    ([B] int64). Past it every such row has p = exp2(-1e30 - m) = 0 exactly.
    A row with no valid key keeps every key, M rounded up to `tile`: it
    averages all of V (sum(V) / pad128(M)). The last index, not the count,
    as masks need not be prefixes. The backward kernels (dkv, dq) apply the
    same rule to the mask bias row in tiles of BWD_KEY_TILE."""
    M = key_mask.shape[-1]
    keys = torch.arange(1, M + 1, device=key_mask.device)
    last = torch.where(key_mask.bool(), keys, 0).amax(-1)
    last = torch.where(last > 0, last, M)
    return -(-last // tile) * tile


def _logits(q, k, madd, scale: Optional[float] = None):
    """[B, H, N, M] f32 logits in log2 units: q.k * scale + madd, scale
    Dh^-0.5 * log2(e) unless given."""
    scale = q.shape[-1] ** -0.5 * LOG2E if scale is None else scale
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    return s if madd is None else s + madd[:, None, None, :]


def _softmax_pv(s, v, tail: int, dtype):
    """The arithmetic of the flash and headsmajor kernels on logits s
    [B, H, N, M] (f32, log2 units): (out [B, N, H, Dh] in `dtype`, lse
    [B, H, N] f32). `tail` more keys sit at logit -1e30 with zero values. The
    row max starts from -1e30; the f32 p enter the denominator unrounded and
    are rounded to v's dtype for P.V, which is normalised after."""
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True) + tail * torch.exp2(NEG_INF - m)
    acc = torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype).float(), v.float())
    out = (acc / l.transpose(1, 2)).to(dtype)
    return out, (m + torch.log2(l)).squeeze(-1)


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


def _flash_tail(m: int, block_k: Optional[int]) -> int:
    """Keys the TPU `flash_attention` pads K/V with past M: up to a multiple
    of its key block, 512, or 2048 once M >= 8192, at most pad128(M)."""
    bk = min(block_k or (2048 if m >= 8192 else 512), _pad128(m))
    return -(-m // bk) * bk - m


def _flash_q_scale(dh: int, dtype) -> float:
    """Dh^-0.5 * log2(e) rounded to the inputs' dtype (a host scalar, so no
    copy to the card waits on its queue)."""
    return float(torch.tensor(dh**-0.5 * LOG2E, dtype=dtype))


def _flash_scale_q(q: torch.Tensor) -> torch.Tensor:
    """q * Dh^-0.5 * log2(e) in q's dtype (the constant rounded to it too), as
    the JAX `flash_attention` folds the softmax scale into q. The product of
    two values of q's dtype is exact in f32, so it is rounded once, as JAX's."""
    return q * _flash_q_scale(q.shape[-1], q.dtype)


def _flash_madd(key_mask: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    """The mask bias rounded to the inputs' dtype, as the TPU kernel carries
    it in a spare lane of K (bf16(-1e30) < -1e30)."""
    return None if key_mask is None else mask_bias(key_mask).to(dtype).float()


def flash_reference_with_lse(q, k, v, key_mask: Optional[torch.Tensor] = None,
                             block_k: Optional[int] = None):
    """Plain version of `flash_attention` with its logsumexp:
    (out [B, N, H, Dh], lse [B, H, N] f32, log2 units)."""
    s = _logits(_flash_scale_q(q), k, _flash_madd(key_mask, k.dtype), scale=1.0)
    return _softmax_pv(s, v, _flash_tail(k.shape[1], block_k), q.dtype)


def headsmajor_reference(q, k, v, key_mask: torch.Tensor) -> torch.Tensor:
    """Plain version of `crossattn_headsmajor` over [B, N, H, Dh]."""
    s = _logits(q, k, mask_bias(key_mask))
    return _softmax_pv(s, v, _pad128(k.shape[1]) - k.shape[1], q.dtype)[0]


def flash_backward_reference(q, k, v, madd, lse, delta, do, scale: Optional[float] = None,
                             ds_scale: Optional[float] = None):
    """Plain version of both backward kernels: (dq, dk, dv) in q's dtype.

    Recomputes P = exp2(q.k * scale + madd - lse) from the forward's
    logsumexp (lse and delta = rowsum(dO * O) are [B, H, N] f32); P and dS
    are rounded to the input dtype before their products, as the TPU kernels
    round them. scale defaults to Dh^-0.5 * log2(e) and ds_scale, the chain
    factor of dS, to ln(2) * scale = Dh^-0.5.
    """
    dt = q.dtype
    ds_scale = q.shape[-1] ** -0.5 if ds_scale is None else ds_scale
    p = torch.exp2(_logits(q, k, madd, scale) - lse[..., None])
    dv = torch.einsum("bhnm,bnhd->bmhd", p.to(dt).float(), do.float())
    dp = torch.einsum("bnhd,bmhd->bhnm", do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * ds_scale).to(dt).float()
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
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {dh}; the CUDA kernels take 1 to {MAX_HEAD_DIM} "
                         "(ROADMAP Queue 3)")


def head_dim_width(dh: int) -> int:
    """The padded width (WIDTHS) a head dim of dh runs at."""
    return next(w for w in WIDTHS if dh <= w)


def pad_head_dim(x: torch.Tensor) -> torch.Tensor:
    """x with its head dim (the last) zero-padded to a multiple of 8, as the
    kernels read 16-byte rows; x itself when it is one. Zero columns of q
    and k add nothing to a logit, and those of v and dO give zero columns of
    the output and of every gradient, which the wrappers slice off."""
    pad = -x.shape[-1] % 8
    return x if pad == 0 else torch.nn.functional.pad(x, (0, pad))


def _unpad(x: torch.Tensor, dh: int) -> torch.Tensor:
    """x [..., Dh padded] cut back to its first dh columns, contiguous."""
    return x if x.shape[-1] == dh else x[..., :dh].contiguous()


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernel can read it in 16-byte rows, else a copy."""
    if (
        x.stride(-1) == 1
        and all(s * x.element_size() % 16 == 0 for s in x.stride()[:-1])
        and x.data_ptr() % 16 == 0
    ):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _tma_operand(x: torch.Tensor) -> torch.Tensor:
    """q, k, v or dO as the Hopper kernels (onepass, flash, dkv, dq) read it
    through TMA: bf16 (f32 is rounded, as the tensor cores multiply in bf16
    anyway), `_aligned`, and the strides positive and below 2^40 bytes. A
    view that meets this, such as a column slice of the qkv projection, is
    used in place."""
    x = _aligned(x.to(torch.bfloat16))
    if all(0 < s * 2 < 2**40 for s in x.stride()[:-1]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


TMA_ENCODE_ERROR = 10000  # the Hopper kernels' code base for a failed tensor-map encode


def _hopper_error(err: int) -> str:
    """The return code of a Hopper kernel's C entry point (onepass, flash,
    allheads, headsmajor, dkv, dq), in words."""
    if err >= TMA_ENCODE_ERROR:
        return f"TMA tensor map encode failed: CUresult {err - TMA_ENCODE_ERROR}"
    return f"CUDA error {err}"


def _tile_bias(madd: Optional[torch.Tensor], B: int, M: int, name: str):
    """The [B, M] mask bias as the onepass and flash kernels stream it: f32
    rows padded with -inf to a whole number of KEY_TILE keys, so each tile's
    biases are one aligned copy and keys past M need no test."""
    madd = _f32_rows(madd, (B, M), name)
    if madd is None:
        return None
    return torch.nn.functional.pad(madd, (0, -(-M // KEY_TILE) * KEY_TILE - M),
                                   value=float("-inf"))


def _f32_rows(x: Optional[torch.Tensor], shape, name: str) -> Optional[torch.Tensor]:
    """An f32 side input (mask bias, lse, delta) as the kernels read it."""
    if x is None:
        return None
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} != {tuple(shape)}")
    return x.float().contiguous()


def _check_key_geometry(lib, name: str, tile: int = KEY_TILE, stages=KEY_STAGES):
    """`lib` (onepass_attention or flash_forward with KEY_TILE and KEY_STAGES;
    cross_attention with CROSS_KEY_TILE and CROSS_KEY_STAGES; flash_backward
    with BWD_KEY_TILE and BWD_KEY_STAGES), once its keys per tile and its K/V
    stages at each width of WIDTHS are found to be `tile` and `stages`
    ({width: stages}), by which `_tile_bias` pads the mask of onepass and
    flash, and the tests and the planted faults pick their key counts."""
    got = (getattr(lib, f"{name}_key_tile")(),
           {w: getattr(lib, f"{name}_key_stages")(w) for w in WIDTHS})
    if got != (tile, stages):
        raise RuntimeError(f"{name}: the library streams {got[0]}-key tiles through "
                           f"{got[1]} stages by width, the wrapper expects {tile} and {stages}")
    return lib


@functools.cache
def _onepass_lib() -> ctypes.CDLL:
    lib = _check_key_geometry(_build.load("onepass_attention"), "onepass_attention")
    lib.onepass_attention.argtypes = [_P] * 6 + [_I] * 6 + [_L] * 12 + [_F, _P]
    lib.onepass_attention.restype = _I
    return lib


@functools.cache
def _cross_lib() -> ctypes.CDLL:
    """The library of allheads_attention and headsmajor_attention."""
    lib = _check_key_geometry(_build.load("cross_attention"), "cross_attention",
                              CROSS_KEY_TILE, CROSS_KEY_STAGES)
    for fn in (lib.allheads_attention, lib.headsmajor_attention):
        fn.argtypes = [_P] * 4 + [_L, _P] + [_I] * 6 + [_L] * 12 + [_F, _P]
        fn.restype = _I
    return lib


@functools.cache
def _flash_lib() -> ctypes.CDLL:
    lib = _check_key_geometry(_build.load("flash_forward"), "flash_forward")
    lib.flash_forward.argtypes = [_P] * 6 + [_I] * 7 + [_L] * 12 + [_F, _P]
    lib.flash_forward.restype = _I
    return lib


@functools.cache
def _backward_lib() -> ctypes.CDLL:
    lib = _check_key_geometry(_build.load("flash_backward"), "flash_backward", BWD_KEY_TILE,
                              BWD_KEY_STAGES)
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
    out = torch.empty((B, N, H, Dh + (-Dh % 8)), dtype=q.dtype, device=q.device)
    q, k, v = (_tma_operand(pad_head_dim(x)) for x in (q, k, v))
    Dp = q.shape[-1]
    madd = _tile_bias(madd, B, M, "onepass_attention madd")
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device) if with_lse else None
    err = _onepass_lib().onepass_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(madd), out.data_ptr(), _ptr(lse),
        out.dtype == torch.float32, B, H, N, M, Dp, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], Dh**-0.5 * LOG2E, _stream(q),
    )
    if err:
        raise RuntimeError(f"onepass_attention kernel launch failed: {_hopper_error(err)}")
    onepass_attention.launches += 1
    return _unpad(out, Dh), lse


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


def _cross_operands(q, k, v, n_heads: Optional[int] = None):
    """q, k, v as the allheads and headsmajor kernels read them through TMA:
    [B, rows, H, Dh] views (the flat [B, rows, C] layout split into heads
    when `n_heads` is given), each through `pad_head_dim` and `_tma_operand`.
    The flat q and the column slices of the hoisted [B, M, 2C] caption K/V
    are read in place; with a head dim that is not a multiple of 8 (a head
    of the flat layout then starts off a 16-byte boundary) they become
    padded heads-major copies."""
    if n_heads is not None:
        q, k, v = (x.unflatten(-1, (n_heads, x.shape[-1] // n_heads)) for x in (q, k, v))
    return tuple(_tma_operand(pad_head_dim(x)) for x in (q, k, v))


def _key_bytes(key_mask: torch.Tensor, device: torch.device, name: str) -> torch.Tensor:
    """The [B, M] key mask as the allheads and headsmajor kernels read it:
    one byte per key, nonzero where valid (a bool tensor as it is, another
    dtype compared with 0), keys contiguous. The kernels build the biases
    (0 / -1e30) and the key extent from it themselves."""
    if key_mask.device != device:
        raise ValueError(f"{name}: key_mask on {key_mask.device}, q on {device}")
    mask = key_mask if key_mask.dtype == torch.bool else key_mask != 0
    return mask if mask.stride(-1) == 1 else mask.contiguous()


def _cross_launch(name: str, q, k, v, key_mask, out, dh: int) -> None:
    """One launch of the allheads or headsmajor kernel (`name`, an entry
    point of the cross_attention library) on [B, rows, H, Dp] views from
    `_cross_operands`, writing out, a [B, N, H, Dp] view of bf16 or f32;
    key_mask is the [B, M] mask (True = valid). The logit scale is that of
    the true head dim dh (Dp is dh padded to a multiple of 8)."""
    B, N, H, Dp = q.shape
    M = k.shape[1]
    mask = _key_bytes(key_mask, q.device, name)
    err = getattr(_cross_lib(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), mask.stride(0),
        out.data_ptr(), out.dtype == torch.float32, B, H, N, M, Dp, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], dh**-0.5 * LOG2E, _stream(q),
    )
    if err:
        raise RuntimeError(f"{name} kernel launch failed: {_hopper_error(err)}")


def _allheads_forward(q, k, v, key_mask, n_heads: int):
    B, N, C = q.shape
    M = k.shape[1]
    Dh = C // n_heads
    if q.device.type == "cpu":
        split = lambda x: x.unflatten(-1, (n_heads, Dh))
        return _plain_forward(split(q), split(k), split(v), mask_bias(key_mask))[0].flatten(2)
    _check_cuda("crossattn_allheads", q, k, v)
    _check_head_dim("crossattn_allheads", Dh)
    if M > ALLHEADS_MAX_KV:
        raise ValueError(f"crossattn_allheads: {M} keys > {ALLHEADS_MAX_KV}")
    out = torch.empty((B, N, n_heads, Dh + (-Dh % 8)), dtype=q.dtype, device=q.device)
    _cross_launch("allheads_attention", *_cross_operands(q, k, v, n_heads), key_mask, out, Dh)
    crossattn_allheads.launches += 1
    return _unpad(out, Dh).flatten(2)


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
    if _grad_needed(q, k, v):
        return _AllheadsAttention.apply(q, k, v, key_mask, n_heads)
    return _allheads_forward(q, k, v, key_mask, n_heads)


crossattn_allheads.launches = 0


# ---------------------------------------------------------------- backward


def _backward_operands(name, q, k, v, do, madd, lse, delta):
    """The backward kernels' operands: q, k, v and dO through `pad_head_dim`
    and `_tma_operand` (bf16, views read in place), the [B, M] mask bias, lse
    and delta as contiguous f32 rows."""
    B, N, H, _ = q.shape
    M = k.shape[1]
    if do.shape != q.shape:
        raise ValueError(f"{name}: dout {do.shape} != q {q.shape}")
    return (tuple(_tma_operand(pad_head_dim(x)) for x in (q, k, v, do)),
            _f32_rows(madd, (B, M), f"{name} madd"), _f32_rows(lse, (B, H, N), f"{name} lse"),
            _f32_rows(delta, (B, H, N), f"{name} delta"))


def _backward_args(name, q, k, v, do, madd, lse, delta):
    """`_backward_operands` of CUDA tensors the kernels take."""
    _check_cuda(name, q, k, v, do)
    _check_head_dim(name, q.shape[-1])
    return _backward_operands(name, q, k, v, do, madd, lse, delta)


def _strides(*tensors) -> ctypes.Array:
    """(batch, row, head) strides of q, k, v, dout, dq, dk, dv (None -> 0)."""
    vals = []
    for t in tensors:
        vals += [0, 0, 0] if t is None else list(t.stride()[:3])
    return (_L * len(vals))(*vals)


def _backward_scales(dh: int, scale, ds_scale) -> Tuple[float, float]:
    """The logit scale and the chain factor of dS (defaults: the unscaled-q
    kernels' Dh^-0.5 * log2(e) and Dh^-0.5)."""
    return (dh**-0.5 * LOG2E if scale is None else scale,
            dh**-0.5 if ds_scale is None else ds_scale)


def flash_bwd_dkv(q, k, v, do, madd, lse, delta, scale: Optional[float] = None,
                  ds_scale: Optional[float] = None):
    """(dk, dv) [B, M, H, Dh] of attention with forward logsumexp `lse` and
    delta = rowsum(dO * O) ([B, H, N] f32 each); madd is [B, M] f32 or None.
    scale and ds_scale as in `flash_backward_reference`."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, madd, lse, delta, do, scale, ds_scale)[1:]
    dtype, Dh = q.dtype, q.shape[-1]
    (q, k, v, do), madd, lse, delta = _backward_args("flash_bwd_dkv", q, k, v, do, madd, lse,
                                                     delta)
    B, N, H, Dp = q.shape
    M = k.shape[1]
    dk = torch.empty((B, M, H, Dp), dtype=dtype, device=q.device)
    dv = torch.empty_like(dk)
    err = _backward_lib().flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), _ptr(madd), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), dtype == torch.float32,
        B, H, N, M, Dp, _strides(q, k, v, do, None, dk, dv),
        *_backward_scales(Dh, scale, ds_scale), _stream(q),
    )
    if err:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: {_hopper_error(err)}")
    flash_bwd_dkv.launches += 1
    return _unpad(dk, Dh), _unpad(dv, Dh)


flash_bwd_dkv.launches = 0


def flash_bwd_dq(q, k, v, do, madd, lse, delta, scale: Optional[float] = None,
                 ds_scale: Optional[float] = None):
    """dq [B, N, H, Dh]; the arguments of `flash_bwd_dkv`."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, madd, lse, delta, do, scale, ds_scale)[0]
    dtype, Dh = q.dtype, q.shape[-1]
    (q, k, v, do), madd, lse, delta = _backward_args("flash_bwd_dq", q, k, v, do, madd, lse,
                                                     delta)
    B, N, H, Dp = q.shape
    M = k.shape[1]
    dq = torch.empty((B, N, H, Dp), dtype=dtype, device=q.device)
    err = _backward_lib().flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), _ptr(madd), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dtype == torch.float32,
        B, H, N, M, Dp, _strides(q, k, v, do, dq, None, None),
        *_backward_scales(Dh, scale, ds_scale), _stream(q),
    )
    if err:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: {_hopper_error(err)}")
    flash_bwd_dq.launches += 1
    return _unpad(dq, Dh)


flash_bwd_dq.launches = 0


def _flash_backward(q, k, v, madd, out, lse, do, scale=None, ds_scale=None):
    """(dq, dk, dv) from the forward's out and lse, as the TPU `_flash_bwd`.

    The mask bias is rounded to q's dtype first: the TPU backward carries it
    in a spare lane of K, so in bf16 a row with no valid key recomputes
    P = exp2(bf16(-1e30) - (-1e30)) = 0 there, and P = 1 in f32.
    """
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()  # [B, H, N]
    madd = None if madd is None else madd.to(q.dtype).float()
    dk, dv = flash_bwd_dkv(q, k, v, do, madd, lse, delta, scale, ds_scale)
    return flash_bwd_dq(q, k, v, do, madd, lse, delta, scale, ds_scale), dk, dv


# The forward launches of the autograd Functions below, registered as torch
# ops so that a selective-checkpoint policy sees them (the model's "save_attn"
# remat policy keeps their outputs, and the recompute skips the launch). An
# op's outputs may not alias its inputs; the kernels' are fresh tensors.


@torch.library.custom_op("pixart_port::onepass_forward", mutates_args=())
def _onepass_forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        madd: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    return _onepass_forward(q, k, v, madd, with_lse=True)


@torch.library.custom_op("pixart_port::allheads_forward", mutates_args=())
def _allheads_forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         key_mask: torch.Tensor, n_heads: int) -> torch.Tensor:
    return _allheads_forward(q, k, v, key_mask, n_heads)


@torch.library.custom_op("pixart_port::flash_forward", mutates_args=())
def _flash_forward_op(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      madd: Optional[torch.Tensor], tail: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _flash_forward(qs, k, v, madd, tail, with_lse=True)


class _OnepassAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, madd):
        out, lse = _onepass_forward_op(q, k, v, madd)
        ctx.save_for_backward(q, k, v, madd, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, madd, out, lse = ctx.saved_tensors
        return (*_flash_backward(q, k, v, madd, out, lse, do), None)


class _AllheadsAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, n_heads):
        ctx.n_heads = n_heads
        ctx.save_for_backward(q, k, v, key_mask)
        return _allheads_forward_op(q, k, v, key_mask, n_heads)

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask = ctx.saved_tensors
        madd = mask_bias(key_mask)
        split = lambda x: x.unflatten(-1, (ctx.n_heads, -1))
        q4, k4, v4, do4 = split(q), split(k), split(v), split(do)
        out, lse = _onepass_forward(q4, k4, v4, madd, with_lse=True)
        dq, dk, dv = _flash_backward(q4, k4, v4, madd, out, lse, do4)
        return dq.flatten(2), dk.flatten(2), dv.flatten(2), None, None


# ---------------------------------------------------------------- flash


def _flash_forward(q, k, v, madd, tail: int, with_lse: bool):
    """(out, lse or None) of the flash kernel on pre-scaled q, or of its plain
    version on CPU tensors (which always gives the lse)."""
    if q.device.type == "cpu":
        return _softmax_pv(_logits(q, k, madd, scale=1.0), v, tail, q.dtype)
    B, N, H, Dh = q.shape
    M = k.shape[1]
    _check_cuda("flash_attention", q, k, v)
    _check_head_dim("flash_attention", Dh)
    out = torch.empty((B, N, H, Dh + (-Dh % 8)), dtype=q.dtype, device=q.device)
    q, k, v = (_tma_operand(pad_head_dim(x)) for x in (q, k, v))
    madd = _tile_bias(madd, B, M, "flash_attention madd")
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device) if with_lse else None
    err = _flash_lib().flash_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(madd), out.data_ptr(), _ptr(lse),
        out.dtype == torch.float32, B, H, N, M, q.shape[-1], tail, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], 1.0, _stream(q),
    )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: {_hopper_error(err)}")
    flash_attention.launches += 1
    return _unpad(out, Dh), lse


def flash_attention(
    q: torch.Tensor,  # [B, N, H, Dh]
    k: torch.Tensor,  # [B, M, H, Dh]
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,  # [B, M], True = valid
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Attention over any number of keys -> contiguous [B, N, H, Dh]; the
    function of the JAX `flash_attention`, not that of `onepass_attention`:

    - q is multiplied by Dh^-0.5 * log2(e) in its own dtype before the logits;
    - the key mask is rounded to K's dtype (bf16(-1e30) < -1e30);
    - K/V are padded past M to a multiple of the key block (block_k, by
      default 512, or 2048 once M >= 8192; at most pad128(M)) with zero
      values at logit -1e30, and the running max starts from -1e30. A row
      with a valid key never sees the tail. A row whose keys are all masked
      gives sum(V) / M_pad in f32, 0 in bf16 when there is a tail, and NaN in
      bf16 when M fills its last key block, as the TPU kernel gives.

    The kernel's query tile is its own (128 rows); `block_q` is accepted as in
    the JAX signature and changes nothing. A dense `bias` is refused, as the
    JAX kernel refuses it. Differentiable: the backward runs `flash_bwd_dkv`
    and `flash_bwd_dq` at logit scale 1 with the ln(2) chain factor, and
    autograd carries the gradient through the scaling of q.
    """
    if bias is not None:
        raise ValueError("flash_attention: a dense bias is not supported; use impl='reference'")
    B, N, H, Dh = q.shape
    M = k.shape[1]
    if k.shape != (B, M, H, Dh) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {q.shape}, k {k.shape}, v {v.shape}")
    if key_mask is not None and key_mask.shape != (B, M):
        raise ValueError(f"flash_attention: key_mask {key_mask.shape} != {(B, M)}")
    tail = _flash_tail(M, block_k)
    madd = _flash_madd(key_mask, k.dtype)
    qs = _flash_scale_q(q)
    if _grad_needed(q, k, v):
        return _FlashAttention.apply(qs, k, v, madd, tail)
    return _flash_forward(qs, k, v, madd, tail, with_lse=False)[0]


flash_attention.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qs, k, v, madd, tail):
        out, lse = _flash_forward_op(qs, k, v, madd, tail)
        ctx.save_for_backward(qs, k, v, madd, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        qs, k, v, madd, out, lse = ctx.saved_tensors
        return (*_flash_backward(qs, k, v, madd, out, lse, do, scale=1.0, ds_scale=LN2),
                None, None)


# the forward launches a training forward makes, for checkpoint policies
ATTENTION_FORWARD_OPS = (torch.ops.pixart_port.onepass_forward.default,
                         torch.ops.pixart_port.allheads_forward.default,
                         torch.ops.pixart_port.flash_forward.default)


# ---------------------------------------------------------------- headsmajor


def crossattn_headsmajor(
    q: torch.Tensor,  # [B, N, H, Dh]
    k: torch.Tensor,  # [B, M, H, Dh]
    v: torch.Tensor,
    key_mask: torch.Tensor,  # [B, M], True = valid
    block_q: int = 256,
) -> torch.Tensor:
    """Masked cross-attention over at most 512 keys -> contiguous
    [B, N, H, Dh]: the TPU kernel's function (f32 logit scale, K/V padded to
    pad128(M)), which is `crossattn_allheads`'s. The kernel walks query tiles
    of its own; `block_q`, rows per block on the TPU, must be a multiple of
    128 and changes nothing. Forward only, as in the JAX package, which gives
    it no VJP: under autograd it raises."""
    B, N, H, Dh = q.shape
    M = k.shape[1]
    if k.shape != (B, M, H, Dh) or v.shape != k.shape:
        raise ValueError(f"crossattn_headsmajor: q {q.shape}, k {k.shape}, v {v.shape}")
    if key_mask is None or key_mask.shape != (B, M):
        raise ValueError(f"crossattn_headsmajor: needs a [B, M] key_mask, got {key_mask}")
    if block_q < HEADSMAJOR_ROWS or block_q % HEADSMAJOR_ROWS:
        raise ValueError(f"crossattn_headsmajor: block_q {block_q} is not a multiple of 128")
    if _grad_needed(q, k, v):
        raise RuntimeError("crossattn_headsmajor is forward-only (the JAX package gives it no "
                           "VJP); use impl='allheads' or 'onepass' for gradients")
    if q.device.type == "cpu":
        return headsmajor_reference(q, k, v, key_mask)
    _check_cuda("crossattn_headsmajor", q, k, v)
    _check_head_dim("crossattn_headsmajor", Dh)
    if M > HEADSMAJOR_MAX_KV:
        raise ValueError(f"crossattn_headsmajor: {M} keys > {HEADSMAJOR_MAX_KV}")
    out = torch.empty((B, N, H, Dh + (-Dh % 8)), dtype=q.dtype, device=q.device)
    _cross_launch("headsmajor_attention", *_cross_operands(q, k, v), key_mask, out, Dh)
    crossattn_headsmajor.launches += 1
    return _unpad(out, Dh)


crossattn_headsmajor.launches = 0
