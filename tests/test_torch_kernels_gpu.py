"""The CUDA attention kernels (forward, with the logsumexp, and backward)
against their plain PyTorch versions, on the card.

Marked `gpu`; each test skips without a card. The file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerance, per batch element b, the limits of `chip_smoke.py`:
|err| <= 2^-4 * (|want| + rms_b(want)) and ||err||_b / ||want||_b <= 1e-2.
The kernel rounds the unnormalised probabilities to bf16 and the plain
version the normalised ones, and both round the output to bf16 (f32 inputs:
the kernel also rounds q/k/v to bf16), so a sound kernel reads at most about
half the first limit and a third of the second; a skipped 64-key tile or a
logit scale of 80^-0.5 reads four times the limits or more (PERF.md).
"""

import numpy as np
import pytest
import torch

from pixart_sigma_tpu_torch.ops.attention import attention
from pixart_sigma_tpu_torch.ops.flash_attention import (
    _onepass_forward,
    _plain_forward,
    attention_reference,
    crossattn_allheads,
    flash_backward_reference,
    flash_bwd_dkv,
    flash_bwd_dq,
    mask_bias,
    onepass_attention,
)

pytestmark = pytest.mark.gpu
ELEM_TOL, L2_TOL = 2**-4, 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(
        dev, torch.bfloat16)


def _lengths_mask(lengths, M, dev):
    return torch.arange(M, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]


def _assert_close(got, want):
    assert got.dtype == want.dtype
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    dims = tuple(range(1, w.dim()))
    err = g - w
    rms = w.pow(2).mean(dims, keepdim=True).sqrt()
    elem = float((err.abs() / (w.abs() + rms).clamp_min(1e-30)).max())
    l2 = float((err.pow(2).sum(dims).sqrt() / w.pow(2).sum(dims).sqrt().clamp_min(1e-30)).max())
    assert elem <= ELEM_TOL and l2 <= L2_TOL, (elem, l2)


@pytest.mark.parametrize("B,N,M,H,Dh,lengths", [
    (1, 256, 256, 2, 72, None),          # PixArt's head dim, aligned
    (2, 1000, 1008, 3, 72, None),        # unaligned tails (1152x896 px grid)
    (1, 200, 77, 1, 64, None),           # a head dim below the padding of 80
    (2, 300, 300, 2, 72, (300, 1)),      # key mask, one row nearly empty
])
def test_onepass_kernel_matches_plain(cuda, B, N, M, H, Dh, lengths):
    rng = np.random.RandomState(0)
    q = _randn(rng, (B, N, H, Dh), cuda, 2.0)
    k = _randn(rng, (B, M, H, Dh), cuda)
    v = _randn(rng, (B, M, H, Dh), cuda)
    mask = None if lengths is None else _lengths_mask(lengths, M, cuda)
    before = onepass_attention.launches
    got = onepass_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert onepass_attention.launches == before + 1
    _assert_close(got, attention_reference(q, k, v, mask))


def test_onepass_kernel_reads_strided_qkv(cuda):
    """q/k/v as column slices of one qkv projection output, no copies."""
    rng = np.random.RandomState(1)
    B, N, H, Dh = 2, 333, 2, 72
    qkv = _randn(rng, (B, N, 3 * H * Dh), cuda)
    q, k, v = (t.unflatten(-1, (H, Dh)) for t in qkv.chunk(3, dim=-1))
    _assert_close(onepass_attention(q, k, v), attention_reference(q, k, v))


@pytest.mark.parametrize("B,N,M,H,lengths", [
    (4, 1000, 300, 16, (300, 120, 77, 1)),  # path widths, unaligned N
    (2, 256, 77, 2, (77, 5)),
    (2, 130, 77, 2, (40, 0)),  # a row with no valid key averages V
])
def test_allheads_kernel_matches_plain(cuda, B, N, M, H, lengths):
    rng = np.random.RandomState(2)
    Dh = 72
    C = H * Dh
    q = _randn(rng, (B, N, C), cuda, 2.0)
    kv = _randn(rng, (B, M, 2 * C), cuda)  # hoisted K/V: column slices
    k, v = kv[..., :C], kv[..., C:]
    mask = _lengths_mask(lengths, M, cuda)
    before = crossattn_allheads.launches
    got = crossattn_allheads(q, k, v, mask, H)
    torch.cuda.synchronize()
    assert crossattn_allheads.launches == before + 1
    split = lambda x: x.unflatten(-1, (H, Dh))
    _assert_close(got, attention_reference(split(q), split(k), split(v), mask).flatten(2))


def test_auto_dispatch_uses_the_kernels(cuda):
    rng = np.random.RandomState(3)
    q = _randn(rng, (1, 256, 2, 72), cuda)
    kv = _randn(rng, (1, 300, 2, 72), cuda)
    mask = _lengths_mask((100,), 300, cuda)
    one, all_ = onepass_attention.launches, crossattn_allheads.launches
    attention(q, q, q)
    attention(q, kv, kv, key_mask=mask)
    assert onepass_attention.launches == one + 1
    assert crossattn_allheads.launches == all_ + 1


def test_kernels_take_float32(cuda):
    """f32 in and out; q/k/v are rounded to bf16 for the tensor cores."""
    rng = np.random.RandomState(4)
    f32 = lambda shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)
    q, k, v = f32((2, 333, 3, 72)), f32((2, 1008, 3, 72)), f32((2, 1008, 3, 72))
    _assert_close(onepass_attention(q, k, v), attention_reference(q, k, v))
    qf, kv = f32((2, 333, 144)), f32((2, 77, 288))
    mask = _lengths_mask((77, 5), 77, cuda)
    split = lambda x: x.unflatten(-1, (2, 72))
    want = attention_reference(split(qf), split(kv[..., :144]), split(kv[..., 144:]), mask)
    _assert_close(crossattn_allheads(qf, kv[..., :144], kv[..., 144:], mask, 2), want.flatten(2))


def test_kernels_refuse_other_dtypes(cuda):
    q = torch.zeros((1, 16, 1, 72), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        onepass_attention(q, q, q)
    with pytest.raises(TypeError):
        onepass_attention(q.bfloat16(), q.float(), q.float())


# ---------------------------------------------------------------- training

LSE_TOL = 2**-10  # log2 units, as chip_smoke.py


def _backward_case(dev, B, N, M, H, Dh, lengths, dtype, seed=5):
    rng = np.random.RandomState(seed)
    t = lambda shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
    q, k, v, do = t((B, N, H, Dh)), t((B, M, H, Dh)), t((B, M, H, Dh)), t((B, N, H, Dh))
    madd = None if lengths is None else mask_bias(_lengths_mask(lengths, M, dev))
    return q, k, v, do, madd


@pytest.mark.parametrize("B,N,M,H,Dh,lengths,dtype", [
    (1, 256, 256, 2, 72, None, torch.bfloat16),
    (2, 1000, 1008, 3, 72, None, torch.bfloat16),    # unaligned tails
    (2, 300, 300, 2, 72, (300, 17), torch.bfloat16),  # ragged key mask
    (1, 200, 77, 1, 64, None, torch.bfloat16),       # a head dim below the padding
    (2, 333, 77, 2, 72, (77, 0), torch.float32),     # f32, one row with no valid key
])
def test_backward_kernels_match_plain(cuda, B, N, M, H, Dh, lengths, dtype):
    """f32 inputs: the plain version gets q, k, v and dO rounded to bf16, as
    the kernels multiply them."""
    q, k, v, do, madd = _backward_case(cuda, B, N, M, H, Dh, lengths, dtype)
    pq, pk, pv, pdo = (x.to(torch.bfloat16).to(dtype) for x in (q, k, v, do))
    out, lse = _onepass_forward(q, k, v, madd, with_lse=True)
    out_p, lse_p = _plain_forward(pq, pk, pv, madd)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, N) and float((lse - lse_p).abs().max()) <= LSE_TOL
    _assert_close(out, out_p)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    madd_b = None if madd is None else madd.to(dtype).float()
    dkv, dq = flash_bwd_dkv.launches, flash_bwd_dq.launches
    dk, dv = flash_bwd_dkv(q, k, v, do, madd_b, lse, delta)
    got_dq = flash_bwd_dq(q, k, v, do, madd_b, lse, delta)
    torch.cuda.synchronize()
    assert (flash_bwd_dkv.launches, flash_bwd_dq.launches) == (dkv + 1, dq + 1)
    want = flash_backward_reference(pq, pk, pv, madd_b, lse, delta, pdo)
    for got, w in zip((got_dq, dk, dv), want):
        _assert_close(got, w)


def test_autograd_runs_the_kernels(cuda):
    """Gradients through both forward kernels' autograd Functions on the card
    against torch's autograd of the plain math (f32 inputs, the kernels round
    them to bf16)."""
    rng = np.random.RandomState(6)
    B, N, M, H, Dh = 2, 200, 77, 2, 72
    f32 = lambda shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)
    q, k, v, g = f32((B, N, H, Dh)), f32((B, M, H, Dh)), f32((B, M, H, Dh)), f32((B, N, H, Dh))
    mask = _lengths_mask((77, 30), M, cuda)
    for fn in (lambda q, k, v: onepass_attention(q, k, v, mask),
               lambda q, k, v: crossattn_allheads(q.flatten(2), k.flatten(2), v.flatten(2),
                                                  mask, H).unflatten(-1, (H, Dh))):
        before = (flash_bwd_dkv.launches, flash_bwd_dq.launches)
        args = [x.clone().requires_grad_() for x in (q, k, v)]
        fn(*args).backward(g)
        ref = [x.clone().requires_grad_() for x in (q, k, v)]
        attention_reference(*ref, mask).backward(g)
        assert (flash_bwd_dkv.launches, flash_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
        for a, r in zip(args, ref):
            _assert_close(a.grad, r.grad)
