"""The CUDA attention kernels (forward, with the logsumexp, and backward;
flash and headsmajor included) against their plain PyTorch versions, on the
card; the bits/dim loop through them; InceptionV3 and LPIPS on the card
against the CPU.

Marked `gpu`; each test skips without a card. The file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerance, per batch element b, the limits of `chip_smoke.py`:
|err| <= 2^-4 * (|want| + rms_b(want)) and ||err||_b / ||want||_b <= 1e-2.
The kernel rounds the unnormalised probabilities to bf16 and the plain
version the normalised ones, and both round the output to bf16 (f32 inputs:
the kernel also rounds q/k/v to bf16), so a sound kernel reads at most about
half the first limit and a third of the second; a skipped key tile or a
logit scale of 80^-0.5 reads four times the limits or more (PERF.md). The
onepass and flash logsumexp agree within 2^-10 log2 units.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import numpy as np
import pytest
import torch

from pixart_sigma_tpu_torch.ops.attention import CROSSATTN_ENV, attention
from pixart_sigma_tpu_torch.ops.flash_attention import (
    BWD_KEY_STAGES,
    BWD_KEY_TILE,
    CROSS_KEY_STAGES,
    CROSS_KEY_TILE,
    KEY_STAGES,
    KEY_TILE,
    _flash_forward,
    _flash_madd,
    _flash_scale_q,
    _flash_tail,
    _logits,
    _onepass_forward,
    _plain_forward,
    _softmax_pv,
    attention_reference,
    crossattn_allheads,
    crossattn_headsmajor,
    flash_attention,
    flash_backward_reference,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_reference_with_lse,
    headsmajor_reference,
    mask_bias,
    onepass_attention,
)

pytestmark = pytest.mark.gpu
ELEM_TOL, L2_TOL = 2**-4, 1e-2
LSE_TOL = 2**-10  # log2 units, as chip_smoke.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(
        dev, torch.bfloat16)


def _lengths_mask(lengths, M, dev):
    """[B, M] key mask: an int L keeps keys [0, L), a pair (lo, hi) only
    keys [lo, hi) (a caption mask that is not a prefix)."""
    spans = [(0, x) if isinstance(x, int) else x for x in lengths]
    keys = torch.arange(M, device=dev)[None]
    lo, hi = (torch.tensor(col, device=dev)[:, None] for col in zip(*spans))
    return (keys >= lo) & (keys < hi)


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


def _forward(kernel, q, k, v, mask):
    """(kernel output, kernel lse, plain output, plain lse) of onepass or
    flash; the plain version gets the bf16-rounded inputs the kernel reads."""
    pq, pk, pv = (x.to(torch.bfloat16).to(x.dtype) for x in (q, k, v))
    if kernel == "onepass":
        madd = None if mask is None else mask_bias(mask)
        out, lse = _onepass_forward(q, k, v, madd, with_lse=True)
        want, lse_want = _plain_forward(pq, pk, pv, madd)
    else:  # the plain version of the kernel's arithmetic on the pre-scaled q
        M, dt = k.shape[1], q.dtype
        qs, madd, tail = _flash_scale_q(q), _flash_madd(mask, dt), _flash_tail(M, None)
        out, lse = _flash_forward(qs, k, v, madd, tail, with_lse=True)
        pqs = qs.to(torch.bfloat16).to(dt)
        want, lse_want = _softmax_pv(_logits(pqs, pk, madd, scale=1.0), pv, tail, dt)
    torch.cuda.synchronize()
    return out, lse, want, lse_want


def _check_forward(kernel, q, k, v, mask=None):
    counter = onepass_attention if kernel == "onepass" else flash_attention
    before = counter.launches
    out, lse, want, lse_want = _forward(kernel, q, k, v, mask)
    assert counter.launches == before + 1
    _assert_close(out, want)
    finite = torch.isfinite(lse_want)
    assert torch.equal(finite, torch.isfinite(lse))
    assert float((lse - lse_want)[finite].abs().max()) <= LSE_TOL


# The onepass and flash kernels (csrc/hopper_attention.cuh) stream keys in
# tiles of KEY_TILE through a ring of KEY_STAGES[width] stages, and split the
# head dim into columns [0, 64) and [64, 80) (width 80) or [64, 128) (width
# 128); a head dim off a multiple of 8 is padded by the wrapper: the cases
# below sit on either side of each.
HOPPER_CASES = [  # B, N, M, H, Dh, lengths
    (2, 200, 1, 2, 72, None),                       # one key
    (2, 200, KEY_TILE - 1, 2, 72, None),
    (2, 200, KEY_TILE + 1, 2, 72, None),
    (2, 200, KEY_TILE * KEY_STAGES[80] - 1, 2, 72, None),   # the ring's wrap
    (2, 200, KEY_TILE * KEY_STAGES[80], 2, 72, None),
    (2, 200, KEY_TILE * KEY_STAGES[80] + 1, 2, 72, None),
    (2, 4080, 1020, 16, 72, None),                  # the 1088x960 training bucket
    (2, 333, 500, 3, 80, (500, 77)),                # the widest head dim of width 80, masked
    (2, 333, 500, 3, 64, (500, 77)),                # the first column chunk alone
    (2, 200, KEY_TILE * KEY_STAGES[128] - 1, 2, 128, None),  # width 128's ring wrap
    (2, 200, KEY_TILE * KEY_STAGES[128] + 1, 2, 128, None),
    (2, 4096, 1024, 9, 128, None),                  # XL-2 with 9 heads, KV-compressed
    (2, 333, 500, 3, 128, (500, 77)),               # the widest head dim, masked
    (2, 333, 500, 3, 96, (500, 77)),                # 12 heads at XL-2's width
    (2, 333, 500, 3, 88, (500, 77)),                # the narrowest of width 128
    (2, 333, 500, 3, 36, (500, 77)),                # 32 heads at XL-2's width: padded to 40
    (2, 200, 300, 2, 18, None),                     # padded to 24
    (1, 130, 77, 3, 1, None),                       # the narrowest: padded to 8
]


@pytest.mark.parametrize("B,N,M,H,Dh,lengths", [
    (1, 256, 256, 2, 72, None),          # PixArt's head dim, aligned
    (2, 1000, 1008, 3, 72, None),        # unaligned tails (1152x896 px grid)
    (1, 200, 77, 1, 64, None),           # a head dim below the padding of 80
    (2, 300, 300, 2, 72, (300, 1)),      # key mask, one row nearly empty
    *HOPPER_CASES,
])
def test_onepass_kernel_matches_plain(cuda, B, N, M, H, Dh, lengths):
    rng = np.random.RandomState(0)
    q = _randn(rng, (B, N, H, Dh), cuda, 2.0)
    k = _randn(rng, (B, M, H, Dh), cuda)
    v = _randn(rng, (B, M, H, Dh), cuda)
    mask = None if lengths is None else _lengths_mask(lengths, M, cuda)
    _check_forward("onepass", q, k, v, mask)


@pytest.mark.parametrize("B,N,H", [(2, 333, 2), (1, 4608, 16)])
def test_onepass_kernel_reads_strided_qkv(cuda, B, N, H):
    """q/k/v as column slices of one qkv projection output, no copies (at the
    2K width TMA reads rows 6912 bytes apart, heads 144 bytes apart). Every
    row is compared at N = 333; at N = 4608, the first query tile and 300
    rows from the middle."""
    rng = np.random.RandomState(1)
    Dh = 72
    qkv = _randn(rng, (B, N, 3 * H * Dh), cuda)
    q, k, v = (t.unflatten(-1, (H, Dh)) for t in qkv.chunk(3, dim=-1))
    rows = torch.arange(N, device=cuda)
    if N > 1024:
        rows = torch.cat([rows[:KEY_TILE], rows[N // 2 : N // 2 + 300]])
    _assert_close(onepass_attention(q, k, v)[:, rows], attention_reference(q[:, rows], k, v))


# The allheads and headsmajor kernels visit each batch element's key tiles
# (CROSS_KEY_TILE keys) up to its last valid key; an extent of up to
# CROSS_KEY_STAGES tiles stays resident, a longer one streams. The cases
# cover both, captions with no valid key (every tile), masks that are not
# prefixes, and query tiles cut by N.
CROSS_RESIDENT = CROSS_KEY_TILE * CROSS_KEY_STAGES[80]
CROSS_CASES = [  # B, N, M, H, lengths
    (4, 4096, 300, 16, (300, 40, 5, 0)),               # the path width, a caption with no key
    (4, 4096, 300, 16, (19, (256, 300), 77, 3)),       # one caption valid only on [256, 300)
    (2, 200, CROSS_RESIDENT + 1, 2, ((CROSS_RESIDENT, CROSS_RESIDENT + 1), 0)),  # streamed
    (3, 130, 512, 2, (512, (CROSS_RESIDENT - 1, CROSS_RESIDENT), 0)),
    (10, 300, 77, 16, (77, 0, 5, 40, 1, 77, (70, 77), 3, 9, 60)),  # B*H above the SM count
]


@pytest.mark.parametrize("B,N,M,H,lengths,Dh", [
    (4, 1000, 300, 16, (300, 120, 77, 1), 72),  # path widths, unaligned N
    (2, 256, 77, 2, (77, 5), 72),
    (2, 130, 77, 2, (40, 0), 72),  # a row with no valid key averages V
    *(case + (72,) for case in CROSS_CASES),
    (2, 333, 300, 3, (300, (100, 200)), 64),  # the first column chunk alone
    (2, 200, 77, 4, (77, 9), 8),
    (4, 4096, 300, 9, (300, 40, 5, 0), 128),  # XL-2 with 9 heads
    (4, 1000, 300, 12, (19, (256, 300), 77, 3), 96),  # 12 heads
    (2, 200, CROSS_RESIDENT + 1, 2, ((CROSS_RESIDENT, CROSS_RESIDENT + 1), 0), 128),  # streamed
    (4, 1000, 300, 32, (300, 120, 77, 1), 36),  # 32 heads: padded heads-major copies
    (2, 130, 77, 3, (40, 0), 18),
    (2, 200, 77, 5, (77, 9), 1),
])
def test_allheads_kernel_matches_plain(cuda, B, N, M, H, lengths, Dh):
    rng = np.random.RandomState(2)
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


def test_kernels_refuse_head_dims_past_128(cuda):
    """Every kernel takes head dims 1 to 128 and names the limit past it."""
    q = torch.zeros((1, 16, 2, 136), device=cuda, dtype=torch.bfloat16)
    mask = torch.ones((1, 16), device=cuda, dtype=torch.bool)
    lse = torch.zeros((1, 2, 16), device=cuda)
    for call in (lambda: onepass_attention(q, q, q), lambda: flash_attention(q, q, q),
                 lambda: crossattn_allheads(q.flatten(2), q.flatten(2), q.flatten(2), mask, 2),
                 lambda: crossattn_headsmajor(q, q, q, mask, 128),
                 lambda: flash_bwd_dkv(q, q, q, q, None, lse, lse),
                 lambda: flash_bwd_dq(q, q, q, q, None, lse, lse)):
        with pytest.raises(ValueError, match="128"):
            call()


# ---------------------------------------------------------------- training

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
    (2, 333, 300, 2, 72, ((256, 300), 40), torch.bfloat16),  # a caption valid on [256, 300)
    (2, 4080, 1020, 4, 72, None, torch.bfloat16),    # the 1088x960 training bucket
    (2, 1000, 1008, 3, 128, None, torch.bfloat16),   # width 128
    (2, 333, 300, 2, 128, ((256, 300), 40), torch.bfloat16),
    (2, 333, 77, 2, 128, (77, 0), torch.float32),
    (2, 1000, 1008, 3, 96, None, torch.bfloat16),
    (2, 333, 300, 2, 36, (300, 17), torch.bfloat16),  # padded to 40
    (2, 300, 300, 2, 18, None, torch.float32),
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


def test_backward_gradients_past_the_caption_extent_are_zero(cuda):
    """Key tiles past a caption's last valid key are never swept: their dK
    and dV are exactly 0, as the plain version gives; a caption with no
    valid key keeps every tile (f32: P = 1 there, so its gradients are not
    0)."""
    B, N, M, H, Dh = 3, 200, 512, 2, 72
    q, k, v, do, madd = _backward_case(cuda, B, N, M, H, Dh, (100, (130, 140), 0),
                                       torch.float32)
    out, lse = _onepass_forward(q, k, v, madd, with_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = flash_bwd_dkv(q, k, v, do, madd, lse, delta)
    torch.cuda.synchronize()
    for b, extent in ((0, 128), (1, 256)):
        assert bool((dk[b, extent:] == 0).all()) and bool((dv[b, extent:] == 0).all())
    assert bool((dk[2, 256:] != 0).any()) and bool((dv[2, 256:] != 0).any())


@pytest.mark.parametrize("Dh", [72, 128, 36])
def test_autograd_runs_the_kernels(cuda, Dh):
    """Gradients through both forward kernels' autograd Functions on the card
    against torch's autograd of the plain math (f32 inputs, the kernels round
    them to bf16)."""
    rng = np.random.RandomState(6)
    B, N, M, H = 2, 200, 77, 2
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


# ---------------------------------------------------------------- 2K / 4K


@pytest.mark.parametrize("B,N,M,H,Dh,lengths,dtype", [
    (1, 256, 256, 2, 72, None, torch.bfloat16),
    (2, 1000, 8200, 2, 72, None, torch.bfloat16),          # 2048-key blocks, ragged tail
    (2, 1000, 8200, 1, 72, None, torch.float32),
    (2, 900, 2500, 2, 72, (2500, 0), torch.bfloat16),      # a masked row with a tail: 0
    (2, 900, 2500, 1, 72, (1700, 0), torch.float32),       # f32: sum(V) / 2560
    (1, 200, 77, 1, 64, None, torch.bfloat16),             # a head dim below the padding
    *(case + (torch.bfloat16,) for case in HOPPER_CASES),
    (2, 1000, 8200, 1, 128, None, torch.float32),         # width 128
    (2, 900, 2500, 2, 128, (2500, 0), torch.bfloat16),
    (2, 900, 2500, 1, 36, (1700, 0), torch.float32),      # padded to 40
])
def test_flash_kernel_matches_plain(cuda, B, N, M, H, Dh, lengths, dtype):
    """f32: the plain version gets the scaled q rounded to bf16, as the
    kernel reads it."""
    rng = np.random.RandomState(7)
    t = lambda shape, scale=1.0: torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32)).to(cuda, dtype)
    q, k, v = t((B, N, H, Dh), 2.0), t((B, M, H, Dh)), t((B, M, H, Dh))
    mask = None if lengths is None else _lengths_mask(lengths, M, cuda)
    _check_forward("flash", q, k, v, mask)


def test_flash_reads_strided_qkv_at_the_2k_width(cuda):
    """q/k/v as column slices of one qkv projection output, 16 heads."""
    rng = np.random.RandomState(8)
    B, N, H, Dh = 1, 4608, 16, 72
    qkv = _randn(rng, (B, N, 3 * H * Dh), cuda)
    q, k, v = (x.unflatten(-1, (H, Dh)) for x in qkv.chunk(3, dim=-1))
    got = flash_attention(q, k, v)
    rows = slice(1000, 1300)
    _assert_close(got[:, rows], flash_reference_with_lse(q[:, rows], k, v)[0])


@pytest.mark.parametrize("Dh", [72, 128, 36])
def test_flash_autograd_runs_the_kernels(cuda, Dh):
    """Gradients through the flash Function on the card against torch's
    autograd of the plain version (f32 inputs, rounded to bf16 inside)."""
    rng = np.random.RandomState(9)
    B, N, M, H = 2, 200, 300, 2
    f32 = lambda shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)
    q, k, v, g = f32((B, N, H, Dh)), f32((B, M, H, Dh)), f32((B, M, H, Dh)), f32((B, N, H, Dh))
    mask = _lengths_mask((300, 30), M, cuda)
    before = (flash_attention.launches, flash_bwd_dkv.launches, flash_bwd_dq.launches)
    args = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_attention(*args, key_mask=mask).backward(g)
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_reference_with_lse(*ref, mask)[0].backward(g)
    after = (flash_attention.launches, flash_bwd_dkv.launches, flash_bwd_dq.launches)
    assert after == tuple(b + 1 for b in before)
    for a, r in zip(args, ref):
        _assert_close(a.grad, r.grad)


@pytest.mark.parametrize("B,N,M,H,lengths,dtype,block_q,Dh", [
    *(case + (72,) for case in [
        (4, 4096, 300, 16, (300, 120, 77, 1), torch.bfloat16, 256),  # the 1024px path
        (4, 1000, 300, 16, (300, 120, 77, 1), torch.bfloat16, 256),  # ragged query tail
        (2, 130, 77, 2, (40, 0), torch.bfloat16, 128),  # a row with no valid key averages V
        (2, 333, 77, 2, (77, 5), torch.float32, 512),
        *(case + (torch.bfloat16, 256) for case in CROSS_CASES),
        (2, 333, 300, 2, (300, (200, 210)), torch.float32, 128),
    ]),
    (4, 4096, 300, 9, (300, 120, 77, 1), torch.bfloat16, 256, 128),
    (2, 333, 77, 2, (77, 5), torch.float32, 512, 128),
    (4, 1000, 300, 12, (300, (256, 300), 77, 0), torch.bfloat16, 256, 96),
    (4, 1000, 300, 32, (300, 120, 77, 1), torch.bfloat16, 256, 36),
])
def test_headsmajor_kernel_matches_plain(cuda, B, N, M, H, lengths, dtype, block_q, Dh):
    rng = np.random.RandomState(10)
    C = H * Dh
    t = lambda shape, scale=1.0: torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32)).to(cuda, dtype)
    q = t((B, N, H, Dh), 2.0)
    kv = t((B, M, 2 * C))  # hoisted K/V: column slices
    k, v = kv[..., :C].unflatten(-1, (H, Dh)), kv[..., C:].unflatten(-1, (H, Dh))
    mask = _lengths_mask(lengths, M, cuda)
    before = crossattn_headsmajor.launches
    got = crossattn_headsmajor(q, k, v, mask, block_q=block_q)
    torch.cuda.synchronize()
    assert crossattn_headsmajor.launches == before + 1
    _assert_close(got, headsmajor_reference(q, k, v, mask))


def test_auto_dispatch_takes_flash_and_the_crossattn_override(cuda, monkeypatch):
    rng = np.random.RandomState(11)
    q = _randn(rng, (1, 256, 2, 72), cuda)
    kv = _randn(rng, (1, 5000, 2, 72), cuda)
    cap = _randn(rng, (1, 300, 2, 72), cuda)
    mask = _lengths_mask((100,), 300, cuda)
    monkeypatch.delenv(CROSSATTN_ENV, raising=False)
    flash, heads = flash_attention.launches, crossattn_headsmajor.launches
    attention(q, kv, kv)
    assert flash_attention.launches == flash + 1
    monkeypatch.setenv(CROSSATTN_ENV, "headsmajor")
    attention(q, cap, cap, key_mask=mask)
    assert crossattn_headsmajor.launches == heads + 1
    with pytest.raises(RuntimeError, match="forward-only"):
        crossattn_headsmajor(q.float().requires_grad_(), cap.float(), cap.float(), mask)
    allheads = crossattn_allheads.launches  # a gradient takes the differentiable kernel
    attention(q.float().requires_grad_(), cap.float(), cap.float(), key_mask=mask).sum().backward()
    assert crossattn_allheads.launches == allheads + 1
    assert crossattn_headsmajor.launches == heads + 1


# ---------------------------------------------------------------- the Hopper forward body


def test_forward_key_tile_is_the_librarys(cuda):
    """The libraries' keys per tile and ring depth are the wrapper's
    KEY_TILE and KEY_STAGES (CROSS_KEY_TILE and CROSS_KEY_STAGES for
    allheads and headsmajor), which the cases above are built from."""
    from pixart_sigma_tpu_torch.ops import _build
    from pixart_sigma_tpu_torch.ops.flash_attention import _check_key_geometry

    for name in ("onepass_attention", "flash_forward"):
        lib = _build.load(name)
        assert _check_key_geometry(lib, name) is lib
    lib = _build.load("cross_attention")
    assert _check_key_geometry(lib, "cross_attention", CROSS_KEY_TILE, CROSS_KEY_STAGES) is lib
    lib = _build.load("flash_backward")
    assert _check_key_geometry(lib, "flash_backward", BWD_KEY_TILE, BWD_KEY_STAGES) is lib


@pytest.mark.parametrize("M", [4096, 1024])
def test_onepass_lse_at_the_training_shape(cuda, M):
    """The row logsumexp that dkv/dq recompute P from, at B*H = 64."""
    rng = np.random.RandomState(17)
    B, N, H, Dh = 4, 4096, 16, 72
    qkv = _randn(rng, (B, N, 3 * H * Dh), cuda)
    q, k, v = (x.unflatten(-1, (H, Dh)) for x in qkv.chunk(3, dim=-1))
    if M != N:
        k, v = _randn(rng, (B, M, H, Dh), cuda), _randn(rng, (B, M, H, Dh), cuda)
    _check_forward("onepass", q, k, v)


@pytest.fixture(scope="module")
def toy_pipeline():
    """A 2-block PixArtMS (width 144, 2 heads of 72, KV compression on block
    1) on the card, bf16, seeded random weights, the pseudo text encoder."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pixart_sigma_tpu_torch.models.pixart import PixArtMS_XL_2, init_weights
    from pixart_sigma_tpu_torch.models.t5 import PseudoT5Embedder
    from pixart_sigma_tpu_torch.pipelines import PixArtPipeline

    dev = torch.device("cuda")
    model = PixArtMS_XL_2(input_size=16, depth=2, hidden_size=144, num_heads=2,
                          caption_channels=32, model_max_length=12,
                          kv_compress_sampling="conv", kv_compress_scale=2,
                          kv_compress_layers=(1,), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    init_weights(model, gen)
    with torch.no_grad():
        for block in model.blocks:
            block.cross_attn.proj.weight.normal_(0.0, 0.02, generator=gen)
        model.final_layer.linear.weight.normal_(0.0, 0.02, generator=gen)
    return PixArtPipeline(model, t5=PseudoT5Embedder(32, 12), device=dev)


@pytest.mark.parametrize("sampler,steps,nfe", [
    ("dpm-solver", 4, 4), ("deis", 4, 4), ("sde-dpm-solver", 4, 4), ("sa-solver", 5, 5),
    ("iddpm", 6, 6), ("lcm", 4, 4), ("dmd", 1, 1)])
def test_every_sampler_runs_the_kernels(toy_pipeline, sampler, steps, nfe):
    """One onepass and one allheads launch per block and model call (the CFG
    batch is one call), no flash and no headsmajor, finite moving latents."""
    counters = (onepass_attention, crossattn_allheads, flash_attention, crossattn_headsmajor)
    for c in counters:
        c.launches = 0
    x0 = torch.randn((2, 16, 16, 4), generator=torch.Generator().manual_seed(1))
    lat = toy_pipeline(["a red cat", "a dog"], height=128, width=128, sampler=sampler,
                       num_inference_steps=steps, negative_prompt="blurry", latents=x0,
                       return_latents=True)
    assert [c.launches for c in counters] == [2 * nfe, 2 * nfe, 0, 0]
    assert np.isfinite(lat).all() and np.abs(lat - x0.numpy()).max() > 1e-2


def _model_step_grads(model, batch, t, noise, drop, impl):
    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.training.train_step import compute_losses

    for mod in model.modules():
        if hasattr(mod, "attn_impl"):
            mod.attn_impl = impl
    model.zero_grad(set_to_none=True)
    diffusion = IDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)
    compute_losses(model, diffusion, batch, t, noise, force_drop_ids=drop)["loss"].backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _toy_2k_model(dev, depth, **kw):
    from pixart_sigma_tpu_torch.models.pixart import PixArtMS_XL_2, init_weights

    gen = torch.Generator(device=dev).manual_seed(3)
    model = PixArtMS_XL_2(device=dev, train=True, input_size=256, pe_interpolation=4.0,
                          depth=depth, model_max_length=300, kv_compress_sampling="conv",
                          kv_compress_scale=2, kv_compress_layers=tuple(range(depth // 2, depth)),
                          **kw)
    init_weights(model, gen)
    with torch.no_grad():  # the zero-initialised projections would hide the blocks
        for block in model.blocks:
            block.cross_attn.proj.weight.normal_(0.0, 0.02, generator=gen)
        model.final_layer.linear.weight.normal_(0.0, 0.02, generator=gen)
    return model, gen


def test_model_gradients_through_flash_match_plain(cuda):
    """One training step of the 2K model at depth 2 (layer 1 KV-compressed),
    B = 1, on a 130x132 latent (4290 tokens, past the onepass gate, not a
    multiple of the key tile): layer 0 runs flash's autograd Function, and
    every gradient is within chip_smoke.py's 2e-2 relative L2 of plain
    attention's."""
    model, gen = _toy_2k_model(cuda, 2)
    randn = lambda *s: torch.randn(s, generator=gen, device=cuda)
    batch = {"latents": randn(1, 130, 132, 4), "y": randn(1, 300, 4096),
             "y_mask": (torch.arange(300, device=cuda) < 11).int()[None]}
    t, drop = torch.tensor([400], device=cuda), torch.tensor([0], device=cuda)
    noise = randn(1, 130, 132, 4)
    flash_attention.launches = 0
    got = _model_step_grads(model, batch, t, noise, drop, "auto")
    assert flash_attention.launches == 1
    want = _model_step_grads(model, batch, t, noise, drop, "reference")
    diff = sum(float((got[n] - want[n]).pow(2).sum()) for n in want)
    assert (diff / sum(float(w.pow(2).sum()) for w in want.values())) ** 0.5 <= 2e-2
    for n in want:
        assert float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30)) <= 2e-2, n


@pytest.mark.parametrize("remat_policy,recompute", [("nothing", True), ("save_attn", False)])
def test_2k_training_step_launches(cuda, remat_policy, recompute):
    """A 2K training step (2048x2048 latent, 16384 tokens) of the 2K model
    cut to depth 2 with grad checkpointing: flash in layer 0, onepass over
    the 4096 compressed keys in layer 1, allheads for the captions, and the
    backward pair twice per layer; "nothing" runs each forward again in the
    backward, "save_attn" does not, and the cross-attention backward
    recomputes its lse through onepass either way."""
    model, gen = _toy_2k_model(cuda, 2, grad_checkpointing=True, remat_policy=remat_policy)
    randn = lambda *s: torch.randn(s, generator=gen, device=cuda)
    batch = {"latents": randn(1, 256, 256, 4), "y": randn(1, 300, 4096),
             "y_mask": (torch.arange(300, device=cuda) < 7).int()[None]}
    counters = (flash_attention, onepass_attention, crossattn_allheads, flash_bwd_dkv,
                flash_bwd_dq, crossattn_headsmajor)
    for fn in counters:
        fn.launches = 0
    _model_step_grads(model, batch, torch.tensor([500], device=cuda), randn(1, 256, 256, 4),
                      torch.tensor([0], device=cuda), "auto")
    runs = 2 if recompute else 1
    assert [fn.launches for fn in counters] == [runs, runs + 2, 2 * runs, 4, 4, 0]


# the encoders on the card, at the limits of chip_smoke.py phases 15 and 16
T5_REL_TOL, VAE_REL_TOL = 0.1, 1e-3


def test_t5_encoder_bf16_matches_f32_on_the_card(cuda):
    """A 6-layer T5 at width 512 (8 heads of 64), seeded weights: bf16
    against the f32 copy with the same weights, per caption over its valid
    tokens; dropping layer 0's position bias or the key mask exceeds it."""
    from pixart_sigma_tpu_torch.models.t5 import T5Config, build_t5, init_weights

    kw = dict(d_model=512, num_heads=8, d_ff=1280, num_layers=6, vocab_size=1000)
    enc = build_t5(T5Config(**kw), device=cuda)
    init_weights(enc, torch.Generator(device=cuda).manual_seed(0))
    ref = build_t5(T5Config(**kw, dtype=torch.float32), device=cuda, param_dtype=torch.float32)
    ref.load_state_dict(enc.state_dict())
    gen = torch.Generator(device=cuda).manual_seed(1)
    ids = torch.randint(2, 1000, (3, 120), generator=gen, device=cuda)
    mask = (torch.arange(120, device=cuda)[None] < torch.tensor([[120], [37], [5]],
                                                                device=cuda)).long()
    valid = mask.bool()
    with torch.no_grad():
        want = ref(ids, mask)
        got = enc(ids, mask)
        no_mask = enc(ids, torch.ones_like(mask))
        table = enc.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        table.zero_()
        no_bias = enc(ids, mask)

    def reading(out):
        return max(float((out[b][valid[b]].float() - want[b][valid[b]]).norm()
                         / want[b][valid[b]].norm()) for b in range(3))

    assert got.dtype == torch.bfloat16 and reading(got) <= T5_REL_TOL
    assert reading(no_mask) > T5_REL_TOL and reading(no_bias) > T5_REL_TOL


def test_vae_encoder_on_the_card_matches_the_cpu(cuda):
    """The SDXL VAE's encoder (f32, TF32 off) at 128px on the card against
    the same weights on the CPU: mean and log-variance."""
    from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.manual_seed(0)
    vae = build_vae(VAEConfig.sdxl(), device=cuda)
    host = build_vae(VAEConfig.sdxl(), device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in vae.state_dict().items()})
    x = torch.rand((2, 128, 136, 3), generator=torch.Generator().manual_seed(0)) * 2 - 1
    with torch.no_grad():
        got, want = vae.encode(x.to(cuda)), host.encode(x)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 16, 17, 4)
        assert float((g.cpu() - w).norm() / w.norm()) <= VAE_REL_TOL


INT8_ELEM_TOL, INT8_L2_TOL = 2**-9, 1e-4  # as chip_smoke.py


def test_int8_product_matches_the_cpu_bit_for_bit(cuda):
    """`torch._int_mm` at a block's qkv shape (one image with CFG: 2 x 4096
    rows, 1152 -> 3456) against the plain version on the CPU: the quantized
    operands and the int32 accumulator equal, the bf16 output within the
    limits of chip_smoke.py."""
    from pixart_sigma_tpu_torch.ops.quant import (
        int8_accumulate,
        int8_accumulate_reference,
        int8_matmul_quantized,
        quantize_rows,
        quantize_weight,
    )

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8192, 1152).astype(np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy((rng.randn(3456, 1152) * 0.03).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.randn(3456).astype(np.float32)).to(cuda)
    qx, sx = quantize_rows(x)
    qw, sw = quantize_weight(w)
    qx_c, sx_c = quantize_rows(x.cpu())
    qw_c, sw_c = quantize_weight(w.cpu())
    for got, want in ((qx, qx_c), (sx, sx_c), (qw, qw_c), (sw, sw_c)):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(int8_accumulate(qx, qw).cpu(), int8_accumulate_reference(qx_c, qw_c))
    got = int8_matmul_quantized(x, qw, sw, b).cpu().float()
    want = int8_matmul_quantized(x.cpu(), qw_c, sw_c, b.cpu()).float()
    err = got - want
    rms = want.pow(2).mean(1, keepdim=True).sqrt()
    assert float((err.abs() / (want.abs() + rms)).max()) <= INT8_ELEM_TOL
    assert float((err.norm(dim=1) / want.norm(dim=1)).max()) <= INT8_L2_TOL


def test_int8_product_refuses_what_int_mm_does_not_take(cuda):
    """A shape outside `_int_mm`'s limits raises on the card; it does not
    fall back to another product."""
    from pixart_sigma_tpu_torch.ops.quant import int8_accumulate

    q = lambda *s: torch.ones(s, dtype=torch.int8, device=cuda)
    assert int8_accumulate(q(32, 64), q(40, 64).t()).dtype == torch.int32
    for a, b in ((q(16, 64), q(40, 64).t()), (q(32, 60), q(40, 60).t()),
                 (q(32, 64), q(36, 64).t()), (q(64, 32).t(), q(40, 64).t())):
        with pytest.raises(ValueError):
            int8_accumulate(a, b)


def test_calc_bpd_loop_runs_the_kernels(toy_pipeline):
    """The bits/dim over a 6-step spaced chain: one onepass and one
    allheads launch per block and model call, against plain attention
    within 2e-2 per timestep (relative L2 over the batch)."""
    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.diffusion.noise import generator_noise

    model, dev = toy_pipeline.model, torch.device("cuda")
    diffusion = IDDPM(timestep_respacing="6").to(dev)
    y, mask = toy_pipeline.t5.get_text_embeddings(["a red cat", "a dog"])
    x0 = torch.rand((2, 16, 16, 4), generator=torch.Generator().manual_seed(2)).to(dev) * 2 - 1

    def bpd():
        fn = lambda x, t: model(x, t.float(), y.to(dev), mask.to(dev)).float()
        gen = torch.Generator(device=dev).manual_seed(3)
        with torch.no_grad():
            return diffusion.calc_bpd_loop(fn, x0, generator_noise(gen),
                                           timestep_map=diffusion.timestep_map)

    for c in (onepass_attention, crossattn_allheads):
        c.launches = 0
    got = bpd()
    assert [onepass_attention.launches, crossattn_allheads.launches] == [12, 12]
    for mod in model.modules():
        if hasattr(mod, "attn_impl"):
            mod.attn_impl = "reference"
    try:
        want = bpd()
    finally:
        for mod in model.modules():
            if hasattr(mod, "attn_impl"):
                mod.attn_impl = "auto"
    rel = (got["vb"] - want["vb"]).norm(dim=0) / want["vb"].norm(dim=0)
    assert torch.isfinite(got["total_bpd"]).all() and float(rel.max()) <= 2e-2


@pytest.mark.parametrize("side", [128, 300])
def test_inception_on_the_card_matches_the_cpu(cuda, side):
    """The fixed-seed random extractor, f32 with TF32 off, through the resize
    to 299 (an enlargement, and a shrink): relative L2 <= 1e-3."""
    from pixart_sigma_tpu_torch.models.inception import (
        extract_activations,
        random_inception_params,
    )

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        imgs = np.random.RandomState(4).uniform(0, 1, (3, side, side, 3)).astype(np.float32)
        got = extract_activations(random_inception_params(0, cuda), imgs, batch=2)
        want = extract_activations(random_inception_params(0, "cpu"), imgs, batch=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-3


def test_lpips_on_the_card_matches_the_cpu(cuda):
    from pixart_sigma_tpu_torch.models.lpips import build_lpips

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        x0, x1 = (torch.from_numpy(np.random.RandomState(s).uniform(
            -1, 1, (2, 64, 64, 3)).astype(np.float32)) for s in (5, 6))
        with torch.no_grad():
            got = build_lpips(cuda)(x0.to(cuda), x1.to(cuda)).cpu()
            want = build_lpips("cpu")(x0, x1)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert float((got - want).norm() / want.norm()) <= 1e-3
