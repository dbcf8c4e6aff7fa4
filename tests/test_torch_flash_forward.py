"""The port's long-sequence flash attention and heads-major cross-attention
against the JAX Pallas kernels, on the CPU.

On CPU tensors `flash_attention` and `crossattn_headsmajor` run their plain
versions (`flash_reference_with_lse`, `headsmajor_reference`); here they are
held against the JAX `flash_attention` (`_fwd_kernel`) and
`crossattn_headsmajor` (`_headsmajor_kernel`) run in interpret mode, with
small forced blocks so that several key blocks and a ragged tail run, and
against `jax.vjp` of the JAX `flash_attention` (whose backward runs
`_bwd_dkv_kernel` and `_bwd_dq_kernel`).

Tolerances: forward float32 2e-5 and bfloat16 2e-2 (the JAX kernel tests'
own); lse float32 2e-5 and bfloat16 2e-2 absolute, log2 units; gradients
float32 5e-4, bfloat16 2e-2 relative to the gradient's largest entry (as
tests/test_torch_flash_backward.py).

A row whose keys are all masked is pinned as the TPU kernel gives it: in f32
sum(V) / M_pad with M_pad the key count padded to the key block; in bf16 0
when M leaves a padded tail in its last key block, NaN when it fills it.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pixart_sigma_tpu.ops import flash_attention as jfa
from pixart_sigma_tpu_torch.ops import flash_attention as tfa

F32, BF16 = dict(atol=2e-5, rtol=2e-5), dict(atol=2e-2, rtol=2e-2)


def _arrays(B, N, M, H, Dh, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((B, N, H, Dh), (B, M, H, Dh), (B, M, H, Dh), (B, N, H, Dh))]


def _mask(lengths, M):
    return None if lengths is None else np.arange(M)[None] < np.asarray(lengths)[:, None]


def _dtypes(bf16):
    return (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)


def _jax_flash(q, k, v, mask, bf16, block_q, block_k):
    jdt = _dtypes(bf16)[0]
    with pltpu.force_tpu_interpret_mode():
        out = jfa.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                  key_mask=None if mask is None else jnp.asarray(mask),
                                  block_q=block_q, block_k=block_k)
    return np.asarray(out, np.float32)


def _jax_flash_lse(q, k, v, mask, bf16, block_q, block_k):
    """The lse of `_flash_core_fwd`, with the inputs prepared as the JAX
    `flash_attention` prepares them: [B, H, N] f32, log2 units."""
    jdt = _dtypes(bf16)[0]
    q, k, v = (jnp.asarray(a, jdt) for a in (q, k, v))
    B, N, H, Dh = q.shape
    M = k.shape[1]
    bq = min(block_q, -(-N // 128) * 128)
    bk = min(block_k, -(-M // 128) * 128)
    n_pad, m_pad = -(-N // bq) * bq, -(-M // bk) * bk
    q = q * jnp.asarray(Dh**-0.5 * jfa._LOG2E, q.dtype)

    def to_bh(x, seq_pad):
        x = x.transpose(0, 2, 1, 3).reshape(B * H, x.shape[1], Dh)
        return jfa._pad_heads(jnp.pad(x, ((0, 0), (0, seq_pad - x.shape[1]), (0, 0))), 128)

    qb, kb, vb = to_bh(q, n_pad), to_bh(k, m_pad), to_bh(v, m_pad)
    if mask is not None:
        madd = jnp.where(jnp.asarray(mask), 0.0, jfa._NEG_INF).astype(kb.dtype)
        madd = jnp.repeat(jnp.pad(madd, ((0, 0), (0, m_pad - M))), H, axis=0)
        kb = kb.at[:, :, 127].set(madd)
        qb = qb.at[:, :, 127].set(jnp.asarray(1.0, qb.dtype))
    with pltpu.force_tpu_interpret_mode():
        _, lse = jfa._flash_fwd(qb, kb, vb, 1.0, bq, bk, M, with_lse=True)
    return np.asarray(lse[:, :N, 0]).reshape(B, H, N)


@pytest.mark.parametrize("B,N,M,H,lengths,bf16,block_q,block_k", [
    (1, 200, 300, 2, None, False, 128, 128),        # 3 key blocks, ragged tail
    (2, 100, 300, 2, (300, 0), False, 128, 128),    # f32 fully masked row: sum(V) / 384
    (2, 100, 256, 2, (256, 0), False, 128, 128),    # f32, no tail: sum(V) / 256
    (1, 200, 300, 2, None, True, 128, 128),
    (2, 100, 300, 2, (300, 0), True, 128, 128),     # bf16 with a tail: 0
    (2, 100, 256, 2, (256, 0), True, 128, 128),     # bf16, no tail: NaN
    (2, 64, 200, 1, (200, 37), True, None, None),   # default blocks (512)
])
def test_flash_matches_jax_kernel(B, N, M, H, lengths, bf16, block_q, block_k):
    q, k, v, _ = _arrays(B, N, M, H, 72, seed=0)
    mask = _mask(lengths, M)
    want = _jax_flash(q, k, v, mask, bf16, block_q, block_k)
    tdt = _dtypes(bf16)[1]
    got = tfa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                              key_mask=None if mask is None else torch.from_numpy(mask),
                              block_q=block_q, block_k=block_k)
    assert got.dtype == tdt and got.shape == (B, N, H, 72)
    got = got.float().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **(BF16 if bf16 else F32))
    if lengths is not None and lengths[-1] == 0:  # the pinned fully masked row
        bk = min(block_k or 512, -(-M // 128) * 128)
        m_pad = -(-M // bk) * bk
        if not bf16:
            np.testing.assert_allclose(got[-1], np.broadcast_to(
                v[-1].sum(axis=0) / m_pad, (N, H, 72)), atol=1e-5)
        elif m_pad > M:
            assert (got[-1] == 0).all()
        else:
            assert np.isnan(got[-1]).all()


def test_flash_long_key_block_regime_matches_jax():
    """M >= 8192: the JAX defaults switch to 1024 x 2048 tiles, so the padded
    tail of M = 8200 reaches 10240 and a fully masked f32 row averages V over
    it; the other row has every key."""
    B, N, M, H = 2, 128, 8200, 1
    q, k, v, _ = _arrays(B, N, M, H, 72, seed=1)
    mask = _mask((M, 0), M)
    want = _jax_flash(q, k, v, mask, False, None, None)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), key_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    np.testing.assert_allclose(got.numpy()[1], np.broadcast_to(
        v[1].sum(axis=0) / 10240, (N, H, 72)), atol=1e-5)
    assert tfa._flash_tail(M, None) == 10240 - M and tfa._flash_tail(300, None) == 84


@pytest.mark.parametrize("N,M,lengths,bf16", [
    (200, 300, None, False),
    (100, 300, (300, 0), False),   # the second row has no valid key
    (200, 300, (300, 17), True),
])
def test_flash_lse_matches_jax_kernel(N, M, lengths, bf16):
    B, H = 2, 2
    q, k, v, _ = _arrays(B, N, M, H, 72, seed=2)
    mask = _mask(lengths, M)
    want = _jax_flash_lse(q, k, v, mask, bf16, 128, 128)
    tdt = _dtypes(bf16)[1]
    out, lse = tfa.flash_reference_with_lse(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), block_k=128)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, N)
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=2e-2 if bf16 else 2e-5)


@pytest.mark.parametrize("B,N,M,H,lengths,bf16", [
    (1, 128, 300, 2, None, False),       # ragged tail over 3 key blocks
    (2, 100, 150, 1, (150, 17), False),  # ragged key mask
    (2, 64, 256, 1, (256, 0), False),    # f32 row with no valid key: P = 1
    (1, 128, 300, 2, None, True),
    (2, 100, 300, 1, (300, 0), True),    # bf16 row with no valid key: no gradient
])
def test_flash_grads_match_jax_vjp(B, N, M, H, lengths, bf16):
    q, k, v, g = _arrays(B, N, M, H, 72, seed=3)
    mask = _mask(lengths, M)
    jdt, tdt = _dtypes(bf16)

    def jax_fn(q, k, v):
        return jfa.flash_attention(q, k, v, key_mask=None if mask is None else jnp.asarray(mask),
                                   block_q=128, block_k=128)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a, jdt) for a in (q, k, v)))
        want = vjp(jnp.asarray(g, jdt))
    args = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*args, key_mask=None if mask is None else torch.from_numpy(mask),
                              block_q=128, block_k=128)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.backward(torch.from_numpy(g).to(tdt))
    for a, w, name in zip(args, want, "qkv"):
        w = np.asarray(w, np.float32)
        got = a.grad.float().numpy()
        assert np.isfinite(got).all(), name
        if bf16:
            scale = max(np.abs(w).max(), 1e-6)
            np.testing.assert_allclose(got / scale, w / scale, atol=2e-2, err_msg=name)
        else:
            np.testing.assert_allclose(got, w, rtol=5e-4, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("B,N,M,H,lengths,bf16,block_q", [
    (2, 512, 300, 2, (300, 17), False, 256),
    (2, 200, 77, 2, (77, 0), False, 128),   # a row with no valid key: sum(V) / 128
    (2, 256, 300, 4, (300, 40), True, 256),
])
def test_headsmajor_matches_jax_kernel(B, N, M, H, lengths, bf16, block_q):
    q, k, v, _ = _arrays(B, N, M, H, 72, seed=4)
    mask = _mask(lengths, M)
    jdt, tdt = _dtypes(bf16)
    with pltpu.force_tpu_interpret_mode():
        want = jfa.crossattn_headsmajor(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                        key_mask=jnp.asarray(mask), block_q=block_q)
    got = tfa.crossattn_headsmajor(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                   torch.from_numpy(mask), block_q=block_q)
    assert got.dtype == tdt and got.shape == (B, N, H, 72)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(BF16 if bf16 else F32))
    if lengths[-1] == 0:
        np.testing.assert_allclose(got[-1].numpy(), np.broadcast_to(
            v[-1].sum(axis=0) / 128, (N, H, 72)), atol=1e-5)


def test_gates_and_refusals():
    for n, m in [(512, 300), (511, 300), (4096, 512), (4096, 513)]:
        assert tfa.headsmajor_supported(n, m, True) == jfa.headsmajor_supported(n, m, True)
    assert not tfa.headsmajor_supported(4096, 300, None)
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays(1, 16, 8, 1, 8, seed=5))
    mask = torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="dense bias"):
        tfa.flash_attention(q, k, v, bias=torch.zeros(1))
    with pytest.raises(ValueError, match="key_mask"):
        tfa.crossattn_headsmajor(q, k, v, None)
    with pytest.raises(ValueError, match="multiple of 128"):
        tfa.crossattn_headsmajor(q, k, v, mask, block_q=100)
    with pytest.raises(RuntimeError, match="forward-only"):
        tfa.crossattn_headsmajor(q.requires_grad_(), k, v, mask)
    meta = torch.zeros((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        tfa.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        tfa.crossattn_headsmajor(meta, meta, meta, torch.ones((1, 4), device="meta"))
