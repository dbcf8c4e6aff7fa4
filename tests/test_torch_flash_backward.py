"""Gradients of the port's attention kernels against the JAX Pallas VJPs.

On CPU tensors `onepass_attention` and `crossattn_allheads` run their plain
versions through the same autograd Functions that launch the CUDA kernels on
the card: the forward gives the row logsumexp (`onepass_reference_with_lse`)
and the backward recomputes P from it (`flash_backward_reference`). Here
they are held against `jax.grad` of the Pallas kernels run in interpret
mode, whose VJPs route through `_bwd_dkv_kernel` and `_bwd_dq_kernel`.

Tolerances: float32 5e-4 (the JAX package's own gradient tests; both sides
multiply in f32, the sums run in other orders); bfloat16 2e-2 relative to
the gradient's largest entry, where the readings reach 7e-3 (the TPU path
scales q in bf16 before the logits and rounds P and dS at its own places).
lse: float32 2e-5 and bfloat16 2e-2 absolute, in log2 units.

A row with no valid key is covered in both dtypes: the TPU backward carries
the mask in K's dtype, so its P there is 1 in f32 and 0 in bf16, and the
port's backward does the same.
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

F32_TOL = 5e-4
BF16_TOL = 2e-2


def _arrays(B, N, M, H, Dh, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((B, N, H, Dh), (B, M, H, Dh), (B, M, H, Dh), (B, N, H, Dh))]


def _mask(lengths, M):
    return np.arange(M)[None] < np.asarray(lengths)[:, None]


def _jax_grads(fn, q, k, v, g, bf16):
    dt = jnp.bfloat16 if bf16 else jnp.float32
    args = [jnp.asarray(a, dt) for a in (q, k, v)]
    tangent = jnp.asarray(g, dt)

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * tangent.astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        return jax.grad(loss, argnums=(0, 1, 2))(*args)


def _torch_grads(fn, q, k, v, g, bf16):
    dt = torch.bfloat16 if bf16 else torch.float32
    args = [torch.from_numpy(a).to(dt).requires_grad_() for a in (q, k, v)]
    out = fn(*args)
    out.backward(torch.from_numpy(g).to(dt))
    return [a.grad for a in args]


def _assert_grads_close(got, want, bf16):
    for g, w, name in zip(got, want, "qkv"):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        assert np.isfinite(g).all(), name
        if bf16:
            scale = max(np.abs(w).max(), 1e-6)
            np.testing.assert_allclose(g / scale, w / scale, atol=BF16_TOL, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL, err_msg=name)


@pytest.mark.parametrize("B,N,M,lengths,bf16", [
    (1, 128, 128, None, False),           # self-attention, aligned
    (1, 100, 64, None, False),            # unaligned N, KV-compressed M < N
    (2, 100, 150, (150, 17), False),      # ragged key mask
    (3, 64, 40, (40, 9, 0), False),       # one row with no valid key
    (1, 128, 128, None, True),
    (3, 64, 40, (40, 9, 0), True),
])
def test_onepass_grads_match_pallas_vjp(B, N, M, lengths, bf16):
    H, Dh = 1, 72
    q, k, v, g = _arrays(B, N, M, H, Dh, seed=0)
    mask = None if lengths is None else _mask(lengths, M)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    want = _jax_grads(lambda q, k, v: jfa.onepass_attention(q, k, v, jmask, block_q=128),
                      q, k, v, g, bf16)
    got = _torch_grads(lambda q, k, v: tfa.onepass_attention(q, k, v, tmask), q, k, v, g, bf16)
    _assert_grads_close(got, want, bf16)


@pytest.mark.parametrize("B,N,M,H,lengths,bf16", [
    (2, 128, 150, 2, (120, 7), False),
    (3, 64, 40, 2, (40, 1, 0), False),    # one row with no valid key
    (2, 128, 150, 2, (150, 40), True),
    (3, 64, 40, 2, (40, 1, 0), True),
])
def test_allheads_grads_match_pallas_vjp(B, N, M, H, lengths, bf16):
    Dh = 72
    q, k, v, g = _arrays(B, N, M, H, Dh, seed=1)
    mask = _mask(lengths, M)
    flat = lambda t: t.flatten(2)
    want = _jax_grads(
        lambda q, k, v: jfa.crossattn_allheads(q, k, v, jnp.asarray(mask), block_q=128),
        q, k, v, g, bf16)
    got = _torch_grads(
        lambda q, k, v: tfa.crossattn_allheads(
            flat(q), flat(k), flat(v), torch.from_numpy(mask), H).unflatten(-1, (H, Dh)),
        q, k, v, g, bf16)
    _assert_grads_close(got, want, bf16)


def _jax_onepass_lse(q, k, v, mask):
    """The forward lse of `_onepass_core_fwd`, prepared as `onepass_attention`
    prepares its inputs: [B, H, N] f32, log2 units."""
    B, N, H, Dh = q.shape
    M = k.shape[1]
    m_pad, n_pad = -(-M // 128) * 128, -(-N // 128) * 128
    q = q * jnp.asarray(Dh**-0.5 * jfa._LOG2E, q.dtype)

    def to_bh(x, seq_pad, d_target):
        x = x.transpose(0, 2, 1, 3).reshape(B * H, x.shape[1], Dh)
        x = jnp.pad(x, ((0, 0), (0, seq_pad - x.shape[1]), (0, 0)))
        return jfa._pad_heads(x, d_target)

    vb = to_bh(v, m_pad, 127)
    vb = jnp.concatenate([vb, jnp.ones((*vb.shape[:2], 1), vb.dtype)], axis=-1)
    madd, kv_len = None, M
    if mask is not None:
        madd = jnp.where(mask, 0.0, jfa._NEG_INF).astype(jnp.float32)
        madd = jnp.pad(madd, ((0, 0), (0, m_pad - M)), constant_values=jfa._NEG_INF)
        madd = jnp.broadcast_to(madd[:, None, :], (B, 8, m_pad))
        kv_len = m_pad
    with pltpu.force_tpu_interpret_mode():
        _, lse = jfa._onepass_fwd(to_bh(q, n_pad, 128), to_bh(k, m_pad, 128), vb, madd,
                                  128, kv_len, H, with_lse=True)
    return np.asarray(lse[:, :N, 0]).reshape(B, H, N)


@pytest.mark.parametrize("N,M,lengths,bf16", [
    (128, 128, None, False),
    (100, 150, (150, 0), False),  # the second row has no valid key
    (100, 150, (150, 17), True),
])
def test_forward_lse_matches_pallas(N, M, lengths, bf16):
    B, H, Dh = 2, 1, 72
    q, k, v, _ = _arrays(B, N, M, H, Dh, seed=2)
    mask = None if lengths is None else _mask(lengths, M)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    want = _jax_onepass_lse(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                            None if mask is None else jnp.asarray(mask))
    out, lse = tfa.onepass_reference_with_lse(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask))
    assert lse.dtype == torch.float32 and lse.shape == (B, H, N)
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=2e-2 if bf16 else 2e-5)


def test_gradients_flow_only_when_asked():
    """No grad needed: the wrapper takes the inference launch (no lse)."""
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays(1, 64, 64, 1, 8, seed=3))
    out = tfa.onepass_attention(q, k, v)
    assert out.grad_fn is None
    out = tfa.onepass_attention(q.requires_grad_(), k, v)
    assert type(out.grad_fn).__name__ == "_OnepassAttentionBackward"
    with torch.no_grad():
        assert tfa.onepass_attention(q, k, v).grad_fn is None


def test_backward_wrappers_refuse_other_devices():
    x = torch.zeros((1, 4, 1, 8), device="meta")
    lse = torch.zeros((1, 1, 4), device="meta")
    for fn in (tfa.flash_bwd_dkv, tfa.flash_bwd_dq):
        with pytest.raises(ValueError, match="expected cpu or cuda"):
            fn(x, x, x, x, None, lse, lse)
