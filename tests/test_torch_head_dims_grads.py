"""Gradients of the port's attention at head dims other than 72 (Dh = 18,
36, 96, 120, 128 and width 256's 192), against the JAX package on the CPU:
the plain versions of the backward kernels (dkv, dq), through the flash and
onepass autograd Functions, against `jax.vjp` of the JAX `flash_attention`
and `onepass_attention` (their Pallas backward kernels in interpret mode),
or of the XLA route where the JAX kernel does not take the head dim with a
key mask (Dh = 128).

Tolerances: f32 5e-4, bf16 2e-2 relative to the gradient's largest entry
(tests/test_torch_flash_backward.py's).
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pixart_sigma_tpu.ops import flash_attention as jfa
from pixart_sigma_tpu.ops.attention import attention as jax_attention
from pixart_sigma_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_head_dims import HEAD_DIMS, _arrays, _dtypes, _jax_kernel_takes, _mask


# ---------------------------------------------------------------- gradients


def _grads_close(got, want, bf16):
    for g, w, name in zip(got, want, "qkv"):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        assert np.isfinite(g).all(), name
        if bf16:
            scale = max(np.abs(w).max(), 1e-6)
            np.testing.assert_allclose(g / scale, w / scale, atol=2e-2, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("Dh,lengths,bf16", [
    *((dh, (300, 17), False) for dh in HEAD_DIMS + (192,)),
    (18, None, False), (128, None, False),
    (36, None, True), (128, None, True), (192, None, True),
])
def test_flash_grads_match_jax_vjp(Dh, lengths, bf16):
    """The port's flash backward (the plain version of dkv and dq) against
    `jax.vjp` of the JAX `flash_attention` (its Pallas backward kernels), or
    of the XLA route where the JAX kernel takes no key mask (Dh = 128)."""
    B, N, M, H = 2, 128, 300, 1
    q, k, v, g = _arrays(B, N, M, H, Dh, seed=Dh + 4)
    mask = _mask(lengths, M)
    jdt, tdt = _dtypes(bf16)
    if mask is None or _jax_kernel_takes(Dh):
        fn = lambda q, k, v: jfa.flash_attention(
            q, k, v, key_mask=None if mask is None else jnp.asarray(mask),
            block_q=128, block_k=128)
    else:
        fn = lambda q, k, v: jax_attention(q, k, v, key_mask=jnp.asarray(mask), impl="xla",
                                           fp32_softmax=True)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, *(jnp.asarray(a, jdt) for a in (q, k, v)))
        want = vjp(jnp.asarray(g, jdt))
    args = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*args, key_mask=None if mask is None else torch.from_numpy(mask),
                              block_q=128, block_k=128)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.backward(torch.from_numpy(g).to(tdt))
    _grads_close([a.grad for a in args], want, bf16)


@pytest.mark.parametrize("Dh", HEAD_DIMS + (192,))
def test_onepass_grads_match_jax_vjp(Dh):
    """The onepass Function's backward (the plain dkv and dq) against
    `jax.vjp` of the JAX onepass kernel, or of the XLA route at Dh = 128."""
    B, N, M, H = 2, 128, 200, 1
    q, k, v, g = _arrays(B, N, M, H, Dh, seed=Dh + 5)
    mask = _mask((200, 33), M)
    if _jax_kernel_takes(Dh):
        fn = lambda q, k, v: jfa.onepass_attention(q, k, v, jnp.asarray(mask), block_q=128)
    else:
        fn = lambda q, k, v: jax_attention(q, k, v, key_mask=jnp.asarray(mask), impl="xla",
                                           fp32_softmax=True)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
        want = vjp(jnp.asarray(g))
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tfa.onepass_attention(*args, torch.from_numpy(mask)).backward(torch.from_numpy(g))
    _grads_close([a.grad for a in args], want, bf16=False)
