"""The port's attention at head dims other than PixArt's 72, against the JAX
package, on the CPU: Dh = 18 and 36 (not multiples of 8; 32 heads at XL-2's
width of 1152 give 36), 96 and 120 (width 128 of the CUDA kernels) and 128
(9 heads at 1152).

On CPU tensors the kernel wrappers run their plain versions. They are held
against the JAX Pallas kernels in interpret mode wherever the JAX kernel
takes the head dim, and against the JAX package's XLA route where it does
not: onepass, allheads and headsmajor need Dh < 128 there (a spare lane of
the 128-lane padding), and flash takes Dh = 128 only without a key mask.
Then the wrapper's pad-to-8 helper, which the CUDA path runs for a head dim
off a multiple of 8, against the unpadded plain version. The gradients are
in tests/test_torch_head_dims_grads.py and a small PixArt at Dh = 128 and 36
in tests/test_torch_head_dims_model.py.

Tolerances are those of the 72-wide tests: f32 2e-5, bf16 2e-2 (the JAX
kernel tests' own); against the XLA route f32 1e-4 (another summation
order and natural-log softmax); the pad helper 1e-6 (zero columns add exact
zeros; only the einsum's order can differ).
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pixart_sigma_tpu.ops import flash_attention as jfa
from pixart_sigma_tpu.ops.attention import attention as jax_attention
from pixart_sigma_tpu_torch.ops import flash_attention as tfa

F32, BF16, XLA = dict(atol=2e-5, rtol=2e-5), dict(atol=2e-2, rtol=2e-2), dict(atol=1e-4,
                                                                               rtol=1e-4)
HEAD_DIMS = (18, 36, 96, 120, 128)


def _arrays(B, N, M, H, Dh, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((B, N, H, Dh), (B, M, H, Dh), (B, M, H, Dh), (B, N, H, Dh))]


def _mask(lengths, M):
    return None if lengths is None else np.arange(M)[None] < np.asarray(lengths)[:, None]


def _dtypes(bf16):
    return (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def _jax_kernel_takes(dh: int) -> bool:
    """The JAX onepass/allheads/headsmajor gate: a spare padded lane."""
    return dh < max(128, -(-dh // 128) * 128)


def _xla(q, k, v, mask):
    """The JAX package's XLA route, f32 softmax."""
    return jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         key_mask=None if mask is None else jnp.asarray(mask), impl="xla",
                         fp32_softmax=True)


# ---------------------------------------------------------------- forwards


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("lengths,bf16", [(None, False), ((300, 17), False), ((300, 40), True)])
def test_onepass_plain_matches_jax(Dh, lengths, bf16):
    B, N, M, H = 2, 200, 300, 2
    q, k, v, _ = _arrays(B, N, M, H, Dh, seed=Dh)
    mask = _mask(lengths, M)
    jdt, tdt = _dtypes(bf16)
    got = tfa.onepass_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                None if mask is None else torch.from_numpy(mask))
    assert got.dtype == tdt and got.shape == (B, N, H, Dh)
    if _jax_kernel_takes(Dh):
        with pltpu.force_tpu_interpret_mode():
            want = jfa.onepass_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                         None if mask is None else jnp.asarray(mask),
                                         block_q=128)
        _close(got, want, BF16 if bf16 else F32)
    elif not bf16:
        _close(got, _xla(q, k, v, mask), XLA)
    else:  # the XLA route in bf16 rounds elsewhere: hold the f32 plain to it instead
        _close(got, _xla(*(np.asarray(jnp.asarray(a, jdt), np.float32) for a in (q, k, v)),
                         mask), BF16)


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("lengths,bf16", [((120, 7), False), ((300, 40), True)])
def test_allheads_plain_matches_jax(Dh, lengths, bf16):
    B, N, M, H = 2, 256, 300, 2
    q, k, v, _ = _arrays(B, N, M, H, Dh, seed=Dh + 1)
    mask = _mask(lengths, M)
    jdt, tdt = _dtypes(bf16)
    flat = lambda a: torch.from_numpy(a).to(tdt).flatten(2)
    got = tfa.crossattn_allheads(flat(q), flat(k), flat(v), torch.from_numpy(mask), H)
    assert got.shape == (B, N, H * Dh)
    got = got.unflatten(-1, (H, Dh))
    if _jax_kernel_takes(Dh):
        with pltpu.force_tpu_interpret_mode():
            want = jfa.crossattn_allheads(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                          key_mask=jnp.asarray(mask), block_q=128)
        _close(got, want, BF16 if bf16 else F32)
    else:
        rounded = (np.asarray(jnp.asarray(a, jdt), np.float32) for a in (q, k, v))
        _close(got, _xla(*rounded, mask), BF16 if bf16 else XLA)


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("lengths,bf16", [((300, 17), False), ((300, 40), True)])
def test_headsmajor_plain_matches_jax(Dh, lengths, bf16):
    B, N, M, H = 2, 512, 300, 2
    q, k, v, _ = _arrays(B, N, M, H, Dh, seed=Dh + 2)
    mask = _mask(lengths, M)
    jdt, tdt = _dtypes(bf16)
    got = tfa.crossattn_headsmajor(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                   torch.from_numpy(mask), block_q=256)
    assert got.dtype == tdt and got.shape == (B, N, H, Dh)
    if _jax_kernel_takes(Dh):
        with pltpu.force_tpu_interpret_mode():
            want = jfa.crossattn_headsmajor(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                            key_mask=jnp.asarray(mask), block_q=256)
        _close(got, want, BF16 if bf16 else F32)
    else:
        rounded = (np.asarray(jnp.asarray(a, jdt), np.float32) for a in (q, k, v))
        _close(got, _xla(*rounded, mask), BF16 if bf16 else XLA)


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("lengths,bf16", [(None, False), ((300, 17), False), (None, True)])
def test_flash_plain_matches_jax_kernel(Dh, lengths, bf16):
    """The JAX flash kernel takes Dh = 128 unmasked; masked it needs a spare
    lane, so there the XLA route holds the port."""
    B, N, M, H = 2, 128, 300, 2
    q, k, v, _ = _arrays(B, N, M, H, Dh, seed=Dh + 3)
    mask = _mask(lengths, M)
    jdt, tdt = _dtypes(bf16)
    got = tfa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                              key_mask=None if mask is None else torch.from_numpy(mask),
                              block_q=128, block_k=128)
    assert got.dtype == tdt and got.shape == (B, N, H, Dh)
    if mask is None or _jax_kernel_takes(Dh):
        with pltpu.force_tpu_interpret_mode():
            want = jfa.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                       key_mask=None if mask is None else jnp.asarray(mask),
                                       block_q=128, block_k=128)
        _close(got, want, BF16 if bf16 else F32)
    else:
        _close(got, _xla(q, k, v, mask), XLA)


# ---------------------------------------------------------------- the pad-to-8 helper


@pytest.mark.parametrize("Dh", [1, 18, 36, 99, 127])
def test_pad_head_dim_keeps_the_forward_and_gradients(Dh):
    """The CUDA path's padding: q, k, v and dO zero-padded to a multiple of
    8 with the true head dim's scale give the unpadded plain version's
    output, lse and gradients, and zero padded columns."""
    B, N, M, H = 2, 64, 90, 2
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(B, N, M, H, Dh, seed=Dh + 6))
    madd = tfa.mask_bias(torch.from_numpy(_mask((90, 20), M)))
    pq, pk, pv, pdo = (tfa.pad_head_dim(x) for x in (q, k, v, do))
    assert pq.shape[-1] == Dh + (-Dh % 8) and pq.shape[-1] % 8 == 0
    assert torch.equal(pq[..., :Dh], q) and not pq[..., Dh:].any()
    scale = Dh**-0.5 * tfa.LOG2E
    # the padded q scaled so that the padded head dim's scale is the true one's
    out_p, lse_p = tfa._plain_forward(pq * (pq.shape[-1] / Dh) ** 0.5, pk, pv, madd)
    out, lse = tfa._plain_forward(q, k, v, madd)
    torch.testing.assert_close(out_p[..., :Dh], out, atol=1e-6, rtol=1e-6)
    assert not out_p[..., Dh:].any()
    torch.testing.assert_close(lse_p, lse, atol=1e-6, rtol=1e-6)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    got = tfa.flash_backward_reference(pq, pk, pv, madd, lse, delta, pdo, scale=scale,
                                       ds_scale=Dh**-0.5)
    want = tfa.flash_backward_reference(q, k, v, madd, lse, delta, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g[..., :Dh], w, atol=1e-6, rtol=1e-6)
        assert not g[..., Dh:].any()
    assert tfa.pad_head_dim(pq) is pq


@pytest.mark.parametrize("Dh,width", [(1, 64), (36, 64), (64, 64), (72, 80), (80, 80),
                                      (88, 128), (128, 128)])
def test_head_dims_run_at_their_width(Dh, width):
    assert tfa.head_dim_width(Dh + (-Dh % 8)) == width


def test_head_dims_past_128_are_refused():
    with pytest.raises(ValueError, match="128"):
        tfa._check_head_dim("onepass_attention", 129)
    for dh in (1, 36, 128):
        tfa._check_head_dim("onepass_attention", dh)
