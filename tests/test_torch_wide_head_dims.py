"""The port's attention at head dims above 256, against the JAX package, on
the CPU: Dh = 264 (the narrowest past 256), 288 (XL-2's 1152 with 4 heads),
384 (3 heads) and 576 (2 heads), and 1152 (1 head) on a tiny sequence.

On the card these run the kernels' wide form (csrc/wide_attention.cu,
csrc/wide_backward.cu): the head dim streamed in 64-column atoms, the
outputs in column groups of 128, each group recomputing the logits. On CPU
tensors the wrappers run their plain versions, held here as in
tests/test_torch_head_dims.py: against the JAX Pallas kernels in interpret
mode wherever the JAX kernel takes the head dim (onepass, allheads and
headsmajor need a spare lane below the padding to a multiple of 128: Dh
264, 288, 576; flash takes every head dim without a key mask), else against
the JAX package's XLA route. Then the flash and onepass gradients against
`jax.vjp`, a small PixArt (2 blocks; 2 heads of 288, 1 of 384) forward and
training step against the JAX model, and the decomposition the wide form
relies on: attention over V's column groups, side by side, is the whole
output, and every group's lse is the same.

Tolerances are the other head-dim tests': f32 2e-5, bf16 2e-2, against the
XLA route 1e-4; gradients f32 5e-4, bf16 2e-2 of the largest entry; the
model 1e-4 (forward) and 3e-4 (loss and gradients); the decomposition 1e-6
(each output column is the same sum; only the einsum's blocking can
differ), the lse exactly.
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
from tests import test_torch_head_dims as base
from tests import test_torch_head_dims_grads as grads_base
from tests import test_torch_head_dims_model as model_base


def _forward(kind, Dh, lengths, bf16, B=2, N=128, M=160, H=2):
    """The port's plain `kind` kernel against the JAX kernel in interpret mode
    where it takes Dh (flash unmasked always), else against the XLA route."""
    q, k, v, _ = base._arrays(B, N, M, H, Dh, seed=Dh + len(kind))
    mask = base._mask(lengths, M)
    jdt, tdt = base._dtypes(bf16)
    t = lambda a: torch.from_numpy(a).to(tdt)
    tmask = None if mask is None else torch.from_numpy(mask)
    if kind == "onepass":
        got = tfa.onepass_attention(t(q), t(k), t(v), tmask)
    elif kind == "flash":
        got = tfa.flash_attention(t(q), t(k), t(v), key_mask=tmask, block_q=128, block_k=128)
    elif kind == "allheads":
        got = tfa.crossattn_allheads(*(t(a).flatten(2) for a in (q, k, v)), tmask, H)
        assert got.shape == (B, N, H * Dh)
        got = got.unflatten(-1, (H, Dh))
    else:
        got = tfa.crossattn_headsmajor(t(q), t(k), t(v), tmask, block_q=128)
    assert got.dtype == tdt and got.shape == (B, N, H, Dh)
    takes = (mask is None if kind == "flash" else False) or base._jax_kernel_takes(Dh)
    if takes:
        args = [jnp.asarray(a, jdt) for a in (q, k, v)]
        jmask = None if mask is None else jnp.asarray(mask)
        with pltpu.force_tpu_interpret_mode():
            if kind == "onepass":
                want = jfa.onepass_attention(*args, jmask, block_q=128)
            elif kind == "flash":
                want = jfa.flash_attention(*args, key_mask=jmask, block_q=128, block_k=128)
            elif kind == "allheads":
                want = jfa.crossattn_allheads(*args, key_mask=jmask, block_q=128)
            else:
                want = jfa.crossattn_headsmajor(*args, key_mask=jmask, block_q=128)
        base._close(got, want, base.BF16 if bf16 else base.F32)
    elif not bf16:
        base._close(got, base._xla(q, k, v, mask), base.XLA)
    else:  # the XLA route in bf16 rounds elsewhere: hold the rounded f32 inputs to it
        rounded = (np.asarray(jnp.asarray(a, jdt), np.float32) for a in (q, k, v))
        base._close(got, base._xla(*rounded, mask), base.BF16)


@pytest.mark.parametrize("kind,Dh,lengths,bf16", [
    ("onepass", 264, None, False),
    ("onepass", 288, (160, 17), False),
    ("onepass", 288, None, True),
    ("onepass", 384, (160, 40), False),  # no spare lane: the XLA route
    ("onepass", 576, (160, 40), True),
    ("flash", 264, None, True),
    ("flash", 288, None, False),
    ("flash", 384, None, False),          # the JAX flash kernel takes it unmasked
    ("flash", 384, (160, 17), False),     # masked it needs a spare lane: XLA
    ("flash", 576, None, True),
    ("allheads", 264, (160, 40), True),
    ("allheads", 288, (120, 7), False),
    ("allheads", 384, (160, 40), False),
    ("allheads", 576, (160, 17), True),
    ("headsmajor", 264, (160, 17), False),
    ("headsmajor", 288, (160, 40), True),
    ("headsmajor", 384, (120, 7), False),
    ("headsmajor", 576, (160, 17), False),
])
def test_wide_plain_matches_jax(kind, Dh, lengths, bf16):
    _forward(kind, Dh, lengths, bf16)


@pytest.mark.parametrize("kind,lengths,bf16", [
    ("onepass", (24, 9), False), ("flash", None, True), ("allheads", (24, 9), False),
    ("headsmajor", (24, 3), True),
])
def test_wide_plain_matches_jax_at_1152(kind, lengths, bf16):
    """XL-2's whole width as one head (18 atoms, 9 groups on the card), on a
    tiny sequence."""
    _forward(kind, 1152, lengths, bf16, B=2, N=16, M=24, H=1)


@pytest.mark.parametrize("kind,Dh,lengths,bf16", [
    ("flash", 288, (128, 17), False), ("flash", 384, None, True),
    ("onepass", 288, None, False), ("onepass", 384, None, False),
])
def test_wide_grads_match_jax_vjp(kind, Dh, lengths, bf16):
    """The flash and onepass autograd Functions' backward (the plain dkv and
    dq) against `jax.vjp` of the JAX kernels (Pallas in interpret mode), or
    of the XLA route where the JAX kernel does not take the head dim."""
    B, N, M, H = 2, 128, 128, 1
    q, k, v, g = base._arrays(B, N, M, H, Dh, seed=Dh + 7)
    mask = base._mask(lengths if kind == "flash" else (128, 33), M)
    jdt, tdt = base._dtypes(bf16)
    jmask = None if mask is None else jnp.asarray(mask)
    if kind == "flash" and (mask is None or base._jax_kernel_takes(Dh)):
        fn = lambda q, k, v: jfa.flash_attention(q, k, v, key_mask=jmask, block_q=128,
                                                 block_k=128)
    elif kind == "onepass" and base._jax_kernel_takes(Dh):
        fn = lambda q, k, v: jfa.onepass_attention(q, k, v, jmask, block_q=128)
    else:
        fn = lambda q, k, v: jax_attention(q, k, v, key_mask=jmask, impl="xla",
                                           fp32_softmax=True)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, *(jnp.asarray(a, jdt) for a in (q, k, v)))
        want = vjp(jnp.asarray(g, jdt))
    args = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    if kind == "flash":
        out = tfa.flash_attention(*args, key_mask=tmask, block_q=128, block_k=128)
    else:
        out = tfa.onepass_attention(*args, tmask)
    out.backward(torch.from_numpy(g).to(tdt))
    grads_base._grads_close([a.grad for a in args], want, bf16)


@pytest.mark.parametrize("hidden_size,num_heads", [(576, 2), (384, 1)])
def test_wide_small_pixart_forward_matches_jax(hidden_size, num_heads):
    model_base.check_forward(hidden_size, num_heads)


@pytest.mark.parametrize("hidden_size,num_heads", [(576, 2), (384, 1)])
def test_wide_small_pixart_training_step_matches_jax(hidden_size, num_heads):
    model_base.check_training_step(hidden_size, num_heads)


@pytest.mark.parametrize("Dh,lengths", [(264, None), (288, (90, 20)), (576, (90, 0)),
                                        (1152, None)])
def test_column_groups_rebuild_the_output(Dh, lengths):
    """The wide form's decomposition, on the plain versions: each column
    group of WIDE_GROUP_COLS (the last one cut at Dh) attends with the same
    logits, so the groups' outputs side by side are the whole output and
    their lse are equal bit for bit, for the onepass and the flash
    arithmetic; the head dim needs `wide_groups` of them."""
    B, N, M, H = 2, 40, 90, 1
    q, k, v, _ = (torch.from_numpy(a) for a in base._arrays(B, N, M, H, Dh, seed=Dh + 8))
    madd = None if lengths is None else tfa.mask_bias(torch.from_numpy(base._mask(lengths, M)))
    G = tfa.wide_groups(Dh)
    cols = tfa.WIDE_GROUP_COLS
    assert (G - 1) * cols < Dh <= G * cols
    groups = [v[..., g * cols:(g + 1) * cols] for g in range(G)]
    out, lse = tfa._plain_forward(q, k, v, madd)
    parts = [tfa._plain_forward(q, k, vg, madd) for vg in groups]
    torch.testing.assert_close(torch.cat([o for o, _ in parts], -1), out, atol=1e-6, rtol=1e-6)
    assert all(torch.equal(l, lse) for _, l in parts)
    qs, tail = tfa._flash_scale_q(q), tfa._flash_tail(M, None)
    s = tfa._logits(qs, k, tfa._flash_madd(None if madd is None else madd > -1, q.dtype), 1.0)
    fout, flse = tfa._softmax_pv(s, v, tail, q.dtype)
    fparts = [tfa._softmax_pv(s, vg, tail, q.dtype) for vg in groups]
    torch.testing.assert_close(torch.cat([o for o, _ in fparts], -1), fout, atol=1e-6,
                               rtol=1e-6)
    assert all(torch.equal(l, flse) for _, l in fparts)
