"""The port's attention functions against the JAX package, on the CPU.

On a CPU tensor the kernel wrappers run their plain PyTorch versions; here
they are held against the JAX Pallas kernels run in interpret mode (as the
JAX package's own kernel tests run them) and against the JAX einsum path.
Rows compared with the JAX einsum path always have at least one valid key:
it masks with -inf and turns a fully masked row into NaN, where the Pallas
kernels give sum(V) / pad128(M), which the port matches.

Tolerances: float32 2e-5, bfloat16 2e-2 (the JAX kernel tests' own).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pixart_sigma_tpu.ops import flash_attention as jfa
from pixart_sigma_tpu.ops.attention import attention as jax_attention
from pixart_sigma_tpu_torch.ops import flash_attention as tfa
from pixart_sigma_tpu_torch.ops.attention import CROSSATTN_ENV, attention, choose_impl

TOL = {np.float32: dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}


def _qkv(B, N, M, H, Dh, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, N, H, Dh).astype(np.float32),
            rng.randn(B, M, H, Dh).astype(np.float32),
            rng.randn(B, M, H, Dh).astype(np.float32))


def _mask(lengths, M):
    return np.arange(M)[None] < np.asarray(lengths)[:, None]


def _pair(a, bf16):
    """The same numbers as a JAX array and a torch tensor."""
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got, want, bf16):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL["bf16" if bf16 else np.float32])


@pytest.mark.parametrize("B,N,M,H,Dh,lengths,bf16", [
    (1, 256, 256, 2, 72, None, False),         # PixArt's head dim
    (2, 256, 128, 2, 72, None, False),         # KV-compressed: M < N
    (1, 384, 300, 2, 72, None, False),         # unaligned key tail
    (2, 200, 300, 2, 72, (300, 17), False),    # padded key mask
    (1, 256, 256, 2, 72, None, True),
    (2, 200, 300, 2, 72, (300, 17), True),
])
def test_onepass_plain_matches_jax_kernel(B, N, M, H, Dh, lengths, bf16):
    q, k, v = _qkv(B, N, M, H, Dh, seed=0)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, bf16) for a in (q, k, v))
    mask = None if lengths is None else _mask(lengths, M)
    with pltpu.force_tpu_interpret_mode():
        want = jfa.onepass_attention(jq, jk, jv, None if mask is None else jnp.asarray(mask),
                                     block_q=128)
    got = tfa.onepass_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask))
    assert got.dtype == tq.dtype and got.shape == (B, N, H, Dh)
    _close(got, want, bf16)


@pytest.mark.parametrize("B,N,M,H,lengths,bf16", [
    (2, 256, 300, 4, (120, 7), False),
    (2, 200, 77, 2, (77, 1), False),
    (2, 256, 300, 4, (300, 40), True),
])
def test_allheads_plain_matches_jax_kernel(B, N, M, H, lengths, bf16):
    Dh = 72
    q, k, v = _qkv(B, N, M, H, Dh, seed=1)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, bf16) for a in (q, k, v))
    mask = _mask(lengths, M)
    with pltpu.force_tpu_interpret_mode():
        want = jfa.crossattn_allheads(jq, jk, jv, key_mask=jnp.asarray(mask), block_q=128)
    flat = lambda t: t.flatten(2)
    got = tfa.crossattn_allheads(flat(tq), flat(tk), flat(tv), torch.from_numpy(mask), H)
    assert got.shape == (B, N, H * Dh)
    _close(got.unflatten(-1, (H, Dh)), want, bf16)


@pytest.mark.parametrize("impl", ["auto", "reference", "onepass", "allheads", "flash",
                                  "headsmajor"])
def test_dispatcher_matches_jax_einsum_path(impl):
    q, k, v = _qkv(2, 64, 40, 2, 72, seed=2)
    mask = _mask((40, 9), 40)
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         key_mask=jnp.asarray(mask), impl="xla", fp32_softmax=True)
    got = attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                    key_mask=torch.from_numpy(mask), impl=impl)
    _close(got, want, bf16=False)


def test_fully_masked_rows_average_the_values():
    """-1e30, not -inf: a row with no valid key is finite and is what the TPU
    kernels give, sum(V[:M]) / pad128(M) (their padded keys share the logit
    -1e30 and carry zero values)."""
    B, N, M, H, Dh = 2, 8, 5, 2, 72
    q, k, v = _qkv(B, N, M, H, Dh, seed=3)
    mask = _mask((5, 0), M)
    with pltpu.force_tpu_interpret_mode():
        want_one = jfa.onepass_attention(*map(jnp.asarray, (q, k, v, mask)), block_q=128)
        want_all = jfa.crossattn_allheads(*map(jnp.asarray, (q, k, v, mask)), block_q=128)
    np.testing.assert_allclose(np.asarray(want_one)[1], np.broadcast_to(
        v[1].sum(axis=0) / 128, (N, H, Dh)), atol=1e-6)
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    _close(tfa.onepass_attention(tq, tk, tv, tm), want_one, bf16=False)
    got = tfa.crossattn_allheads(tq.flatten(2), tk.flatten(2), tv.flatten(2), tm, H)
    _close(got.unflatten(-1, (H, Dh)), want_all, bf16=False)


def test_dispatcher_rejects_unknown_impl_and_shapes():
    q = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(q, q, q, impl="xla")
    with pytest.raises(ValueError):
        tfa.onepass_attention(q, torch.zeros((1, 4, 2, 8)), q)
    with pytest.raises(ValueError, match="key_mask"):
        tfa.crossattn_allheads(q.flatten(2), q.flatten(2), q.flatten(2), None, 1)


def test_gates_match_the_jax_package():
    for n, m, dh in [(4096, 4096, 72), (4096, 4097, 72), (64, 300, 72), (16384, 1024, 128),
                     (4096, 1024, 127)]:
        assert tfa.onepass_supported(n, m, dh) == jfa.onepass_supported(n, m, dh)
    for m in (77, 300, 512, 513):
        assert tfa.allheads_supported(4096, m, True) == jfa.allheads_supported(4096, m, True)
    assert not tfa.allheads_supported(4096, 300, None)


def test_wrappers_take_only_cpu_or_cuda_tensors():
    """No silent fallback: a tensor on another device is refused."""
    q = torch.zeros((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        tfa.onepass_attention(q, q, q)
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        tfa.crossattn_allheads(q.flatten(2), q.flatten(2), q.flatten(2),
                               torch.ones((1, 4), dtype=torch.bool, device="meta"), 1)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from pixart_sigma_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["onepass_attention"])
    assert _build.library_path("onepass_attention").parent == tmp_path
    assert _build.library_path("onepass_attention") != _build.library_path("cross_attention")


def test_cuda_dispatch_picks_by_length(monkeypatch):
    """Where "auto" goes on a CUDA tensor: allheads for captions, onepass up to
    4096 padded keys, flash beyond (the 2K/4K self-attention), masked or not."""
    monkeypatch.delenv(CROSSATTN_ENV, raising=False)
    assert choose_impl(4096, 300, 72, True) == "allheads"
    assert choose_impl(16384, 300, 72, True) == "allheads"
    assert choose_impl(4096, 4096, 72, False) == "onepass"
    assert choose_impl(16384, 4096, 72, False) == "onepass"   # 2K, compressed layers
    assert choose_impl(4096, 1000, 72, True) == "onepass"
    assert choose_impl(16384, 16384, 72, False) == "flash"    # 2K self-attention
    assert choose_impl(65536, 16384, 72, False) == "flash"    # 4K, compressed layers
    assert choose_impl(65536, 65536, 72, False) == "flash"
    assert choose_impl(9000, 5000, 72, True) == "flash"


def test_crossattn_env_override_and_unknown_impls(monkeypatch):
    """PIXART_CROSSATTN_IMPL forces the masked attention within the onepass
    gate, as in the JAX dispatch; self-attention and longer keys ignore it,
    and an unknown name raises instead of falling through."""
    monkeypatch.setenv(CROSSATTN_ENV, "headsmajor")
    assert choose_impl(4096, 300, 72, True) == "headsmajor"
    assert choose_impl(4096, 4096, 72, False) == "onepass"
    assert choose_impl(9000, 5000, 72, True) == "flash"
    monkeypatch.setenv(CROSSATTN_ENV, "onepass")
    assert choose_impl(4096, 300, 72, True) == "onepass"
    monkeypatch.setenv(CROSSATTN_ENV, "headsmjaor")
    with pytest.raises(ValueError, match="unknown attention impl"):
        choose_impl(4096, 300, 72, True)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 512, 300, 2, 72, seed=4))
    mask = torch.from_numpy(_mask((200,), 300))
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(q, k, v, key_mask=mask, impl="headsmjaor")
    want = attention(q, k, v, key_mask=mask, impl="reference")
    np.testing.assert_allclose(attention(q, k, v, key_mask=mask, impl="headsmajor").numpy(),
                               want.numpy(), **TOL[np.float32])


@pytest.mark.parametrize("forced", ["reference", "auto", "xla"])
def test_crossattn_env_must_name_a_kernel(monkeypatch, forced):
    """The override never sends CUDA attention to plain PyTorch or elsewhere."""
    monkeypatch.setenv(CROSSATTN_ENV, forced)
    with pytest.raises(ValueError, match="unknown attention impl"):
        choose_impl(4096, 300, 72, True)


def test_forced_headsmajor_gives_way_to_allheads_for_gradients(monkeypatch):
    """headsmajor is forward-only; as JAX training falls back to allheads, a
    step that needs a gradient takes the differentiable kernels instead."""
    monkeypatch.setenv(CROSSATTN_ENV, "headsmajor")
    assert choose_impl(4096, 300, 72, True, needs_grad=True) == "allheads"
    assert choose_impl(4096, 1000, 72, True, needs_grad=True) == "onepass"
    assert choose_impl(4096, 300, 72, True, needs_grad=False) == "headsmajor"
    monkeypatch.setenv(CROSSATTN_ENV, "onepass")
    assert choose_impl(4096, 300, 72, True, needs_grad=True) == "onepass"
