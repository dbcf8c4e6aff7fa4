"""The caption key extent of the backward kernels (dkv, dq), on the CPU.

With a key mask, `flash_bwd_dq` multiplies only the key tiles up to each
batch element's last valid key (`caption_key_extent` in tiles of
BWD_KEY_TILE at the head dim's width), and a `flash_bwd_dkv` item whose keys all lie past it writes
zeros for dK and dV. These tests show, with the plain version of both
kernels (`flash_backward_reference`), that this is exact: the backward over
the extent equals the backward over all keys bit for bit, and dK and dV are
0 past it, in f32 and bf16, for prefix, non-prefix and zero-valid captions.
A caption with no valid key keeps every tile, so the TPU's gradient for such
a row stays as it is: with the mask rounded to the input dtype (as
`_flash_backward` rounds it), P = 1 in f32 and P = 0 in bf16.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import numpy as np
import pytest
import torch

from pixart_sigma_tpu_torch.ops.flash_attention import (
    BWD_KEY_TILE,
    _flash_backward,
    _logits,
    _plain_forward,
    caption_key_extent,
    flash_backward_reference,
    mask_bias,
)


def _mask(kind: str, M: int) -> np.ndarray:
    """[3, M] caption masks: prefixes, captions valid only on keys
    [256, 300) (or the last 44 keys when M < 300) and on one key, or one
    batch element with no valid key."""
    keys = np.arange(M)
    lo = 256 if M >= 300 else M - 44
    spans = {
        "prefix": [(0, M), (0, min(M, 19)), (0, 3)],
        "non-prefix": [(lo, min(M, 300)), (M // 3, M // 3 + 1), (0, 40)],
        "zero-valid": [(0, 0), (0, min(M, 40)), (0, 5)],
    }[kind]
    return np.stack([(keys >= a) & (keys < b) for a, b in spans])


def _case(kind, M, dtype, seed):
    """Inputs of one backward launch as the autograd Functions give them: the
    forward's lse and delta from the plain forward, the mask bias rounded to
    the input dtype (`_flash_backward`)."""
    rng = np.random.RandomState(seed)
    B, N, H, Dh = 3, 45, 2, 72
    t = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32)).to(dtype)
    q, k, v, do = t(B, N, H, Dh, scale=2.0), t(B, M, H, Dh), t(B, M, H, Dh), t(B, N, H, Dh)
    mask = torch.from_numpy(_mask(kind, M))
    madd = mask_bias(mask)
    out, lse = _plain_forward(q, k, v, madd)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, mask, madd.to(dtype).float(), lse, delta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["prefix", "non-prefix", "zero-valid"])
@pytest.mark.parametrize("M", [77, 300, 512])
def test_backward_over_the_extent_is_the_backward_over_all_keys(dtype, kind, M,
                                                                 tile=BWD_KEY_TILE[128]):
    """Each batch element's (dq, dk, dv) over the keys of its extent (in
    tiles of `tile` keys), against the same element over all M keys: equal
    bit for bit, and dK, dV exactly 0 past the extent for a caption with a
    valid key."""
    q, k, v, do, mask, madd, lse, delta = _case(kind, M, dtype, seed=M)
    extent = caption_key_extent(mask, tile)
    skipped = 0
    for b in range(q.shape[0]):
        e = min(int(extent[b]), M)
        one = slice(b, b + 1)
        dq, dk, dv = flash_backward_reference(q[one], k[one], v[one], madd[one], lse[one],
                                              delta[one], do[one])
        got = flash_backward_reference(q[one], k[one, :e], v[one, :e], madd[one, :e], lse[one],
                                       delta[one], do[one])
        assert torch.equal(got[0], dq), b
        assert torch.equal(got[1], dk[:, :e]) and torch.equal(got[2], dv[:, :e]), b
        if bool(mask[b].any()):
            assert bool((dk[:, e:] == 0).all()) and bool((dv[:, e:] == 0).all()), b
        else:
            assert e == M  # no valid key: every tile is kept
        skipped += M - e
    assert skipped > 0 or M <= tile  # one tile holds every key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["prefix", "non-prefix", "zero-valid"])
@pytest.mark.parametrize("M", [77, 300])
def test_backward_over_the_extent_at_width_256(dtype, kind, M):
    """The same in width 256's 64-key tiles and dK/dV items."""
    test_backward_over_the_extent_is_the_backward_over_all_keys(dtype, kind, M,
                                                                 BWD_KEY_TILE[256])


@pytest.mark.parametrize("dtype,p_masked", [(torch.float32, 1.0), (torch.bfloat16, 0.0)])
def test_a_caption_with_no_valid_key_keeps_the_tpu_gradient(dtype, p_masked):
    """The TPU backward carries the mask in K's dtype: for a row whose keys
    are all masked, P = exp2(s + madd - lse) is 1 in f32 (madd = -1e30 and
    lse = -1e30 + log2(pad128(M)) round to the same value) and 0 in bf16
    (bf16(-1e30) < -1e30). The port's backward gives the same, so dV of such
    a caption is the column sum of dO in f32 and 0 in bf16."""
    q, k, v, do, mask, madd, lse, delta = _case("zero-valid", 300, dtype, seed=3)
    p = torch.exp2(_logits(q, k, madd) - lse[..., None])
    assert bool((p[0] == p_masked).all())
    out, _ = _plain_forward(q, k, v, mask_bias(mask))
    _, dk, dv = _flash_backward(q, k, v, mask_bias(mask), out, lse, do)
    want = p_masked * do[0].float().sum(0)  # [H, Dh], every key alike
    assert torch.allclose(dv[0].float(), want.expand_as(dv[0]).to(dtype).float(), rtol=2e-2,
                          atol=1e-6)
    if p_masked == 0.0:
        assert bool((dk[0] == 0).all()) and bool((dv[0] == 0).all())
