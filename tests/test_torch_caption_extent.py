"""The caption key extent of the allheads and headsmajor kernels, on the CPU.

The kernels load and multiply only the key tiles up to each batch element's
last valid caption key (`caption_key_extent`, computed in the kernel from
the boolean mask row). These tests hold the plain extent function against a
loop over the mask, and show that attention over the extent is attention
over all keys, bit for bit: past the last valid key every row with a valid
key has p = exp2(-1e30 - m) = 0 exactly, so skipping those tiles is exact.
A row with no valid key keeps every key and averages all of V.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import numpy as np
import pytest
import torch

from pixart_sigma_tpu_torch.ops.flash_attention import (
    CROSS_KEY_TILE,
    _logits,
    _plain_forward,
    caption_key_extent,
    mask_bias,
)


def _mask(kind: str, M: int) -> np.ndarray:
    """[4, M] caption masks: prefixes (one of them of the whole caption),
    non-prefix spans, or one batch element with no valid key."""
    keys = np.arange(M)
    spans = {
        "prefix": [(0, M), (0, max(1, M // 3)), (0, min(M, 19)), (0, 1)],
        "non-prefix": [(M // 2, M), (M - 1, M), (0, 0), (M // 4, M // 4 + 3)],
        "zero-valid": [(0, 0), (0, min(M, 40)), (0, min(M, 5)), (0, 0)],
    }[kind]
    mask = np.stack([(keys >= lo) & (keys < hi) for lo, hi in spans])
    if kind == "non-prefix":
        mask[2, ::7] = True  # scattered valid keys, the last at 7 * ((M - 1) // 7)
    return mask


def _extent_by_loop(mask: np.ndarray, tile: int) -> list:
    out = []
    for row in mask:
        valid = [i for i, ok in enumerate(row) if ok]
        keys = valid[-1] + 1 if valid else len(row)
        out.append(-(-keys // tile) * tile)
    return out


@pytest.mark.parametrize("kind", ["prefix", "non-prefix", "zero-valid"])
@pytest.mark.parametrize("M", [1, 77, 300, 512])
@pytest.mark.parametrize("tile", [CROSS_KEY_TILE[128], CROSS_KEY_TILE[256]])
def test_caption_key_extent_is_the_last_valid_key_in_whole_tiles(kind, M, tile):
    mask = _mask(kind, M)
    got = caption_key_extent(torch.from_numpy(mask), tile)
    assert got.dtype == torch.int64 and got.shape == (4,)
    assert got.tolist() == _extent_by_loop(mask, tile)
    # an int mask (as the T5 embedders give it) reads as nonzero = valid
    assert torch.equal(caption_key_extent(torch.from_numpy(mask.astype(np.int32)), tile), got)
    assert bool((got % tile == 0).all()) and bool((got >= 1).all())
    assert bool((got <= -(-M // tile) * tile).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["prefix", "non-prefix", "zero-valid"])
@pytest.mark.parametrize("M,tile", [(77, 64), (300, CROSS_KEY_TILE[128]), (512, CROSS_KEY_TILE[128])])
def test_attention_over_the_extent_is_attention_over_all_keys(dtype, kind, M, tile):
    """Each batch element through the plain kernel arithmetic over its own
    extent (in tiles of `tile` keys), against the same element over all M
    keys: equal bit for bit. Keys past the extent get p = 0 exactly in every
    row with a valid key."""
    rng = np.random.RandomState(M)
    B, N, H, Dh = 4, 37, 2, 72
    t = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32)).to(dtype)
    q, k, v = t(B, N, H, Dh, scale=2.0), t(B, M, H, Dh), t(B, M, H, Dh)
    mask = torch.from_numpy(_mask(kind, M))
    madd = mask_bias(mask)
    extent = caption_key_extent(mask, tile)
    s = _logits(q, k, madd)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    skipped = 0
    for b in range(B):
        e = min(int(extent[b]), M)
        one = slice(b, b + 1)
        want = _plain_forward(q[one], k[one], v[one], madd[one])[0]
        got = _plain_forward(q[one], k[one, :e], v[one, :e], madd[one, :e])[0]
        assert torch.equal(got, want), (b, e)
        if bool(mask[b].any()):
            assert bool((p[b, ..., e:] == 0).all())
        skipped += M - e
    assert skipped > 0  # the case does skip keys
