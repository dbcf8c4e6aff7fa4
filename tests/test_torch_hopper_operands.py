"""The host-side preparation of the Hopper kernels' operands
(`onepass_attention`, `flash_attention`, through `_cross_operands` and
`_key_bytes` `crossattn_allheads` and `crossattn_headsmajor`, and through
`_backward_operands` the backward pair `flash_bwd_dkv` and `flash_bwd_dq`):
what `_tma_operand` reads in place, what it copies, the key mask the cross
kernels read, how a launch error is reported, and the check of a library's
key tiling against the wrapper's. Runs on the CPU."""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import types

import numpy as np
import pytest
import torch

from pixart_sigma_tpu_torch.ops.flash_attention import (
    BWD_KEY_STAGES,
    BWD_KEY_TILE,
    CROSS_KEY_STAGES,
    CROSS_KEY_TILE,
    FORWARD_WIDTHS,
    KEY_STAGES,
    KEY_TILE,
    MASK_PAD,
    TMA_ENCODE_ERROR,
    WIDTHS,
    _backward_operands,
    _check_key_geometry,
    _cross_operands,
    _hopper_error,
    _key_bytes,
    _tile_bias,
    _tma_operand,
    mask_bias,
)


def _rand(*shape, dtype=torch.bfloat16):
    return torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(np.float32)).to(dtype)


def _shift(stages: dict, d: int, widths=WIDTHS) -> dict:
    """Per-width stages with `d` added at `widths`."""
    return {w: s + d if w in widths else s for w, s in stages.items()}


def _tiles(tile) -> dict:
    """Per-width keys per tile: a dict as it is; an int n as the kernels
    scale it, n up to width 128 and n / 2 at 192 (the forwards') and 256."""
    if isinstance(tile, dict):
        return tile
    return {w: tile // 2 if w >= 192 else tile for w in FORWARD_WIDTHS}


def _geometry_lib(name: str, tile, stages: dict):
    """A stand-in library reporting, per width, `_tiles(tile)` and `stages`."""
    return types.SimpleNamespace(**{f"{name}_key_tile": lambda width: _tiles(tile)[width],
                                    f"{name}_key_stages": lambda width: stages[width]})


def _tma_readable(x: torch.Tensor) -> bool:
    return (x.dtype == torch.bfloat16 and x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(0 < s * 2 < 2**40 and s * 2 % 16 == 0 for s in x.stride()[:-1]))


@pytest.mark.parametrize("heads,dh", [(16, 72), (2, 64), (3, 80), (1, 8), (12, 96), (9, 128),
                                      (8, 144), (6, 192), (5, 200), (4, 256)])
def test_qkv_column_slices_are_read_in_place(heads, dh):
    """q, k and v sliced from one qkv projection output are no copies: their
    row stride is 3 H dh and head stride dh elements, multiples of 16 bytes."""
    qkv = _rand(2, 37, 3 * heads * dh)
    for x in (t.unflatten(-1, (heads, dh)) for t in qkv.chunk(3, dim=-1)):
        y = _tma_operand(x)
        assert y.data_ptr() == x.data_ptr() and y.stride() == x.stride()


def test_f32_is_rounded_to_bf16():
    x = _rand(2, 33, 3, 72, dtype=torch.float32)
    y = _tma_operand(x)
    assert y.dtype == torch.bfloat16 and _tma_readable(y)
    assert torch.equal(y, x.to(torch.bfloat16))


@pytest.mark.parametrize("make", [
    lambda x: x[:, :, :, 8:],                        # offset 16 B: aligned, kept
    lambda x: x.flatten(2)[:, :, 1:1 + 3 * 64].unflatten(-1, (3, 64)),  # 2-byte offset
    lambda x: x[:, :, :2, :],                        # two of three heads: kept
    lambda x: x[:1].expand(2, 33, 3, 72),            # batch stride 0: copied
    lambda x: torch.cat([x, x[..., :4]], -1)[..., :72],  # head stride 76 elements (152 B)
    lambda x: torch.cat([x, x], -1)[..., ::2],       # no unit stride on the head dim
])
def test_unreadable_views_are_copied(make):
    x = make(_rand(2, 33, 3, 72))
    y = _tma_operand(x)
    assert torch.equal(y, x) and _tma_readable(y)
    if _tma_readable(x):
        assert y.data_ptr() == x.data_ptr()
    else:
        assert y.is_contiguous()


@pytest.mark.parametrize("M", [1, 127, 128, 129, 300, 1020])
def test_mask_bias_is_padded_to_whole_key_tiles(M):
    """Rows padded to MASK_PAD keys, whole tiles at every width, so each
    tile's biases are one copy of 512 (widths 192 and 256: 256) bytes; keys past M
    read -inf, which drops them from every row as the kernels' bounds test
    did."""
    assert all(MASK_PAD % tile == 0 for tile in KEY_TILE.values())
    assert sorted(KEY_TILE) == sorted(KEY_STAGES) == list(FORWARD_WIDTHS)
    lengths = torch.tensor([M, M // 2, 0])
    madd = mask_bias(torch.arange(M)[None] < lengths[:, None])
    got = _tile_bias(madd, 3, M, "test")
    pad = -(-M // MASK_PAD) * MASK_PAD
    assert got.shape == (3, pad) and got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got[:, :M], madd)
    assert bool((got[:, M:] == float("-inf")).all())
    assert got.data_ptr() % 16 == 0 and got.stride(0) * 4 % 512 == 0
    assert _tile_bias(None, 3, M, "test") is None
    with pytest.raises(ValueError):
        _tile_bias(madd[:, :-1] if M > 1 else madd[:2], 3, M, "test")


def test_launch_errors_name_their_cause():
    assert _hopper_error(1) == "CUDA error 1"
    assert "tensor map" in _hopper_error(TMA_ENCODE_ERROR + 1)
    assert _hopper_error(TMA_ENCODE_ERROR + 500).endswith("CUresult 500")


@pytest.mark.parametrize("name", ["onepass_attention", "flash_forward"])
@pytest.mark.parametrize("tile,stages,ok", [
    (KEY_TILE[128], KEY_STAGES, True),
    (KEY_TILE[128] // 2, KEY_STAGES, False),  # the planted faults would use the wrong tile
    (KEY_TILE[128], _shift(KEY_STAGES, 1), False),
    (KEY_TILE[128], _shift(KEY_STAGES, -1, (128,)), False),  # one width's ring of another depth
    ({**KEY_TILE, 256: 128}, KEY_STAGES, False),  # width 256 at the narrow widths' tile
    (KEY_TILE[128], _shift(KEY_STAGES, 1, (256,)), False),  # three 64 KB stages do not fit
    ({**KEY_TILE, 256: 256}, KEY_STAGES, False),  # a tile MASK_PAD is no multiple of
    ({**KEY_TILE, 192: 128}, KEY_STAGES, False),  # width 192 at the narrow widths' tile
    ({**KEY_TILE, 192: 96}, KEY_STAGES, False),  # a tile MASK_PAD is no multiple of
    (KEY_TILE[128], _shift(KEY_STAGES, 1, (192,)), False),  # four 48 KB stages do not fit
    (KEY_TILE[128], _shift(KEY_STAGES, -1, (192,)), False),  # width 192's ring alone
])
def test_library_key_geometry_is_checked(name, tile, stages, ok):
    lib = _geometry_lib(name, tile, stages)
    if ok:
        assert _check_key_geometry(lib, name) is lib
    else:
        with pytest.raises(RuntimeError, match=name):
            _check_key_geometry(lib, name)


@pytest.mark.parametrize("name,tile,stages", [
    ("cross_attention", CROSS_KEY_TILE, CROSS_KEY_STAGES),
    ("flash_backward", BWD_KEY_TILE, BWD_KEY_STAGES),
])
def test_cross_and_backward_libraries_are_not_asked_for_width_192(name, tile, stages):
    """Width 192 is the forwards' alone: the cross and backward libraries,
    which run head dims 129-256 at width 256, are checked at WIDTHS, and
    the forwards at FORWARD_WIDTHS."""
    assert 192 not in tile and 192 not in stages and 192 in KEY_TILE

    def at(table):
        def query(width):
            if width == 192:
                raise AssertionError(f"{name} asked for width 192")
            return table[width]
        return query

    lib = types.SimpleNamespace(**{f"{name}_key_tile": at(tile), f"{name}_key_stages": at(stages)})
    assert _check_key_geometry(lib, name, tile, stages) is lib
    forward = _geometry_lib("onepass_attention", KEY_TILE[128], KEY_STAGES)
    asked = []
    forward.onepass_attention_key_tile = lambda width: asked.append(width) or KEY_TILE[width]
    assert _check_key_geometry(forward, "onepass_attention") is forward
    assert asked == list(FORWARD_WIDTHS)


@pytest.mark.parametrize("heads,dh", [(16, 72), (2, 64), (3, 80), (1, 8), (12, 96), (9, 128),
                                      (8, 144), (6, 192), (5, 200), (4, 256)])
def test_cross_operands_read_flat_q_and_hoisted_kv_in_place(heads, dh):
    """The allheads kernel's operands: the flat [B, N, C] q and the column
    slices of the hoisted [B, M, 2C] caption K/V (rows 4 C bytes apart) are
    split into [B, rows, H, dh] views, never copied."""
    C = heads * dh
    q, kv = _rand(2, 37, C), _rand(2, 300, 2 * C)
    flat = (q, kv[..., :C], kv[..., C:])
    for got, x in zip(_cross_operands(*flat, n_heads=heads), flat):
        view = x.unflatten(-1, (heads, dh))
        assert got.data_ptr() == x.data_ptr() and got.stride() == view.stride()
        assert got.shape == view.shape and _tma_readable(got)


@pytest.mark.parametrize("heads,dh", [(32, 36), (4, 18), (3, 1), (4, 250), (2, 129)])
def test_cross_operands_pad_a_head_dim_off_8(heads, dh):
    """A head dim that is not a multiple of 8: every operand, the flat q and
    the caption K/V column slices too, becomes a heads-major copy zero-padded
    to the next multiple of 8, which TMA can read."""
    C = heads * dh
    q, kv = _rand(2, 37, C), _rand(2, 300, 2 * C)
    flat = (q, kv[..., :C], kv[..., C:])
    dp = dh + (-dh % 8)
    for got, x in zip(_cross_operands(*flat, n_heads=heads), flat):
        view = x.unflatten(-1, (heads, dh))
        assert got.shape == view.shape[:-1] + (dp,) and _tma_readable(got)
        assert torch.equal(got[..., :dh], view) and not got[..., dh:].any()


def test_cross_operands_of_headsmajor_views():
    """headsmajor's [B, rows, H, dh] views are read in place; f32 is rounded."""
    kv = _rand(2, 300, 2 * 3 * 72)
    q = _rand(2, 37, 3, 72)
    k, v = (x.unflatten(-1, (3, 72)) for x in kv.chunk(2, dim=-1))
    for got, x in zip(_cross_operands(q, k, v), (q, k, v)):
        assert got.data_ptr() == x.data_ptr() and got.stride() == x.stride()
    q32 = q.float()
    got = _cross_operands(q32, k.float(), v.float())[0]
    assert got.dtype == torch.bfloat16 and torch.equal(got, q32.to(torch.bfloat16))


@pytest.mark.parametrize("tile,stages,ok", [
    (CROSS_KEY_TILE[128], CROSS_KEY_STAGES, True),
    (64, CROSS_KEY_STAGES, False),  # the extent and the planted faults would use the wrong tile
    (2 * CROSS_KEY_TILE[128], CROSS_KEY_STAGES, False),
    # a resident extent of another length
    (CROSS_KEY_TILE[128], _shift(CROSS_KEY_STAGES, 1), False),
    (CROSS_KEY_TILE[128], _shift(CROSS_KEY_STAGES, -1), False),
    (64, {w: 2 * s for w, s in CROSS_KEY_STAGES.items()}, False),  # the same keys, other tiles
    (CROSS_KEY_TILE[128], _shift(CROSS_KEY_STAGES, -1, (128,)), False),  # width 128's alone
    ({**CROSS_KEY_TILE, 256: 128}, CROSS_KEY_STAGES, False),  # width 256's tile alone
    (CROSS_KEY_TILE[128], _shift(CROSS_KEY_STAGES, -1, (256,)), False),  # its extent alone
])
def test_cross_library_key_geometry_is_checked(tile, stages, ok):
    name = "cross_attention"  # the library of allheads_attention and headsmajor_attention
    lib = _geometry_lib(name, tile, stages)
    if ok:
        assert _check_key_geometry(lib, name, CROSS_KEY_TILE, CROSS_KEY_STAGES) is lib
    else:
        with pytest.raises(RuntimeError, match=name):
            _check_key_geometry(lib, name, CROSS_KEY_TILE, CROSS_KEY_STAGES)


@pytest.mark.parametrize("M", [1, 77, 300])
def test_cross_key_mask_is_read_as_bytes(M):
    """The cross kernels read the [B, M] key mask as one byte per key with
    contiguous keys: a bool mask (a column slice too) in place, another
    dtype as nonzero = valid, a mask with strided keys copied."""
    lengths = torch.tensor([M, M // 2, 1])
    mask = torch.arange(M)[None] < lengths[:, None]
    got = _key_bytes(mask, mask.device, "test")
    assert got.data_ptr() == mask.data_ptr() and got.stride() == (M, 1)
    wide = torch.cat([mask, ~mask], dim=1)[:, :M]  # a column slice: rows 2 M bytes apart
    got = _key_bytes(wide, wide.device, "test")
    assert got.data_ptr() == wide.data_ptr() and got.stride() == (2 * M, 1)
    got = _key_bytes(mask.int() * 3, mask.device, "test")
    assert got.dtype == torch.bool and torch.equal(got, mask)
    strided = torch.stack([mask, mask], dim=-1)[..., 0]
    got = _key_bytes(strided, mask.device, "test")
    assert got.stride(-1) == 1 and torch.equal(got, mask)
    with pytest.raises(ValueError, match="key_mask on cpu"):
        _key_bytes(mask, torch.device("meta"), "test")


@pytest.mark.parametrize("heads,dh", [(16, 72), (2, 64), (3, 80), (12, 96), (9, 128),
                                      (8, 144), (6, 192), (4, 256)])
def test_backward_operands_read_qkv_slices_in_place(heads, dh):
    """The backward pair reads q, k and v sliced from one qkv projection
    output, and dO, in place (bf16, TMA-readable strides); the mask bias,
    lse and delta become contiguous f32 rows of their own shapes."""
    B, N = 2, 37
    qkv = _rand(B, N, 3 * heads * dh)
    q, k, v = (t.unflatten(-1, (heads, dh)) for t in qkv.chunk(3, dim=-1))
    do = _rand(B, N, heads, dh)
    madd = mask_bias(torch.arange(N)[None] < torch.tensor([N, 5])[:, None])
    lse = _rand(B, N, heads, dtype=torch.float32).transpose(1, 2)  # strided
    delta = _rand(B, heads, N, dtype=torch.float32)
    (gq, gk, gv, gdo), gm, gl, gd = _backward_operands("test", q, k, v, do, madd, lse, delta)
    for got, x in zip((gq, gk, gv, gdo), (q, k, v, do)):
        assert got.data_ptr() == x.data_ptr() and got.stride() == x.stride()
        assert _tma_readable(got)
    assert gm.dtype == torch.float32 and gm.is_contiguous() and torch.equal(gm, madd)
    assert gl.is_contiguous() and torch.equal(gl, lse) and torch.equal(gd, delta)
    assert _backward_operands("test", q, k, v, do, None, lse, delta)[1] is None


def test_backward_operands_round_f32_and_copy_unreadable_views():
    """f32 q/k/v/dO are rounded to bf16 (the tensor cores multiply in bf16;
    the gradients keep the input dtype), views TMA cannot read are copied,
    and shapes that do not match are refused."""
    q = _rand(2, 33, 3, 72, dtype=torch.float32)
    k = _rand(2, 50, 3, 72)
    odd = torch.cat([k, k[..., :4]], -1)[..., :72]  # head stride 76 elements (152 B)
    lse = delta = torch.zeros(2, 3, 33)
    (gq, gk, gv, gdo), *_ = _backward_operands("test", q, k, odd, q, None, lse, delta)
    assert gq.dtype == torch.bfloat16 and torch.equal(gq, q.to(torch.bfloat16))
    assert gk.data_ptr() == k.data_ptr() and torch.equal(gv, odd) and gv.is_contiguous()
    assert all(_tma_readable(x) for x in (gq, gk, gv, gdo))
    with pytest.raises(ValueError, match="dout"):
        _backward_operands("test", q, k, k, q[:, :32], None, lse, delta)
    with pytest.raises(ValueError, match="lse"):
        _backward_operands("test", q, k, k, q, None, lse[:, :, :32], delta)
    with pytest.raises(ValueError, match="madd"):
        _backward_operands("test", q, k, k, q, torch.zeros(2, 49), lse, delta)


@pytest.mark.parametrize("tile,stages,ok", [
    (BWD_KEY_TILE[128], BWD_KEY_STAGES, True),
    (64, BWD_KEY_STAGES, False),  # the extent and its planted fault would use the wrong tile
    (2 * BWD_KEY_TILE[128], BWD_KEY_STAGES, False),
    (BWD_KEY_TILE[128], _shift(BWD_KEY_STAGES, -1), False),
    (BWD_KEY_TILE[128], _shift(BWD_KEY_STAGES, 1, (128,)), False),  # width 128 as the narrower ones
    ({**BWD_KEY_TILE, 256: 128}, BWD_KEY_STAGES, False),  # 128-key dK/dV items at width 256
    (BWD_KEY_TILE[128], _shift(BWD_KEY_STAGES, 1, (256,)), False),  # two 64 KB stages
])
def test_backward_library_key_geometry_is_checked(tile, stages, ok):
    name = "flash_backward"  # the library of flash_bwd_dkv and flash_bwd_dq
    lib = _geometry_lib(name, tile, stages)
    if ok:
        assert _check_key_geometry(lib, name, BWD_KEY_TILE, BWD_KEY_STAGES) is lib
    else:
        with pytest.raises(RuntimeError, match=name):
            _check_key_geometry(lib, name, BWD_KEY_TILE, BWD_KEY_STAGES)
