"""The port's two zstd decoders (`utils/zstd.py` in Python, `csrc/zstd_decode.cpp`
built by the host C++ compiler) against the `zstandard` package, which
only the tests import: a seeded corpus at levels 1, 3 and 19 (empty, one
byte, incompressible bytes, runs, text, f32 and bf16 weights, inputs over
128 KB, so frames of many blocks), with and without the content size and
the checksum, frames back to back and beside a skippable frame, hypothesis
inputs, and corrupted frames, which both refuse. Every output must equal
`zstandard.decompress` byte for byte."""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from pixart_sigma_tpu_torch.utils import zstd


def _corpus():
    rng = np.random.RandomState(0)
    text = " ".join(f"the caption {i} of a cat on a mat" for i in range(2500)).encode()
    w = (rng.randn(50_000) * 0.02).astype(np.float32)
    bf16 = (w.view(np.uint32) >> 16).astype(np.uint16)
    return {"empty": b"", "one byte": b"x", "incompressible": rng.bytes(3000),
            "runs": b"a" * 700 + b"b" * 40_000 + b"abc" * 3000,
            "text": text, "f32": w.tobytes(), "bf16": bf16.tobytes(),
            "over 128 KB": text + w[:12_000].tobytes()}


CORPUS = _corpus()


def _both(frame: bytes) -> bytes:
    want = zstandard.ZstdDecompressor().decompressobj().decompress(frame)
    got_py = zstd.decompress(frame)
    got_cpp = zstd.decompress_native(frame).tobytes()
    assert got_py == want and got_cpp == want
    return want


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", list(CORPUS))
def test_both_decoders_equal_zstandard(level, name):
    data = CORPUS[name]
    for size, checksum in ((True, False), (False, True)):
        frame = zstandard.ZstdCompressor(level=level, write_content_size=size,
                                         write_checksum=checksum).compress(data)
        assert _both(frame) == data
    if len(data) > 1 << 17:
        assert zstd.decompress_native(frame, len(data)).tobytes() == data


def test_frames_back_to_back_and_skippable_frames():
    a = zstandard.ZstdCompressor(level=3).compress(CORPUS["text"][:5000])
    b = zstandard.ZstdCompressor(level=1, write_checksum=True).compress(CORPUS["f32"][:4000])
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    want = CORPUS["text"][:5000] + CORPUS["f32"][:4000]
    for frame in (a + b, skip + a + skip + b + skip):
        assert zstd.decompress(frame) == want
        assert zstd.decompress_native(frame).tobytes() == want


@settings(max_examples=25, deadline=None, database=None)
@given(data=st.binary(min_size=1, max_size=3000), level=st.sampled_from([1, 3, 19]),
       repeat=st.integers(1, 6))
def test_hypothesis_inputs(data, level, repeat):
    payload = data * repeat
    frame = zstandard.ZstdCompressor(level=level, write_checksum=True).compress(payload)
    assert _both(frame) == payload


def test_xxh64_and_crc32c_known_values():
    import hashlib

    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999
    assert zstd.crc32c(b"123456789") == 0xE3069283
    data = CORPUS["text"][:10_001]
    frame = zstandard.ZstdCompressor(write_checksum=True).compress(data)
    assert int.from_bytes(frame[-4:], "little") == zstd.xxh64(data) & 0xFFFFFFFF
    assert hashlib.sha256(zstd.decompress(frame)).digest() == hashlib.sha256(data).digest()


def _flip(frame: bytes, at: int) -> bytes:
    out = bytearray(frame)
    out[at] ^= 0x5A
    return bytes(out)


def test_a_corrupted_frame_raises_in_both():
    data = CORPUS["f32"][:60_000] + CORPUS["text"][:30_000]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    bad = [frame[:-7],  # truncated
           b"\x00" + frame[1:],  # magic
           _flip(frame, len(frame) - 2),  # the checksum
           frame + b"\x28\xb5"]  # trailing bytes
    bad += [_flip(frame, i) for i in range(20, len(frame) - 8, len(frame) // 13)]
    for frame_bad in bad:
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame_bad)
        with pytest.raises(zstd.ZstdError):
            zstd.decompress_native(frame_bad)
    with pytest.raises(zstd.ZstdError):
        zstd.decompress_native(frame, len(data) - 1)  # the caller's size is held


def test_a_dictionary_frame_is_refused_by_name():
    d = zstandard.train_dictionary(4096, [CORPUS["text"][i:i + 500] for i in range(0, 60_000,
                                                                                   600)])
    frame = zstandard.ZstdCompressor(dict_data=d).compress(CORPUS["text"][:2000])
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(frame)
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress_native(frame)
