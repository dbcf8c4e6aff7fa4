"""`utils.flax_msgpack` against `flax.serialization` on bfloat16 leaves and
chunked arrays, both ways: what flax writes reads back to the same values,
and what the port writes is flax's bytes, which flax reads back.

A bfloat16 leaf is a torch.bfloat16 tensor in the port (numpy has no
bfloat16 without ml_dtypes); values are compared exactly through their bits.
Chunked arrays are exercised with MAX_CHUNK_SIZE lowered on both sides."""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pixart_sigma_tpu_torch.utils import flax_msgpack


def _bits(x) -> np.ndarray:
    """A bfloat16 array's (jax/ml_dtypes or torch) bits as uint16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _bf16(rng, *shape):
    return jnp.asarray(rng.randn(*shape).astype(np.float32), jnp.bfloat16)


def _tree(rng):
    return {"params": {
        "proj": {"kernel": _bf16(rng, 8, 6), "bias": _bf16(rng, 6)},
        "norm": {"scale": rng.randn(6).astype(np.float32)},
        "zero_d": jnp.asarray(0.375, jnp.bfloat16),
        "empty": jnp.zeros((0, 4), jnp.bfloat16),
    }}


def _assert_same(got, want, port: bool = True):
    """got (the port's tree, or with `port` False flax's) equals want."""
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k], port)
        return
    if np.asarray(want).dtype == jnp.bfloat16:
        if port:
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        else:
            assert np.asarray(got).dtype == jnp.bfloat16
        assert tuple(got.shape) == np.asarray(want).shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_bfloat16_leaves_read_from_flax():
    tree = _tree(np.random.RandomState(0))
    got = flax_msgpack.from_bytes(serialization.to_bytes(tree))
    _assert_same(got, tree)
    assert got["params"]["zero_d"].dim() == 0


def test_bfloat16_leaves_written_as_flax_writes_them():
    tree = _tree(np.random.RandomState(1))
    data = serialization.to_bytes(tree)
    ported = flax_msgpack.from_bytes(data)
    assert flax_msgpack.to_bytes(ported) == data
    _assert_same(serialization.msgpack_restore(flax_msgpack.to_bytes(ported)), tree, port=False)


def test_bfloat16_scalar_of_flax_reads_as_a_0d_tensor():
    data = serialization.to_bytes({"s": np.asarray(jnp.asarray(-2.5, jnp.bfloat16))[()]})
    got = flax_msgpack.from_bytes(data)["s"]
    assert got.dtype == torch.bfloat16 and got.dim() == 0 and float(got) == -2.5


@pytest.mark.parametrize("chunk", [64, 40, 7])
def test_chunked_arrays_both_ways(monkeypatch, chunk):
    """Arrays past MAX_CHUNK_SIZE bytes (lowered on both sides), f32, int32
    and bfloat16, nested, beside arrays below it: flax's bytes read back
    whole, and the port writes flax's bytes."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.RandomState(chunk)
    tree = {"w": rng.randn(10, 7).astype(np.float32),
            "nested": {"ids": np.arange(33, dtype=np.int32).reshape(3, 11),
                       "bf": _bf16(rng, 5, 9), "small": np.ones(1, np.float32)}}
    data = serialization.to_bytes(tree)
    got = flax_msgpack.from_bytes(data)
    _assert_same(got, tree)
    assert flax_msgpack.to_bytes(got) == data
    _assert_same(serialization.msgpack_restore(flax_msgpack.to_bytes(got)), tree, port=False)


def test_torch_leaves_other_than_bfloat16_are_refused():
    with pytest.raises(TypeError, match="bfloat16"):
        flax_msgpack.to_bytes({"w": torch.zeros(3)})
