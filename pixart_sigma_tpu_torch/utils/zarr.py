"""zarr v2 arrays read from a key-value store: the arrays of an orbax
checkpoint, one per leaf, in its OCDBT store (`utils/ocdbt.py`).

An array `name` is its JSON metadata at `name/.zarray` (shape, chunk shape,
dtype, compressor, filters, fill value, order, dimension separator) and one
value per chunk at `name/<i>.<j>...` (`name/0` for a 0-d array). Edge
chunks are stored whole and cut to the array's shape; a chunk that was
never written takes the fill value. Chunks are decompressed by the C++ zstd
decoder (`utils/zstd.py`), the only compressor orbax writes; any other
compressor, and any filter, raises and names itself.

dtypes: <f4, <f2, <i4, <i8, |b1 as numpy arrays, and bfloat16 (which numpy
has no dtype for) as a torch.bfloat16 tensor through its 16 bits, as
`utils/flax_msgpack.py` reads it.
"""

from __future__ import annotations

import itertools
import json
import math
from typing import Union

import numpy as np
import torch

from pixart_sigma_tpu_torch.utils.zstd import decompress_native

DTYPES = {"<f4": np.float32, "<f2": np.float16, "<i4": np.int32, "<i8": np.int64,
          "|b1": np.bool_, "bfloat16": np.int16}


class ZarrError(ValueError):
    """An array whose metadata or chunks this reader does not take."""


def read_metadata(store, name: str) -> dict:
    raw = store.read(f"{name}/.zarray")
    if raw is None:
        raise ZarrError(f"{name}: no .zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ZarrError(f"{name}: zarr_format {meta.get('zarr_format')} is not read here")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ZarrError(f"{name}: compressor {compressor.get('id')!r} is not read here")
    if meta.get("filters"):
        raise ZarrError(f"{name}: filters {meta['filters']} are not read here")
    if meta.get("dtype") not in DTYPES:
        raise ZarrError(f"{name}: dtype {meta.get('dtype')!r} is not read here")
    if meta.get("order", "C") not in ("C", "F"):
        raise ZarrError(f"{name}: order {meta.get('order')!r}")
    if meta.get("dimension_separator", ".") not in (".", "/"):
        raise ZarrError(f"{name}: dimension_separator {meta['dimension_separator']!r}")
    if len(meta["chunks"]) != len(meta["shape"]) or min(meta["chunks"], default=1) < 1:
        raise ZarrError(f"{name}: chunks {meta['chunks']} do not fit shape {meta['shape']}")
    return meta


def _fill(meta: dict, dtype) -> np.ndarray:
    value = meta.get("fill_value")
    if value is None:
        return np.zeros((), dtype)
    if meta["dtype"] == "bfloat16":  # tensorstore writes it as a float
        f32 = np.array(float(value), np.float32).view(np.uint32)
        return np.array(f32 >> 16, np.uint16).view(np.int16)
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        value = float(value)
    return np.array(value, dtype)


def read_array(store, name: str) -> Union[np.ndarray, torch.Tensor]:
    """The zarr v2 array `name` of `store` (anything with `read(key)`)."""
    meta = read_metadata(store, name)
    dtype = np.dtype(DTYPES[meta["dtype"]])
    shape, chunks, order = tuple(meta["shape"]), tuple(meta["chunks"]), meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        where = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        raw = store.read(key)
        if raw is None:
            out[where] = _fill(meta, dtype)
            continue
        if meta.get("compressor") is not None:
            data = decompress_native(raw, chunk_bytes)
        elif len(raw) == chunk_bytes:
            data = np.frombuffer(raw, np.uint8)
        else:
            raise ZarrError(f"{key}: {len(raw)} bytes, a chunk holds {chunk_bytes}")
        chunk = data.view(dtype).reshape(chunks, order=order)
        out[where] = chunk[tuple(slice(0, w.stop - w.start) for w in where)]
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out).view(torch.bfloat16)
    return out
