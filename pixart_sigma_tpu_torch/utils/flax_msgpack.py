"""The msgpack files of `flax.serialization.to_bytes`, read and written in
plain Python.

The subset a parameter tree needs: maps with str keys, nested, whose leaves
are numpy arrays (msgpack ext type 1: a packed (shape, dtype name, C-order
bytes) triple) or numpy scalars (ext type 3, the same triple of a 0-d
array). A bfloat16 leaf, which numpy has no dtype for, is a torch.bfloat16
tensor here, read through its uint16 bits (a scalar as a 0-d tensor) and
written as an array.
The writer packs each item in msgpack's shortest form, as `msgpack.packb`
does, so a tree in flax's key order gives flax's bytes. An array beyond
MAX_CHUNK_SIZE bytes is flax's chunked array: a map {CHUNKED_KEY: True,
"shape": {"0": d0, ...}, "chunks": {"0": flat chunk, ...}} of 1-D chunks of
MAX_CHUNK_SIZE bytes (in elements, rounded down), written and read as flax
writes and reads it.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2**30  # flax's: larger arrays are written in chunks
CHUNKED_KEY = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ writing
def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below fix_max, else 8/16/32 bits."""
    if n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in codes:
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} beyond msgpack's 32 bits")


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    _head(out, len(b), 0xA0, 31, ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                                  (0xDB, ">I", 0xFFFFFFFF)))
    out += b


def _pack_uint(out: bytearray, n: int) -> None:
    if n < 0:
        raise ValueError("negative array dimension")
    if n <= 0x7F:
        out.append(n)
    elif n <= 0xFF:
        out += b"\xcc" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", n)
    else:
        out += b"\xcf" + struct.pack(">Q", n)


def _bf16_bits(x: torch.Tensor) -> np.ndarray:
    """A torch.bfloat16 tensor's bits as a uint16 numpy array of its shape."""
    return x.detach().cpu().contiguous().view(torch.int16).numpy().view(np.uint16)


def _array_payload(arr) -> bytes:
    """flax's `_ndarray_to_bytes`: packb((shape, dtype name, bytes)); a
    torch.bfloat16 tensor is written as "bfloat16" with its bits."""
    if isinstance(arr, torch.Tensor):
        name, arr = "bfloat16", _bf16_bits(arr)
    else:
        name = arr.dtype.name
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    out = bytearray(b"\x93")
    _head(out, arr.ndim, 0x90, 15, ((None, "", 0), (0xDC, ">H", 0xFFFF),
                                    (0xDD, ">I", 0xFFFFFFFF)))
    for d in arr.shape:
        _pack_uint(out, int(d))
    _pack_str(out, name)
    data = arr.tobytes("C")
    _head(out, len(data), 0, -1, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                                  (0xC6, ">I", 0xFFFFFFFF)))
    out += data
    return bytes(out)


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    if n in fixed:
        out.append(fixed[n])
    else:
        _head(out, n, 0, -1, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                              (0xC9, ">I", 0xFFFFFFFF)))
    out += struct.pack(">b", code)
    out += payload


def _chunked(arr) -> Dict[str, Any]:
    """flax's `_chunk`: the array as its flat chunks of MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.element_size()
                      if isinstance(arr, torch.Tensor) else MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {CHUNKED_KEY: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(out: bytearray, x: Any) -> None:
    if isinstance(x, dict):
        _head(out, len(x), 0x80, 15, ((None, "", 0), (0xDE, ">H", 0xFFFF),
                                      (0xDF, ">I", 0xFFFFFFFF)))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {type(k).__name__}")
            _pack_str(out, k)
            _pack(out, v)
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        _pack_uint(out, x)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        if isinstance(x, torch.Tensor) and x.dtype != torch.bfloat16:
            raise TypeError(f"a torch tensor leaf must be bfloat16, got {x.dtype}")
        nbytes = (x.numel() * x.element_size() if isinstance(x, torch.Tensor)
                  else x.size * x.dtype.itemsize)
        if nbytes > MAX_CHUNK_SIZE:
            _pack(out, _chunked(x))
        else:
            _pack_ext(out, EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(x)))
    else:
        raise TypeError(f"cannot write a {type(x).__name__}: maps of numpy arrays only")


def to_bytes(tree: Dict[str, Any]) -> bytes:
    """A nested dict of numpy arrays (and torch.bfloat16 tensors) -> the
    bytes `flax.serialization.to_bytes` writes for it."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# ------------------------------------------------------------------ reading
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def uint(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", bytes), 0xC5: (">H", bytes), 0xC6: (">I", bytes),
                 0xD9: (">B", str), 0xDA: (">H", str), 0xDB: (">I", str)}
        if b in sized:
            fmt, kind = sized[b]
            raw = self.take(self.uint(fmt))
            return str(raw, "utf-8") if kind is str else bytes(raw)
        numbers = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.uint(numbers[b])
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.uint(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.uint(">H" if b == 0xDE else ">I"))
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixed or b in (0xC7, 0xC8, 0xC9):
            n = fixed[b] if b in fixed else self.uint({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = struct.unpack(">b", self.take(1))[0]
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not read here")

    def map(self, n: int) -> Dict[str, Any]:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return _unchunked(out) if CHUNKED_KEY in out else out


def _unchunked(d: Dict[str, Any]):
    """flax's `_unchunk`: the array of a chunked map."""
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _ext(code: int, payload: bytes):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} is not read here")
    r = _Reader(payload)
    shape, name, data = r.read()
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(data, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    arr = np.frombuffer(data, dtype=np.dtype(name)).reshape(shape).copy()
    return arr[()] if code == EXT_NPSCALAR else arr


def from_bytes(data: bytes) -> Any:
    """The tree of a file written by `flax.serialization.to_bytes` (or
    `to_bytes` here): nested dicts of numpy arrays (torch.bfloat16 tensors
    for bfloat16 leaves), chunked arrays joined."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return tree
