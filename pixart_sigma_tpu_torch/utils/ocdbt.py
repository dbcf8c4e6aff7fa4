"""A read-only OCDBT key-value store: the on-disk database that orbax writes
through tensorstore (`use_ocdbt`), read without tensorstore.

An OCDBT directory holds `manifest.ocdbt` and data files under `d/` (orbax's
per-process databases sit in `ocdbt.process_<i>/`, and the top-level root
node references their files). Each manifest and B-tree node is framed: a
magic number (big-endian 0x0cdb3a2a for a manifest, 0x0cdb20de for a node),
its total length (u64 little-endian), a format version and a compression
format (varints: 0, and 0 none or 1 zstd), the body, and a CRC-32C of
everything before it (u32 little-endian). The reader checks all of it.

A manifest body is the config (uuid, manifest kind, max inline value bytes,
max decoded node bytes, version tree arity, compression) and the version
list: a data file table, then per version its generation, root height,
root location (file, offset, length) and statistics, and commit time. The
newest generation's root is read. A node body is its height, a data file
table, and its entries, keys prefix-coded against the previous entry:
- a leaf entry is a key and a value, inline or a (file, offset, length)
  reference into a data file;
- an interior entry is the smallest key of a child subtree, the length of
  that subtree's common key prefix (which the child's keys leave out), and
  the child's location and statistics.

Keys are listed when the store opens (the nodes are small); values are read
from the data files only when asked for, so reading one subtree of a
checkpoint reads that subtree's bytes only. Node bodies are decompressed
by the C++ zstd decoder and checksummed by its CRC-32C (`utils/zstd.py`).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple, Union

from pixart_sigma_tpu_torch.utils.zstd import crc32c, decompress_native

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
NO_ROOT = (1 << 64) - 1  # the offset of an empty tree's root


class OcdbtError(ValueError):
    """A file of the store is missing, malformed or fails its checksum."""


@dataclass(frozen=True)
class ValueRef:
    """A value stored out of line: `length` bytes at `offset` of data file `path`
    (relative to the store's root)."""

    path: str
    offset: int
    length: int


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtError(f"{self.what}: {len(self.data) - self.pos} bytes left over")


def unframe(raw: bytes, magic: int, what: str, max_decoded: int = 1 << 31) -> bytes:
    """The body of a framed manifest or node, after checking its magic,
    length, version and CRC-32C, decompressed."""
    if len(raw) < 4 + 8 + 2 + 4:
        raise OcdbtError(f"{what}: too short")
    got_magic, length = struct.unpack_from(">I", raw)[0], struct.unpack_from("<Q", raw, 4)[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: bad magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(raw):
        raise OcdbtError(f"{what}: length {length} in its header, {len(raw)} read")
    crc = struct.unpack_from("<I", raw, len(raw) - 4)[0]
    if crc32c(raw[:-4]) != crc:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    head = _Cursor(raw[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} is not read here")
    body = raw[12 + head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return decompress_native(body, limit=max_decoded).tobytes()
    raise OcdbtError(f"{what}: compression format {compression} is not read here")


def _data_files(c: _Cursor) -> List[str]:
    """A data file table: each path prefix-coded against the previous one;
    a path is its base path (relative to the store's root) and a relative
    path, joined."""
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    c.varints(n)  # base path lengths: where the base ends within the joined path
    paths: List[str] = []
    for i in range(n):
        prev = paths[-1].encode() if paths else b""
        if prefix[i] > len(prev):
            raise OcdbtError(f"{c.what}: data file prefix beyond the previous path")
        path = (prev[:prefix[i]] + c.take(suffix[i])).decode()
        parts = path.split("/")
        if path.startswith("/") or ".." in parts:
            raise OcdbtError(f"{c.what}: data file path {path!r} leaves the store")
        paths.append(path)
    return paths


def _keys(c: _Cursor, n: int, extra: bool) -> Tuple[List[bytes], List[int]]:
    """n prefix-coded keys (and, for an interior node, each subtree's common
    prefix length)."""
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    common = c.varints(n) if extra else []
    keys: List[bytes] = []
    for i in range(n):
        prev = keys[-1] if keys else b""
        if prefix[i] > len(prev):
            raise OcdbtError(f"{c.what}: key prefix beyond the previous key")
        keys.append(prev[:prefix[i]] + c.take(suffix[i]))
    return keys, common


def _file(files: List[str], i: int, what: str) -> str:
    if i >= len(files):
        raise OcdbtError(f"{what}: data file {i} not in its table")
    return files[i]


Value = Union[bytes, ValueRef]


class OcdbtStore:
    """The newest version of the OCDBT database in directory `root`: its
    keys (`keys`), and each value read on demand (`read`)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        path = os.path.join(self.root, "manifest.ocdbt")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{path}: no OCDBT manifest")
        with open(path, "rb") as f:
            raw = f.read()
        c = _Cursor(unframe(raw, MANIFEST_MAGIC, path), path)
        c.take(16)  # the database's uuid
        kind = c.varint()
        self.max_inline_value_bytes = c.varint()
        self.max_decoded_node_bytes = c.varint()
        c.byte()  # the version tree's arity (log2): only the newest version is read
        compression = c.varint()
        if compression == 1:
            c.take(4)  # the zstd level the writer used
        elif compression != 0:
            raise OcdbtError(f"{path}: compression method {compression} is not read here")
        if kind != 0:
            raise OcdbtError(f"{path}: a numbered manifest (kind {kind}) is not read here")
        files = _data_files(c)
        n = c.varint()
        generation = c.varints(n)
        height = [c.byte() for _ in range(n)]
        file_id, offset, length = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
        c.take(8 * n)  # commit times
        if n == 0:
            raise OcdbtError(f"{path}: no version")
        newest = max(range(n), key=generation.__getitem__)
        self.generation, self.root_height = generation[newest], height[newest]
        self._entries: Dict[str, Value] = {}
        if offset[newest] != NO_ROOT:
            root_ref = ValueRef(_file(files, file_id[newest], path), offset[newest],
                                length[newest])
            for key, value in self._walk(root_ref, height[newest], b""):
                self._entries[key.decode()] = value

    def _span(self, ref: ValueRef) -> bytes:
        path = os.path.join(self.root, ref.path)
        try:
            with open(path, "rb") as f:
                f.seek(ref.offset)
                data = f.read(ref.length)
        except FileNotFoundError:
            raise OcdbtError(f"{path}: data file missing") from None
        if len(data) != ref.length:
            raise OcdbtError(f"{path}: {ref.length} bytes at {ref.offset} asked, "
                             f"{len(data)} read")
        return data

    def _walk(self, ref: ValueRef, height: int, prefix: bytes) -> Iterator[Tuple[bytes, Value]]:
        what = f"{os.path.join(self.root, ref.path)}@{ref.offset}"
        c = _Cursor(unframe(self._span(ref), NODE_MAGIC, what, self.max_decoded_node_bytes),
                    what)
        if c.byte() != height:
            raise OcdbtError(f"{what}: node height differs from its parent's reference")
        files = _data_files(c)
        n = c.varint()
        keys, common = _keys(c, n, extra=height > 0)
        if height == 0:
            lengths, kinds = c.varints(n), c.varints(n)
            if any(k > 1 for k in kinds):
                raise OcdbtError(f"{what}: unknown value kind")
            out_of_line = [i for i in range(n) if kinds[i] == 1]
            ids, offsets = c.varints(len(out_of_line)), c.varints(len(out_of_line))
            values: Dict[int, Value] = {
                i: ValueRef(_file(files, f, what), o, lengths[i])
                for i, f, o in zip(out_of_line, ids, offsets)}
            for i in range(n):
                if kinds[i] == 0:
                    values[i] = c.take(lengths[i])
            c.done()
            for i in range(n):
                yield prefix + keys[i], values[i]
            return
        ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)  # statistics
        c.done()
        for i in range(n):
            if common[i] > len(keys[i]):
                raise OcdbtError(f"{what}: subtree prefix beyond its key")
            child = ValueRef(_file(files, ids[i], what), offsets[i], lengths[i])
            yield from self._walk(child, height - 1, prefix + keys[i][:common[i]])

    def keys(self, prefix: str = "") -> List[str]:
        """Every key (starting with `prefix`), sorted."""
        return sorted(k for k in self._entries if k.startswith(prefix))

    def read(self, key: str) -> Optional[bytes]:
        """The value of `key`, or None when the store has no such key."""
        value = self._entries.get(key)
        if value is None or isinstance(value, bytes):
            return value
        return self._span(value)
