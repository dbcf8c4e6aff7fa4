"""A Zstandard frame decoder in plain Python (RFC 8878): the plain version of
`csrc/zstd_decode.cpp`, which reads the orbax checkpoints.

It takes what a zstd encoder writes without a dictionary: frame headers
(window descriptor, content size, single segment), skippable frames, raw,
RLE and compressed blocks; literals that are raw, RLE, Huffman-coded or
treeless, in one or four streams, with Huffman weights given directly or
FSE-coded; sequences whose tables are predefined, RLE, FSE-coded or
repeated, with the three repeat offsets; and the content checksum (the low
32 bits of xxhash64), verified when the frame carries one. A frame that
names a dictionary raises. Every malformed input raises `ZstdError`.

Nothing on the load path calls it: it is the reference the C++ decoder is
held against, and it runs at a few MB/s. The load path calls the C++
decoder through `decompress_native` (and OCDBT's checksums through
`crc32c`), built from the checkout's `csrc/zstd_decode.cpp` at first use by
the host C++ compiler; a failed build raises, with no fallback to this one.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE_MASK = 0xFFFFFFF0
SKIPPABLE_MAGIC = 0x184D2A50
BLOCK_MAX = 1 << 17  # 128 KiB, the largest block a frame may hold

# RFC 8878 3.1.1.3.2.2: the predefined distributions
LL_DEFAULT = (4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
              1, 1, 1, 1, 1, -1, -1, -1, -1)
ML_DEFAULT = (1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1,
              -1)
OF_DEFAULT = (1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
              -1, -1, -1)
LL_MAX, ML_MAX, OF_MAX = 35, 52, 31
LL_MAX_LOG, ML_MAX_LOG, OF_MAX_LOG = 9, 9, 8
# literal length code -> (baseline, extra bits); codes 0-15 are the length itself
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4), (64, 6),
    (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13), (16384, 14),
    (32768, 15), (65536, 16)]
# match length code -> (baseline, extra bits); codes 0-31 are the length - 3
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4), (83, 4),
    (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13),
    (16387, 14), (32771, 15), (65539, 16)]
HUF_MAX_BITS = 11


class ZstdError(ValueError):
    """A frame this decoder cannot take: malformed, or naming a dictionary."""


# ----------------------------------------------------------------- xxhash64
_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """xxHash64 of `data` (the hash a zstd content checksum is cut from)."""
    n, pos = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        lanes = struct.unpack_from(f"<{(n // 32) * 4}Q", data)
        for i in range(0, len(lanes), 4):
            v = [_round(v[j], lanes[i + j]) for j in range(4)]
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for x in v:
            h = (((h ^ _round(0, x)) * _P1) + _P4) & _M64
        pos = (n // 32) * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        h = (_rotl(h ^ _round(0, struct.unpack_from("<Q", data, pos)[0]), 27) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        h = (_rotl(h ^ ((struct.unpack_from("<I", data, pos)[0] * _P1) & _M64), 23) * _P2
             + _P3) & _M64
        pos += 4
    while pos < n:
        h = (_rotl(h ^ ((data[pos] * _P5) & _M64), 11) * _P1) & _M64
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# -------------------------------------------------------------- bit readers
class _ForwardBits:
    """Little-endian bits from data[pos:end], least significant first (the
    FSE table descriptions)."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.start, self.end, self.bit = data, pos, end, 0

    def peek(self, n: int) -> int:
        lo = self.start + (self.bit >> 3)
        chunk = self.data[lo:min(lo + 5, self.end)]
        return (int.from_bytes(chunk, "little") >> (self.bit & 7)) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.bit += n
        if self.start + ((self.bit + 7) >> 3) > self.end:
            raise ZstdError("FSE table description runs past its section")

    def nbytes(self) -> int:
        return (self.bit + 7) >> 3


class _BackwardBits:
    """A zstd backward bitstream over data[start:end]: read from the end, most
    significant bits first, after the padding up to the last byte's highest
    set bit. Bits before the start read as zeros; `overflowed` says a read
    went there."""

    def __init__(self, data: bytes, start: int, end: int):
        if end <= start or data[end - 1] == 0:
            raise ZstdError("bitstream is empty or lacks its end mark")
        self.data, self.start = data, start
        self.pos = (end - start - 1) * 8 + data[end - 1].bit_length() - 1  # bits left

    def peek(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos - n
        if p >= 0:
            lo = self.start + (p >> 3)
            hi = self.start + ((self.pos + 7) >> 3)
            return (int.from_bytes(self.data[lo:hi], "little") >> (p & 7)) & ((1 << n) - 1)
        if self.pos <= 0:
            return 0
        have = int.from_bytes(self.data[self.start:self.start + ((self.pos + 7) >> 3)], "little")
        return (have & ((1 << self.pos) - 1)) << -p

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos -= n
        return v

    @property
    def overflowed(self) -> bool:
        return self.pos < 0


# ---------------------------------------------------------------------- FSE
def read_fse_counts(data: bytes, pos: int, end: int, max_symbol: int,
                    max_log: int) -> Tuple[List[int], int, int]:
    """An FSE table description at data[pos:end] -> (normalised counts, with
    -1 for a "less than one" probability; accuracy log; bytes read)."""
    bits = _ForwardBits(data, pos, end)
    if end <= pos:
        raise ZstdError("FSE table description is empty")
    log = bits.peek(4) + 5
    bits.skip(4)
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    counts: List[int] = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise ZstdError("FSE table description has too many symbols")
        big = 2 * threshold - 1 - remaining
        v = bits.peek(nbits)
        if (v & (threshold - 1)) < big:
            v &= threshold - 1
            bits.skip(nbits - 1)
        else:
            if v >= threshold:
                v -= big
            bits.skip(nbits)
        count = v - 1
        remaining -= abs(count)
        counts.append(count)
        if count == 0:  # repeat flags: runs of zero probabilities
            while True:
                rep = bits.peek(2)
                bits.skip(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
            if len(counts) > max_symbol + 1:
                raise ZstdError("FSE zero run past the last symbol")
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("FSE table description does not sum to its size")
    return counts, log, bits.nbytes()


class FseTable:
    """An FSE decoding table: per state its symbol, the bits to read and the
    base of the next state."""

    def __init__(self, counts: Sequence[int], log: int):
        size = 1 << log
        symbol = [0] * size
        high = size - 1
        nxt = [0] * len(counts)
        for s, c in enumerate(counts):
            if c == -1:
                symbol[high] = s
                high -= 1
                nxt[s] = 1
            else:
                nxt[s] = c
        step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
        for s, c in enumerate(counts):
            for _ in range(max(c, 0)):
                symbol[pos] = s
                pos = (pos + step) & mask
                while pos > high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise ZstdError("FSE table spread does not close")
        self.log, self.symbol = log, symbol
        self.nbits, self.base = [0] * size, [0] * size
        for u in range(size):
            n = nxt[symbol[u]]
            nxt[symbol[u]] += 1
            self.nbits[u] = log - (n.bit_length() - 1)
            self.base[u] = (n << self.nbits[u]) - size

    @classmethod
    def rle(cls, symbol: int) -> "FseTable":
        t = cls.__new__(cls)
        t.log, t.symbol, t.nbits, t.base = 0, [symbol], [0], [0]
        return t


LL_TABLE = FseTable(LL_DEFAULT, 6)
ML_TABLE = FseTable(ML_DEFAULT, 6)
OF_TABLE = FseTable(OF_DEFAULT, 5)


# ------------------------------------------------------------------ Huffman
class HuffmanTable:
    """A Huffman decoding table indexed by the next `max_bits` bits."""

    def __init__(self, weights: Sequence[int]):
        total = sum(1 << (w - 1) for w in weights if w)
        if total == 0:
            raise ZstdError("Huffman weights are all zero")
        max_bits = total.bit_length()  # the implied last weight fills 2^max_bits
        rest = (1 << max_bits) - total
        if rest & (rest - 1) or max_bits > HUF_MAX_BITS:
            raise ZstdError("Huffman weights do not complete a tree")
        weights = list(weights) + [rest.bit_length()]
        counts = [0] * (max_bits + 2)
        for w in weights:
            if w > max_bits:
                raise ZstdError("Huffman weight above the tree's depth")
            counts[w] += 1
        start, pos = [0] * (max_bits + 2), 0
        for w in range(1, max_bits + 1):
            start[w] = pos
            pos += counts[w] << (w - 1)
        size = 1 << max_bits
        self.max_bits = max_bits
        self.symbol, self.nbits = [0] * size, [0] * size
        for s, w in enumerate(weights):
            if w:
                n = 1 << (w - 1)
                lo = start[w]
                self.symbol[lo:lo + n] = [s] * n
                self.nbits[lo:lo + n] = [max_bits + 1 - w] * n
                start[w] += n

    def decode_stream(self, data: bytes, start: int, end: int, n: int, out: bytearray) -> None:
        bits = _BackwardBits(data, start, end)
        mb, sym, nb = self.max_bits, self.symbol, self.nbits
        for _ in range(n):
            v = bits.peek(mb)
            out.append(sym[v])
            bits.pos -= nb[v]
        if bits.pos != 0:
            raise ZstdError("Huffman stream not consumed exactly")


def _huffman_weights(data: bytes, pos: int, end: int) -> Tuple[List[int], int]:
    """The tree description at data[pos:end] -> (weights of every symbol but
    the last, bytes read)."""
    if pos >= end:
        raise ZstdError("Huffman tree description missing")
    head = data[pos]
    if head >= 128:  # direct: 4 bits per weight
        n = head - 127
        size = (n + 1) // 2
        if pos + 1 + size > end:
            raise ZstdError("Huffman weights run past the literals")
        raw = data[pos + 1:pos + 1 + size]
        weights = [(raw[i // 2] >> (0 if i & 1 else 4)) & 15 for i in range(n)]
        return weights, 1 + size
    if pos + 1 + head > end or head == 0:
        raise ZstdError("Huffman weights run past the literals")
    counts, log, used = read_fse_counts(data, pos + 1, pos + 1 + head, 255, 6)
    table = FseTable(counts, log)
    bits = _BackwardBits(data, pos + 1 + used, pos + 1 + head)
    s1, s2 = bits.read(log), bits.read(log)
    weights: List[int] = []
    while True:  # two states take turns; the stream's end emits the other's symbol
        for this, other in ((0, 1), (1, 0)):
            st = (s1, s2)[this]
            weights.append(table.symbol[st])
            st = table.base[st] + bits.read(table.nbits[st])
            if this == 0:
                s1 = st
            else:
                s2 = st
            if bits.overflowed:
                weights.append(table.symbol[(s1, s2)[other]])
                if len(weights) > 255:
                    raise ZstdError("too many Huffman weights")
                return weights, 1 + head
            if len(weights) > 255:
                raise ZstdError("too many Huffman weights")


# ---------------------------------------------------------------- the frame
class _FrameState:
    def __init__(self, window: int):
        self.window = window
        self.huffman: Optional[HuffmanTable] = None
        self.tables: List[Optional[FseTable]] = [None, None, None]  # LL, OF, ML
        self.rep = [1, 4, 8]


def _literals(data: bytes, pos: int, end: int, st: _FrameState) -> Tuple[bytes, int]:
    """The literals section at data[pos:end] -> (literals, its end)."""
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:  # raw or RLE
        head = (1, 2, 1, 3)[fmt]
        if pos + head > end:
            raise ZstdError("literals header runs past the block")
        h = int.from_bytes(data[pos:pos + head], "little")
        size = h >> 3 if head == 1 else h >> 4
        pos += head
        if kind == 0:
            if pos + size > end:
                raise ZstdError("raw literals run past the block")
            return bytes(data[pos:pos + size]), pos + size
        if pos >= end:
            raise ZstdError("RLE literals run past the block")
        return bytes([data[pos]]) * size, pos + 1
    head = (3, 3, 4, 5)[fmt]
    if pos + head > end:
        raise ZstdError("literals header runs past the block")
    h = int.from_bytes(data[pos:pos + head], "little")
    nbits = (10, 10, 14, 18)[fmt]
    regen = (h >> 4) & ((1 << nbits) - 1)
    comp = (h >> (4 + nbits)) & ((1 << nbits) - 1)
    streams = 1 if fmt == 0 else 4
    pos += head
    if pos + comp > end or regen > BLOCK_MAX:
        raise ZstdError("compressed literals run past the block")
    lit_end = pos + comp
    if kind == 2:
        weights, used = _huffman_weights(data, pos, lit_end)
        st.huffman = HuffmanTable(weights)
        pos += used
    elif st.huffman is None:
        raise ZstdError("treeless literals without an earlier Huffman table")
    out = bytearray()
    if streams == 1:
        st.huffman.decode_stream(data, pos, lit_end, regen, out)
    else:
        if pos + 6 > lit_end:
            raise ZstdError("literals jump table runs past the block")
        sizes = list(struct.unpack_from("<3H", data, pos))
        pos += 6
        sizes.append(lit_end - pos - sum(sizes))
        if sizes[3] < 0:
            raise ZstdError("literals streams run past the block")
        each = (regen + 3) // 4
        counts = [each, each, each, regen - 3 * each]
        if counts[3] < 0:
            raise ZstdError("literals streams are too short")
        for size, n in zip(sizes, counts):
            st.huffman.decode_stream(data, pos, pos + size, n, out)
            pos += size
    return bytes(out), lit_end


def _table(data: bytes, pos: int, end: int, mode: int, which: int,
           st: _FrameState) -> int:
    """Set sequence table `which` (0 LL, 1 OF, 2 ML) by its mode; returns the
    position after its description."""
    default, max_symbol, max_log = ((LL_TABLE, LL_MAX, LL_MAX_LOG), (OF_TABLE, OF_MAX, OF_MAX_LOG),
                                    (ML_TABLE, ML_MAX, ML_MAX_LOG))[which]
    if mode == 0:
        st.tables[which] = default
    elif mode == 1:
        if pos >= end or data[pos] > max_symbol:
            raise ZstdError("RLE sequence symbol out of range")
        st.tables[which] = FseTable.rle(data[pos])
        pos += 1
    elif mode == 2:
        counts, log, used = read_fse_counts(data, pos, end, max_symbol, max_log)
        st.tables[which] = FseTable(counts, log)
        pos += used
    elif st.tables[which] is None:
        raise ZstdError("repeat mode without an earlier sequence table")
    return pos


def _block(data: bytes, pos: int, end: int, st: _FrameState, out: bytearray,
           frame_start: int) -> None:
    """Decode one compressed block at data[pos:end], appending to `out`."""
    if pos >= end:
        raise ZstdError("compressed block is empty")
    lits, pos = _literals(data, pos, end, st)
    if pos >= end:
        raise ZstdError("sequences section missing")
    b0 = data[pos]
    if b0 == 0:
        if pos + 1 != end:
            raise ZstdError("bytes after an empty sequences section")
        out += lits
        return
    if pos + (1 if b0 < 128 else 2 if b0 < 255 else 3) > end:
        raise ZstdError("sequences header runs past the block")
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if pos >= end:
        raise ZstdError("sequences section runs past the block")
    modes = data[pos]
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    pos += 1
    for which, shift in ((0, 6), (1, 4), (2, 2)):
        pos = _table(data, pos, end, (modes >> shift) & 3, which, st)
    ll_t, of_t, ml_t = st.tables
    bits = _BackwardBits(data, pos, end)
    ll, of, ml = bits.read(ll_t.log), bits.read(of_t.log), bits.read(ml_t.log)
    rep = st.rep
    lit_pos = 0
    for i in range(nseq):
        of_code, ml_code, ll_code = of_t.symbol[of], ml_t.symbol[ml], ll_t.symbol[ll]
        if of_code > OF_MAX:
            raise ZstdError("offset code out of range")
        ov = (1 << of_code) + bits.read(of_code)
        base, nb = ML_CODES[ml_code]
        mlen = base + bits.read(nb)
        base, nb = LL_CODES[ll_code]
        llen = base + bits.read(nb)
        if ov > 3:
            off = ov - 3
            rep[:] = [off, rep[0], rep[1]]
        else:
            idx = ov - 1 if llen else ov
            if idx == 0:
                off = rep[0]
            else:
                off = rep[idx] if idx < 3 else rep[0] - 1
                rep[:] = [off, rep[0], rep[2]] if idx == 1 else [off, rep[0], rep[1]]
        if i + 1 < nseq:  # state updates: LL, ML, OF
            ll = ll_t.base[ll] + bits.read(ll_t.nbits[ll])
            ml = ml_t.base[ml] + bits.read(ml_t.nbits[ml])
            of = of_t.base[of] + bits.read(of_t.nbits[of])
        if lit_pos + llen > len(lits):
            raise ZstdError("sequence takes more literals than the block has")
        out += lits[lit_pos:lit_pos + llen]
        lit_pos += llen
        have = len(out) - frame_start
        if off == 0 or off > have or off > st.window:
            raise ZstdError("match offset beyond the decoded data")
        src = len(out) - off
        if off >= mlen:
            out += out[src:src + mlen]
        else:  # the match overlaps what it writes: the pattern repeats
            pattern = out[src:]
            out += (pattern * (mlen // off + 1))[:mlen]
    if bits.pos != 0:
        raise ZstdError("sequences bitstream not consumed exactly")
    out += lits[lit_pos:]


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    """Decode the zstd frame whose header starts at data[pos] (after the
    magic), appending its content to `out`; returns the position after it."""
    n = len(data)
    if pos >= n:
        raise ZstdError("frame header truncated")
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, did_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    window = 0
    if not single:
        if pos >= n:
            raise ZstdError("frame header truncated")
        wd = data[pos]
        pos += 1
        log = 10 + (wd >> 3)
        window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[did_flag]
    if pos + did_size > n:
        raise ZstdError("frame header truncated")
    did = int.from_bytes(data[pos:pos + did_size], "little")
    pos += did_size
    if did:
        raise ZstdError(f"frame needs dictionary {did}: no dictionary is supported")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if pos + fcs_size > n:
        raise ZstdError("frame header truncated")
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(data[pos:pos + fcs_size], "little")
        content_size += 256 if fcs_size == 2 else 0
    pos += fcs_size
    if single:
        window = content_size
    st = _FrameState(window)
    start = len(out)
    block_max = min(window, BLOCK_MAX)
    while True:
        if pos + 3 > n:
            raise ZstdError("block header truncated")
        h = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16)
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 3:
            raise ZstdError("reserved block type")
        if size > block_max:
            raise ZstdError("block larger than the frame's block size")
        if kind == 0:
            if pos + size > n:
                raise ZstdError("raw block truncated")
            out += data[pos:pos + size]
            pos += size
        elif kind == 1:
            if pos >= n:
                raise ZstdError("RLE block truncated")
            out += bytes([data[pos]]) * size
            pos += 1
        else:
            if pos + size > n:
                raise ZstdError("compressed block truncated")
            before = len(out)
            _block(data, pos, pos + size, st, out, start)
            if len(out) - before > block_max:
                raise ZstdError("block decodes past the block size")
            pos += size
        if last:
            break
    if content_size is not None and len(out) - start != content_size:
        raise ZstdError("frame content size differs from its header")
    if checksum:
        if pos + 4 > n:
            raise ZstdError("content checksum truncated")
        want = struct.unpack_from("<I", data, pos)[0]
        if xxh64(bytes(out[start:])) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return pos


def decompress(data: bytes) -> bytes:
    """Every frame of `data` decoded and joined (skippable frames skipped)."""
    data = bytes(data)
    out = bytearray()
    pos, n = 0, len(data)
    if n == 0:
        raise ZstdError("no zstd frame in empty input")
    while pos < n:
        if pos + 4 > n:
            raise ZstdError("trailing bytes after the last frame")
        magic = struct.unpack_from("<I", data, pos)[0]
        if magic & SKIPPABLE_MASK == SKIPPABLE_MAGIC:
            if pos + 8 > n:
                raise ZstdError("skippable frame truncated")
            size = struct.unpack_from("<I", data, pos + 4)[0]
            if pos + 8 + size > n:
                raise ZstdError("skippable frame truncated")
            pos += 8 + size
            continue
        if magic != MAGIC:
            raise ZstdError(f"bad zstd magic {magic:#010x}")
        pos = _frame(data, pos + 4, out)
    return bytes(out)


# ------------------------------------------------- the C++ decoder's binding
NATIVE_ERRORS = {-1: "truncated", -2: "bad magic", -3: "reserved bit or block type",
                 -4: "frame needs a dictionary: no dictionary is supported",
                 -5: "output larger than its buffer", -6: "corrupt entropy table or bitstream",
                 -7: "match offset beyond the decoded data",
                 -8: "frame content size differs from its header",
                 -9: "content checksum mismatch", -10: "block larger than the frame allows"}


@functools.cache
def _native() -> ctypes.CDLL:
    from pixart_sigma_tpu_torch.ops import _build

    lib = _build.load("zstd_decode")
    lib.zstd_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                    ctypes.c_size_t]
    lib.zstd_decompress.restype = ctypes.c_long
    lib.crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.crc32c.restype = ctypes.c_uint32
    return lib


def _pointer(data) -> Tuple[np.ndarray, int]:
    arr = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
    if arr.dtype != np.uint8 or not arr.flags.c_contiguous:
        raise TypeError("expected contiguous bytes")
    return arr, arr.ctypes.data


def decompress_native(data, size: Optional[int] = None, limit: int = 1 << 34) -> np.ndarray:
    """`decompress` by the C++ decoder: the decoded bytes as a uint8 array.
    `size` is the decoded size when the caller knows it (a zarr chunk's),
    and then must be met exactly; otherwise the output buffer grows up to
    `limit` bytes. Raises `ZstdError` with the decoder's reason."""
    src, ptr = _pointer(data)
    cap = size if size is not None else max(4 * src.size, 1 << 16)
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        n = _native().zstd_decompress(ptr, src.size, out.ctypes.data, cap)
        if n == -5 and size is None and cap < limit:
            cap = min(2 * cap, limit)
            continue
        if n < 0:
            raise ZstdError(f"zstd: {NATIVE_ERRORS.get(n, n)}")
        if size is not None and n != size:
            raise ZstdError(f"zstd: decoded {n} bytes where {size} were expected")
        return out[:n]


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of `data`, by the C++ library."""
    src, ptr = _pointer(data)
    return int(_native().crc32c(ptr, src.size))
