// A Zstandard frame decoder (RFC 8878) and CRC-32C, host code with a plain C
// interface, for reading the JAX trainer's orbax checkpoints: every B-tree
// node of their OCDBT store and every zarr chunk is a zstd frame.
//
// The same decoder as utils/zstd.py, which is its reference: raw, RLE and
// compressed blocks; raw, RLE, Huffman and treeless literals in one or four
// streams, with direct or FSE-coded Huffman weights; predefined, RLE,
// FSE-coded and repeated sequence tables; the three repeat offsets;
// skippable frames; the content checksum (xxhash64's low 32 bits), verified
// when present. A frame that names a dictionary is refused. Every read is
// bounds-checked: a malformed frame returns a negative code and never reads
// or writes outside its buffers.
//
// Built with the host C++ compiler (ops/_build.py: c++ -std=c++17 -O2
// -shared -fPIC) and loaded with ctypes.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Error : long {
  kTruncated = -1,        // a header, block or section runs past its input
  kBadMagic = -2,         // not a zstd or skippable frame
  kReserved = -3,         // a reserved bit or block type is set
  kDictionary = -4,       // the frame names a dictionary
  kDstTooSmall = -5,      // the output does not fit the caller's buffer
  kCorrupt = -6,          // an entropy table or bitstream is malformed
  kBadOffset = -7,        // a match reaches before the frame's start or window
  kContentSize = -8,      // the decoded size differs from the frame header's
  kChecksum = -9,         // the content checksum does not match
  kBlockSize = -10,       // a block is larger than the frame allows
};

constexpr size_t kBlockMax = 1 << 17;

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Fail {
  long code;
};

inline void check(bool ok, long code) {
  if (!ok) throw Fail{code};
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ------------------------------------------------------------ xxhash64
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t load64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
inline uint32_t load32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t xround(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, load64(p));
      v2 = xround(v2, load64(p + 8));
      v3 = xround(v3, load64(p + 16));
      v4 = xround(v4, load64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, load64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(load32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ------------------------------------------------------------ bit readers
// A backward bitstream over s[0, len): read from the end, most significant
// first, after the padding above the last byte's highest set bit. `pos` is the
// number of bits left; bits before the start read as zeros.
struct BackBits {
  const uint8_t* s;
  int64_t len;
  int64_t pos;

  BackBits(const uint8_t* src, int64_t n) : s(src), len(n) {
    check(n > 0 && src[n - 1] != 0, kCorrupt);
    pos = (n - 1) * 8 + highbit(src[n - 1]);
  }

  inline uint64_t window(int64_t byte) const {  // 8 bytes from `byte`, zero past the end
    if (byte + 8 <= len) return load64(s + byte);
    uint64_t v = 0;
    for (int64_t i = byte; i < len; ++i) v |= uint64_t(s[i]) << (8 * (i - byte));
    return v;
  }

  inline uint32_t peek(int n) const {
    if (n == 0) return 0;
    int64_t p = pos - n;
    if (p >= 0) return uint32_t((window(p >> 3) >> (p & 7)) & ((1ULL << n) - 1));
    if (pos <= 0) return 0;
    uint64_t have = window(0) & ((1ULL << pos) - 1);
    return uint32_t(have << (-p));
  }

  inline uint32_t read(int n) {
    uint32_t v = peek(n);
    pos -= n;
    return v;
  }
};

// Little-endian bits, least significant first (the FSE table descriptions).
struct FwdBits {
  const uint8_t* s;
  int64_t len;
  int64_t bit = 0;

  uint32_t peek(int n) const {
    int64_t byte = bit >> 3;
    uint64_t v = 0;
    for (int64_t i = byte; i < len && i < byte + 5; ++i) v |= uint64_t(s[i]) << (8 * (i - byte));
    return uint32_t((v >> (bit & 7)) & ((1ULL << n) - 1));
  }
  void skip(int n) {
    bit += n;
    check(((bit + 7) >> 3) <= len, kCorrupt);
  }
};

// ------------------------------------------------------------ FSE
struct FseTable {
  int log = 0;
  std::vector<uint8_t> symbol, nbits;
  std::vector<uint16_t> base;

  void build(const int16_t* counts, int nsym, int accuracy) {
    int size = 1 << accuracy, high = size - 1;
    log = accuracy;
    symbol.assign(size, 0);
    nbits.assign(size, 0);
    base.assign(size, 0);
    uint32_t next[256];
    for (int s = 0; s < nsym; ++s) {
      if (counts[s] == -1) {
        symbol[high--] = uint8_t(s);
        next[s] = 1;
      } else {
        next[s] = uint32_t(counts[s]);
      }
    }
    int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
    for (int s = 0; s < nsym; ++s) {
      for (int i = 0; i < counts[s]; ++i) {
        symbol[pos] = uint8_t(s);
        do pos = (pos + step) & mask; while (pos > high);
      }
    }
    check(pos == 0, kCorrupt);
    for (int u = 0; u < size; ++u) {
      uint32_t n = next[symbol[u]]++;
      nbits[u] = uint8_t(accuracy - highbit(n));
      base[u] = uint16_t((n << nbits[u]) - size);
    }
  }

  void rle(uint8_t s) {
    log = 0;
    symbol.assign(1, s);
    nbits.assign(1, 0);
    base.assign(1, 0);
  }
};

// An FSE table description at s[0, len) -> counts; returns the bytes read.
int64_t read_fse_counts(const uint8_t* s, int64_t len, int max_symbol, int max_log,
                        int16_t* counts, int* nsym, int* accuracy) {
  check(len > 0, kCorrupt);
  FwdBits bits{s, len};
  int log = int(bits.peek(4)) + 5;
  bits.skip(4);
  check(log <= max_log, kCorrupt);
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1, n = 0;
  while (remaining > 1) {
    check(n <= max_symbol, kCorrupt);
    int big = 2 * threshold - 1 - remaining;
    int v = int(bits.peek(nb));
    if ((v & (threshold - 1)) < big) {
      v &= threshold - 1;
      bits.skip(nb - 1);
    } else {
      if (v >= threshold) v -= big;
      bits.skip(nb);
    }
    int count = v - 1;
    remaining -= count < 0 ? -count : count;
    counts[n++] = int16_t(count);
    if (count == 0) {
      for (;;) {
        int rep = int(bits.peek(2));
        bits.skip(2);
        check(n + rep <= max_symbol + 1, kCorrupt);
        for (int i = 0; i < rep; ++i) counts[n++] = 0;
        if (rep != 3) break;
      }
    }
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  check(remaining == 1 && n <= max_symbol + 1, kCorrupt);
  *nsym = n;
  *accuracy = log;
  return (bits.bit + 7) >> 3;
}

// ------------------------------------------------------------ Huffman
struct Huffman {
  int max_bits = 0;
  std::vector<uint8_t> symbol, nbits;

  void build(const uint8_t* weights, int n) {  // n weights; the last is implied
    uint32_t total = 0;
    for (int i = 0; i < n; ++i) {
      check(weights[i] <= 12, kCorrupt);
      if (weights[i]) total += 1u << (weights[i] - 1);
    }
    check(total > 0, kCorrupt);
    max_bits = highbit(total) + 1;
    uint32_t rest = (1u << max_bits) - total;
    check((rest & (rest - 1)) == 0 && max_bits <= 11, kCorrupt);
    uint8_t w_all[256];
    std::memcpy(w_all, weights, n);
    w_all[n] = uint8_t(highbit(rest) + 1);
    int count[13] = {0};
    for (int i = 0; i <= n; ++i) count[w_all[i]]++;
    uint32_t start[13] = {0}, pos = 0;
    for (int w = 1; w <= max_bits; ++w) {
      start[w] = pos;
      pos += uint32_t(count[w]) << (w - 1);
    }
    symbol.assign(size_t(1) << max_bits, 0);
    nbits.assign(size_t(1) << max_bits, 0);
    for (int s = 0; s <= n; ++s) {
      int w = w_all[s];
      if (!w) continue;
      uint32_t k = 1u << (w - 1);
      std::memset(&symbol[start[w]], s, k);
      std::memset(&nbits[start[w]], max_bits + 1 - w, k);
      start[w] += k;
    }
  }

  void decode(const uint8_t* s, int64_t len, size_t n, uint8_t* out) const {
    BackBits bits(s, len);
    const uint8_t* sym = symbol.data();
    const uint8_t* nb = nbits.data();
    const uint64_t mask = (1ULL << max_bits) - 1;
    size_t i = 0;
    // While 64 bits lie below the read position, load 8 bytes once and take
    // symbols from them until fewer than max_bits are left above their start.
    while (i < n && bits.pos >= 64) {
      int64_t base = (bits.pos - 57) & ~int64_t(7);
      uint64_t v = load64(s + (base >> 3));
      int64_t avail = bits.pos - base;  // 57..64
      while (avail >= max_bits && i < n) {
        uint32_t idx = uint32_t((v >> (avail - max_bits)) & mask);
        out[i++] = sym[idx];
        avail -= nb[idx];
      }
      bits.pos = base + avail;
    }
    for (; i < n; ++i) {
      uint32_t v = bits.peek(max_bits);
      out[i] = sym[v];
      bits.pos -= nb[v];
    }
    check(bits.pos == 0, kCorrupt);
  }
};

// The Huffman tree description at s[0, len): fills the table, returns the bytes read.
int64_t read_huffman(const uint8_t* s, int64_t len, Huffman* huf) {
  check(len >= 1, kCorrupt);
  uint8_t weights[256];
  int n = 0;
  int head = s[0];
  if (head >= 128) {
    n = head - 127;
    int64_t size = (n + 1) / 2;
    check(1 + size <= len, kCorrupt);
    for (int i = 0; i < n; ++i) weights[i] = (s[1 + i / 2] >> ((i & 1) ? 0 : 4)) & 15;
    huf->build(weights, n);
    return 1 + size;
  }
  check(head > 0 && 1 + head <= len, kCorrupt);
  int16_t counts[256];
  int nsym, log;
  int64_t used = read_fse_counts(s + 1, head, 255, 6, counts, &nsym, &log);
  FseTable t;
  t.build(counts, nsym, log);
  check(used < head, kCorrupt);
  BackBits bits(s + 1 + used, head - used);
  uint32_t st[2];
  st[0] = bits.read(log);
  st[1] = bits.read(log);
  for (int turn = 0;; turn ^= 1) {
    check(n < 255, kCorrupt);
    weights[n++] = t.symbol[st[turn]];
    st[turn] = t.base[st[turn]] + bits.read(t.nbits[st[turn]]);
    if (bits.pos < 0) {
      check(n < 255, kCorrupt);
      weights[n++] = t.symbol[st[turn ^ 1]];
      break;
    }
  }
  huf->build(weights, n);
  return 1 + head;
}

// ------------------------------------------------------------ frames
struct Frame {
  uint64_t window = 0;
  bool have_huffman = false;
  Huffman huffman;
  FseTable tables[3];  // LL, OF, ML
  bool have_table[3] = {false, false, false};
  size_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lits;
};

const FseTable& default_table(int which) {
  static const std::vector<FseTable> tables = [] {
    std::vector<FseTable> t(3);
    t[0].build(kLLDefault, 36, 6);
    t[1].build(kOFDefault, 29, 5);
    t[2].build(kMLDefault, 53, 6);
    return t;
  }();
  return tables[which];
}

// The literals section at s[0, len) into f.lits; returns its size.
int64_t read_literals(const uint8_t* s, int64_t len, Frame& f) {
  check(len >= 1, kTruncated);
  int kind = s[0] & 3, fmt = (s[0] >> 2) & 3;
  if (kind < 2) {
    static const int heads[4] = {1, 2, 1, 3};
    int head = heads[fmt];
    check(head <= len, kTruncated);
    uint32_t h = 0;
    for (int i = 0; i < head; ++i) h |= uint32_t(s[i]) << (8 * i);
    size_t size = head == 1 ? h >> 3 : h >> 4;
    if (kind == 0) {
      check(int64_t(head + size) <= len, kTruncated);
      f.lits.assign(s + head, s + head + size);
      return head + int64_t(size);
    }
    check(head + 1 <= len, kTruncated);
    f.lits.assign(size, s[head]);
    return head + 1;
  }
  static const int heads[4] = {3, 3, 4, 5}, widths[4] = {10, 10, 14, 18};
  int head = heads[fmt], w = widths[fmt];
  check(head <= len, kTruncated);
  uint64_t h = 0;
  for (int i = 0; i < head; ++i) h |= uint64_t(s[i]) << (8 * i);
  size_t regen = (h >> 4) & ((1u << w) - 1);
  int64_t comp = int64_t((h >> (4 + w)) & ((1u << w) - 1));
  check(head + comp <= len && regen <= kBlockMax, kTruncated);
  const uint8_t* p = s + head;
  const uint8_t* end = p + comp;
  if (kind == 2) {
    p += read_huffman(p, end - p, &f.huffman);
    f.have_huffman = true;
  }
  check(f.have_huffman, kCorrupt);
  f.lits.resize(regen);
  if (fmt == 0) {
    f.huffman.decode(p, end - p, regen, f.lits.data());
  } else {
    check(end - p >= 6, kCorrupt);
    int64_t sizes[4] = {p[0] | (p[1] << 8), p[2] | (p[3] << 8), p[4] | (p[5] << 8), 0};
    p += 6;
    sizes[3] = (end - p) - sizes[0] - sizes[1] - sizes[2];
    check(sizes[3] >= 0, kCorrupt);
    size_t each = (regen + 3) / 4;
    check(3 * each <= regen, kCorrupt);
    size_t counts[4] = {each, each, each, regen - 3 * each};
    uint8_t* out = f.lits.data();
    for (int i = 0; i < 4; ++i) {
      f.huffman.decode(p, sizes[i], counts[i], out);
      p += sizes[i];
      out += counts[i];
    }
  }
  return head + comp;
}

int64_t read_table(const uint8_t* s, int64_t len, int mode, int which, Frame& f) {
  static const int max_symbol[3] = {35, 31, 52}, max_log[3] = {9, 8, 9};
  if (mode == 0) {
    f.tables[which] = default_table(which);
  } else if (mode == 1) {
    check(len >= 1 && s[0] <= max_symbol[which], kCorrupt);
    f.tables[which].rle(s[0]);
    f.have_table[which] = true;
    return 1;
  } else if (mode == 2) {
    int16_t counts[64];
    int nsym, log;
    int64_t used = read_fse_counts(s, len, max_symbol[which], max_log[which], counts, &nsym, &log);
    f.tables[which].build(counts, nsym, log);
    f.have_table[which] = true;
    return used;
  } else {
    check(f.have_table[which], kCorrupt);
  }
  f.have_table[which] = true;
  return 0;
}

// One compressed block at s[0, len), appended to dst[*op, cap); `frame` is
// where this frame's output starts.
void decode_block(const uint8_t* s, int64_t len, Frame& f, uint8_t* dst, size_t cap, size_t* op,
                  size_t frame) {
  check(len >= 1, kCorrupt);
  int64_t pos = read_literals(s, len, f);
  check(pos < len, kTruncated);
  int b0 = s[pos];
  size_t nseq;
  if (b0 == 0) {
    check(pos + 1 == len, kCorrupt);
    nseq = 0;
  } else if (b0 < 128) {
    nseq = b0;
    pos += 1;
  } else if (b0 < 255) {
    check(pos + 2 <= len, kTruncated);
    nseq = (size_t(b0 - 128) << 8) + s[pos + 1];
    pos += 2;
  } else {
    check(pos + 3 <= len, kTruncated);
    nseq = s[pos + 1] + (size_t(s[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  const uint8_t* lits = f.lits.data();
  size_t nlits = f.lits.size(), lp = 0, o = *op;
  if (nseq) {
    check(pos < len, kTruncated);
    int modes = s[pos++];
    check((modes & 3) == 0, kReserved);
    pos += read_table(s + pos, len - pos, (modes >> 6) & 3, 0, f);
    pos += read_table(s + pos, len - pos, (modes >> 4) & 3, 1, f);
    pos += read_table(s + pos, len - pos, (modes >> 2) & 3, 2, f);
    const FseTable &llt = f.tables[0], &oft = f.tables[1], &mlt = f.tables[2];
    BackBits bits(s + pos, len - pos);
    uint32_t ll = bits.read(llt.log), of = bits.read(oft.log), ml = bits.read(mlt.log);
    size_t* rep = f.rep;
    for (size_t i = 0; i < nseq; ++i) {
      int of_code = oft.symbol[of], ml_code = mlt.symbol[ml], ll_code = llt.symbol[ll];
      check(of_code <= 31 && ml_code <= 52 && ll_code <= 35, kCorrupt);
      size_t ov = (size_t(1) << of_code) + bits.read(of_code);
      size_t mlen = kMLBase[ml_code] + bits.read(kMLBits[ml_code]);
      size_t llen = kLLBase[ll_code] + bits.read(kLLBits[ll_code]);
      size_t off;
      if (ov > 3) {
        off = ov - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      } else {
        size_t idx = llen ? ov - 1 : ov;
        if (idx == 0) {
          off = rep[0];
        } else {
          off = idx < 3 ? rep[idx] : rep[0] - 1;
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = off;
        }
      }
      if (i + 1 < nseq) {
        ll = llt.base[ll] + bits.read(llt.nbits[ll]);
        ml = mlt.base[ml] + bits.read(mlt.nbits[ml]);
        of = oft.base[of] + bits.read(oft.nbits[of]);
      }
      check(lp + llen <= nlits, kCorrupt);
      check(o + llen + mlen <= cap, kDstTooSmall);
      std::memcpy(dst + o, lits + lp, llen);
      o += llen;
      lp += llen;
      check(off != 0 && off <= o - frame && off <= f.window, kBadOffset);
      uint8_t* d = dst + o;
      const uint8_t* src = d - off;
      if (off >= mlen) {
        std::memcpy(d, src, mlen);
      } else {
        for (size_t k = 0; k < mlen; ++k) d[k] = src[k];
      }
      o += mlen;
    }
    check(bits.pos == 0, kCorrupt);
  }
  check(o + (nlits - lp) <= cap, kDstTooSmall);
  std::memcpy(dst + o, lits + lp, nlits - lp);
  o += nlits - lp;
  check(o - *op <= kBlockMax, kBlockSize);
  *op = o;
}

// The frame whose header starts at s[0] (after the magic); returns its size.
int64_t decode_frame(const uint8_t* s, int64_t n, uint8_t* dst, size_t cap, size_t* op) {
  check(n >= 1, kTruncated);
  int fhd = s[0];
  int64_t pos = 1;
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
  check((fhd & 8) == 0, kReserved);
  Frame f;
  if (!single) {
    check(pos < n, kTruncated);
    int wd = s[pos++];
    int log = 10 + (wd >> 3);
    check(log <= 41, kCorrupt);
    f.window = (uint64_t(1) << log) + ((uint64_t(1) << log) >> 3) * (wd & 7);
  }
  static const int did_sizes[4] = {0, 1, 2, 4};
  int did_size = did_sizes[did_flag];
  check(pos + did_size <= n, kTruncated);
  uint32_t did = 0;
  for (int i = 0; i < did_size; ++i) did |= uint32_t(s[pos + i]) << (8 * i);
  pos += did_size;
  check(did == 0, kDictionary);
  static const int fcs_sizes[4] = {0, 2, 4, 8};
  int fcs_size = fcs_flag == 0 ? single : fcs_sizes[fcs_flag];
  check(pos + fcs_size <= n, kTruncated);
  bool have_size = fcs_size > 0;
  uint64_t content = 0;
  for (int i = 0; i < fcs_size; ++i) content |= uint64_t(s[pos + i]) << (8 * i);
  if (fcs_size == 2) content += 256;
  pos += fcs_size;
  if (single) f.window = content;
  size_t start = *op;
  uint64_t block_max = f.window < kBlockMax ? f.window : kBlockMax;
  for (;;) {
    check(pos + 3 <= n, kTruncated);
    uint32_t h = s[pos] | (s[pos + 1] << 8) | (uint32_t(s[pos + 2]) << 16);
    pos += 3;
    int last = h & 1, kind = (h >> 1) & 3;
    size_t size = h >> 3;
    check(kind != 3, kReserved);
    check(size <= block_max, kBlockSize);
    if (kind == 0) {
      check(pos + int64_t(size) <= n, kTruncated);
      check(*op + size <= cap, kDstTooSmall);
      std::memcpy(dst + *op, s + pos, size);
      *op += size;
      pos += size;
    } else if (kind == 1) {
      check(pos + 1 <= n, kTruncated);
      check(*op + size <= cap, kDstTooSmall);
      std::memset(dst + *op, s[pos], size);
      *op += size;
      pos += 1;
    } else {
      check(pos + int64_t(size) <= n, kTruncated);
      size_t before = *op;
      decode_block(s + pos, int64_t(size), f, dst, cap, op, start);
      check(*op - before <= block_max, kBlockSize);
      pos += size;
    }
    if (last) break;
  }
  check(!have_size || *op - start == content, kContentSize);
  if (checksum) {
    check(pos + 4 <= n, kTruncated);
    uint32_t want = load32(s + pos);
    check(uint32_t(xxh64(dst + start, *op - start)) == want, kChecksum);
    pos += 4;
  }
  return pos;
}

uint32_t crc32c_table[8][256];

void init_crc32c() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
    crc32c_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      crc32c_table[t][i] = (crc32c_table[t - 1][i] >> 8) ^ crc32c_table[0][crc32c_table[t - 1][i] & 0xFF];
}

}  // namespace

extern "C" {

// Decode every frame of src[0, n) (skippable frames skipped) into dst[0,
// cap). Returns the decoded size, or a negative error code (see Error).
long zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  size_t op = 0;
  try {
    int64_t pos = 0, len = int64_t(n);
    check(len > 0, kTruncated);
    while (pos < len) {
      check(pos + 4 <= len, kTruncated);
      uint32_t magic = load32(src + pos);
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        check(pos + 8 <= len, kTruncated);
        int64_t size = load32(src + pos + 4);
        check(pos + 8 + size <= len, kTruncated);
        pos += 8 + size;
        continue;
      }
      check(magic == 0xFD2FB528u, kBadMagic);
      pos += 4;
      pos += decode_frame(src + pos, len - pos, dst, cap, &op);
    }
  } catch (const Fail& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kCorrupt;
  }
  return long(op);
}

// xxhash64 with seed 0 (the content checksum's hash).
uint64_t zstd_xxh64(const uint8_t* src, size_t n) { return xxh64(src, n); }

// CRC-32C (Castagnoli), as OCDBT's manifests and B-tree nodes carry it.
uint32_t crc32c(const uint8_t* p, size_t n) {
  static bool ready = (init_crc32c(), true);
  (void)ready;
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo = load32(p) ^ c, hi = load32(p + 4);
    c = crc32c_table[7][lo & 0xFF] ^ crc32c_table[6][(lo >> 8) & 0xFF] ^
        crc32c_table[5][(lo >> 16) & 0xFF] ^ crc32c_table[4][lo >> 24] ^
        crc32c_table[3][hi & 0xFF] ^ crc32c_table[2][(hi >> 8) & 0xFF] ^
        crc32c_table[1][(hi >> 16) & 0xFF] ^ crc32c_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ crc32c_table[0][(c ^ *p++) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
