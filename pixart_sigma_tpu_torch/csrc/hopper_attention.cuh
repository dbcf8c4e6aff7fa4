// The streamed attention forward that onepass_attention.cu and
// flash_forward.cu share, and its caption cross-attention mode, which
// cross_attention.cu runs for allheads and headsmajor, written for
// Hopper (sm_90a): wgmma for both products, TMA/mbarrier rings for Q and
// K/V, and the softmax of one warpgroup overlapped with the tensor-core work
// of the other.
//
// A persistent grid: one block of three warpgroups per SM walks work items
// (128 query rows, batch * head) in runs of one batch * head (Work):
// - warpgroup 2 is the producer. It gives its registers to the consumers
//   (setmaxnreg), and its first warp loads each item's Q into a ring of Q
//   buffers and its K/V tiles of 128 keys into a ring of K/V stages with TMA
//   (cp.async.bulk.tensor); lane 0 issues the copies. Each stage and each Q
//   buffer has a "full" mbarrier, which the copies' bytes complete, and an
//   "empty" one, on which the consumers release it. No thread computes a
//   copy address.
// - warpgroups 0 and 1 are the consumers, 64 query rows each. S = Q.K^T is
//   wgmma m64n128k16 with Q and K read from shared memory (both K-major);
//   the probabilities, rounded to bf16, stay in registers as the A operand
//   of O += P.V (wgmma m64n80k16, V read MN-major through the transpose
//   bit). Iteration j issues S of tile j and P.V of tile j - 1
//   together, then runs tile j's softmax while that P.V is still in flight.
//   Two named barriers make the consumers take turns to issue their wgmma
//   (ping-pong), so one warpgroup's exponentials overlap the other's
//   products. The key loop has no __syncthreads.
//
// Self-attention (kCross false): block i takes the items i, i + gridDim.x,
// ..., query tiles fastest, so the blocks in flight share one head's K/V in
// the 50 MB L2; Q is double-buffered and every item streams all its K/V
// tiles through a ring of three stages.
//
// Caption cross-attention (kCross true): each block takes one (batch, head)
// and a share of its query tiles, the shares of all heads side by side, so
// the blocks in flight read the same q rows for every head at once (a head
// is 144 of a row's 2304 bytes at the path's width, and heads read at
// different rows scatter the reads over DRAM). At the start of a run
// every warp finds the batch element's key extent from its row of the
// [B, M] byte mask (key_tiles: the last valid key, plus one, in whole
// tiles; all M keys when none is valid). Tiles past it are never loaded or
// multiplied: there every row with a valid key has p = exp2(-1e30 - m) = 0
// exactly. The producer warp writes each tile's biases into shared memory
// from the same row (write_tile_bias), so for a bool mask the wrapper
// launches nothing but the kernel. When the extent fits the two K/V stages
// it stays resident for the whole run and is released at its end; a longer
// one streams through the two stages for every item. The Q ring is five buffers deep, so the
// producer keeps up to 100 KB of Q in flight, and a bf16 output leaves by
// TMA store from the item's own Q buffer (the consumers write O there,
// swizzled as Q arrived, once their Q.K^T is done; the buffer is released
// one item later, when the store has read it), so no consumer waits on
// device memory. On these one-tile key loops the consumers do not take
// turns (kPingPong).
//
// The head dim (a multiple of 8 up to 128) is split in two column chunks,
// as a 128-byte TMA swizzle row holds 64 bf16, and runs at one of three
// padded widths (hopper_common.cuh): columns [0, 64) in 128-byte rows with
// the 128B swizzle; for V (MN-major, whose swizzle atom is 64 columns wide)
// columns [64, 128) as a second 128B atom, so P.V is one N = 80 (or 128)
// product per 16 keys. For Q and K (K-major), at width 80 columns [64, 80)
// in 32-byte rows with the 32B swizzle, so Q.K^T runs 4 + 1 k-steps of 16;
// at width 128 columns [64, 128) as a second 128B atom, 4 + 4 k-steps. At
// width 64 the second chunks are skipped. TMA zero-fills the columns past
// dh and the rows past N or M, so the padding never reaches device memory,
// and clips a stored box to the same bounds. Widths 64 and 80 share one
// shared-memory layout (Ring<kCross, false>); width 128's K/V stage is
// 64 KB, so its self-attention ring holds three stages beside one Q buffer
// and its cross mode's two stages beside three Q buffers (Ring<kCross,
// true>).
//
// The softmax runs in f32 in log2 units: one FFMA folds the logit scale and
// the running max into each exponent (exp2(s * scale - m)). With a key mask
// the bias is added first (s * scale + bias): the wrapper pads the bias rows
// to whole tiles with -inf, and the producer copies each tile's 128 biases
// into shared memory beside its K/V (the cross mode writes them there from
// the byte mask), so the consumers test no bounds.
// Without one, keys past M get the logit -inf in the last tile. `tail`
// padded keys at logit -1e30 join each row's denominator at the end, as the
// TPU kernels pad K/V.
#pragma once

#include <algorithm>
#include <cstdint>
#include <limits>
#include <type_traits>

#include "hopper_common.cuh"

namespace hopper {

constexpr int kRows = 128;     // query rows per item: two consumer warpgroups x 64
constexpr int kKeys = 128;     // keys per tile, the wgmma N of S = Q.K^T
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kMainTile = kKeys * kMainCols * 2;  // 16384 B
constexpr int kTailTile = kKeys * kTailCols * 2;  // 4096 B
static_assert(kRows == kKeys, "Q and K/V chunks share one TMA box");
// One stage (each part 1024-byte aligned): K main, V main, V columns
// [64, 128) as a second 128B-swizzled atom right after V main (TMA
// zero-fills the columns past dh), so that one wgmma of N = 80 or 128
// reads both, and K's columns past 64 (a 32B-swizzled tail at width 80, a
// second 128B atom at width 128).
constexpr int kVOff = kMainTile, kVTailOff = 2 * kMainTile, kKTailOff = 3 * kMainTile;
constexpr int kBiasBytes = kKeys * 4;
constexpr int kCrossMaxKeys = 512;   // caption keys the cross mode takes

// The block's shared memory: the Q buffers (main, then the columns past
// 64), the K/V stages, each stage's 128 mask biases, then the barriers
// full[stages], empty[stages], qfull[qbufs] and qempty[qbufs]; 1024 bytes
// of slack to align the base. kWide: width 128, else widths 64 and 80.
template <bool kCross, bool kWide>
struct Ring {
  static constexpr int hi_bytes = kWide ? kMainTile : kTailTile;  // Q or K columns past 64
  static constexpr int stage_bytes = 3 * kMainTile + hi_bytes;
  static constexpr int q_bytes = kMainTile + hi_bytes;
  // K/V tiles in flight (cross: resident)
  static constexpr int stages = kCross ? 2 : 3;
  static constexpr int qbufs = kCross ? (kWide ? 3 : 5) : (kWide ? 1 : 2);
  static constexpr int stages_offset = qbufs * q_bytes;
  static constexpr int bias_offset = stages_offset + stages * stage_bytes;
  static constexpr int bar_offset = bias_offset + stages * kBiasBytes;
  static constexpr int smem_bytes = bar_offset + (2 * stages + 2 * qbufs) * 8 + 1024;
  static_assert(smem_bytes <= 232448, "more shared memory than a block may use");

  __device__ static uint32_t full(uint32_t base, int s) { return base + bar_offset + 8 * s; }
  __device__ static uint32_t empty(uint32_t base, int s) {
    return base + bar_offset + 8 * (stages + s);
  }
  __device__ static uint32_t qfull(uint32_t base, int i) {
    return base + bar_offset + 8 * (2 * stages + i);
  }
  __device__ static uint32_t qempty(uint32_t base, int i) {
    return base + bar_offset + 8 * (2 * stages + qbufs + i);
  }
};

// TMA descriptors of the bf16 [B, rows, H, dh] views: 64-column boxes with
// the 128B swizzle (the second chunk of V, and of every operand at width
// 128, is the same box at column 64), and 16-column boxes with the 32B
// swizzle for the tails of Q and K at width 80; for the output of the
// cross mode, the same boxes of 64 rows (one consumer's).
struct Maps {
  CUtensorMap q, q_tail, k, k_tail, v, o, o_tail;
};

struct Args {
  const float* madd;  // [B, pad128(M)] additive key mask (0 / -1e30; -inf past M) or null;
                      // null in the cross mode, which reads kmask
  void* o;            // [B, N, H, dh], bf16 or f32
  float* lse;         // [B * H, N] row logsumexp in log2 units, or null
  attn::Strides os;
  int B, H, N, M, dh;
  float scale;  // logit scale in log2 units
  float m0;     // the running max before any key
  int tail;     // padded keys at logit -1e30 that join each row's denominator
  int shares;   // cross mode: blocks that split one (batch, head)'s query tiles
  const unsigned char* kmask;  // cross mode: [B, M] key mask, a byte per key, nonzero = valid
  long long kmask_sb;          // its batch stride (bytes)
};

// The work: runs r = blockIdx.x, blockIdx.x + gridDim.x, ... < runs, each
// one (batch * head) bh and its query tiles [t0, t1). Self-attention: a run
// is one item, query tiles fastest, so the blocks in flight share a head's
// K/V in L2. Cross mode: run r is share r / BH of bh = r % BH, so the blocks
// in flight read the same rows of q for every head at once (a head is 144
// of the row's 2304 bytes at the path's width) and each keeps its head's
// K/V extent for all its tiles.
struct Work {
  int ntq, ntiles, runs, shares, BH;

  __device__ void run(int r, int& bh, int& t0, int& t1) const {
    if (shares == 0) {
      bh = r / ntq;
      t0 = r - bh * ntq;
      t1 = t0 + 1;
    } else {
      bh = r % BH;
      const int share = r / BH;
      t0 = share * ntq / shares;
      t1 = (share + 1) * ntq / shares;
    }
  }
};

__device__ __forceinline__ Work block_work(const Args& a) {
  const int ntq = (a.N + kRows - 1) / kRows;
  const int BH = a.B * a.H;
  return Work{ntq, (a.M + kKeys - 1) / kKeys, a.shares ? a.shares * BH : ntq * BH, a.shares, BH};
}

// K/V tiles that batch element b's rows need, found by the calling warp
// (all 32 lanes) from its key mask row (at most 512 bytes): the last valid
// key, plus one, in whole tiles. Past it every row with a valid key has
// p = exp2(-1e30 - m) = 0 exactly. With no valid key, all `ntiles`.
__device__ __forceinline__ int key_tiles(const Args& a, const Work& wk, int b) {
  // the row in 4-byte words from the aligned word that holds its first
  // byte, at most 129 words, up to five loads a lane issued together; the
  // bytes of a word outside [0, M) are skipped
  const uintptr_t start = reinterpret_cast<uintptr_t>(a.kmask + b * a.kmask_sb);
  const unsigned* w = reinterpret_cast<const unsigned*>(start & ~uintptr_t(3));
  const int off = static_cast<int>(start & 3);
  const int words = (off + a.M + 3) >> 2;
  const int lane = threadIdx.x & 31;
  int last = -1;
#pragma unroll
  for (int j = 0; j < (kCrossMaxKeys / 4 + 1 + 31) / 32; ++j) {
    const int i = 32 * j + lane;
    const unsigned x = i < words ? __ldg(w + i) : 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = 4 * i + c - off;
      if (((x >> (8 * c)) & 0xffu) && key >= 0 && key < a.M) last = key;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  return last < 0 ? wk.ntiles : last / kKeys + 1;
}

// Cross mode: the 128 biases of batch element b's key tile j, written into
// shared memory at `dst` by the calling warp, four keys a lane (coalesced):
// 0 for a valid key, -1e30 for a masked one, -inf past M.
__device__ __forceinline__ void write_tile_bias(uint32_t dst, const Args& a, int b, int j) {
  const int lane = threadIdx.x & 31;
  const unsigned char* row = a.kmask + b * a.kmask_sb;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = j * kKeys + 32 * e + lane;
    const float x = key >= a.M ? -CUDART_INF_F : (__ldg(row + key) ? 0.f : attn::kMaskedLogit);
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(dst + 4 * (32 * e + lane)), "f"(x) : "memory");
  }
}

// Accumulator layout of wgmma m64nN (per warp w of the warpgroup, lane =
// 4 g + t): d[4 c + e] holds row 16 w + g (e < 2) or 16 w + g + 8 (e >= 2),
// column 8 c + 2 t + (e & 1). Two 8-column chunks of S are one 16-key A
// fragment of P, so P never leaves registers.

// The consumer warpgroup `wg` (0 or 1): its 64 query rows of each item
// against the item's keys, at width W: 64 (columns [0, 64)), 80 (also the
// 32B-swizzled columns [64, 80)) or 128 (also the atom of columns [64, 128)).
template <typename TOut, bool kMask, int W, bool kCross>
__device__ __forceinline__ void consume(const Maps& maps, const Args& a, uint32_t base, int wg,
                                        const Work& wk) {
  constexpr bool kTail = W == 80, kWide = W == 128;
  constexpr int kAcc = acc_regs(W), kChunks = kAcc / 4;  // 8-column chunks of O
  using R = Ring<kCross, kWide>;
  // a bf16 output of the cross mode leaves by TMA store from the Q buffer
  constexpr bool kTmaStore = kCross && std::is_same<TOut, attn::bf16>::value;
  // the consumers take turns on the tensor cores along long key loops; on
  // the cross mode's short ones the turns would chain each warpgroup's
  // epilogue to the other's next products
  constexpr bool kPingPong = !kCross;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // ring position `it` + tile j of the current item
  int it = 0;
  auto slot = [&](int j) { return (it + j) % R::stages; };
  auto stage = [&](int j) { return base + R::stages_offset + slot(j) * R::stage_bytes; };

  float s[64], o[kAcc];
  uint32_t p[8][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0u;
  float m_0, m_1, l_0, l_1;
  uint64_t dq, dq_tail;  // Q columns [0, 64) and past 64
  const float sc = kMask ? 1.f : a.scale;  // the scale left after the mask step

  // Tile j has arrived and it is this warpgroup's turn on the tensor cores.
  auto acquire = [&](int j) {
    mbar_wait(R::full(base, slot(j)), ((it + j) / R::stages) & 1);
    if (kPingPong) bar_sync(1 + wg);
    wgmma_fence();
  };
  // The other consumer's turn; lane 0 of each warp releases tile j's stage.
  auto pass_turn = [&]() {
    if (kPingPong) bar_arrive(2 - wg);
  };
  auto release = [&](int j) {
    if (lane == 0) mbar_arrive(R::empty(base, slot(j)));
  };
  // S = Q.K^T of tile j, one commit group.
  auto issue_s = [&](int j) {
    const uint32_t st = stage(j);
    const uint64_t dk = smem_desc(st, 1024, kSwizzle128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    if (kTail) wgmma_ss_n128(s, dq_tail, smem_desc(st + kKTailOff, 256, kSwizzle32), 1);
    if (kWide) {
      const uint64_t dk_hi = smem_desc(st + kKTailOff, 1024, kSwizzle128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128(s, dq_tail + 2 * kk, dk_hi + 2 * kk, 1);
    }
    wgmma_commit();
  };
  // O += P.V of tile j (P of that tile in p), one commit group: a k-step
  // is 16 key rows of 128 bytes in each of V's two atoms.
  auto issue_pv = [&](int j) {
    const uint64_t dv = smem_desc(stage(j) + kVOff, 1024, kSwizzle128, kVTailOff - kVOff);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_rs_mn<W>(o, p[kk], dv + kk * (16 * 128 / 16));
    wgmma_commit();
  };
  // Tile j's softmax on its logits in s: the new row max mn and, in s,
  // p = exp2(logit - mn), with their row sums ls (this thread's share).
  auto softmax = [&](int j, float& mn0, float& mn1, float& ls0, float& ls1) {
    const int key0 = j * kKeys;
    if (kMask) {  // the tile's biases, -inf past M, arrived with its K/V
      const uint32_t bias = base + R::bias_offset + slot(j) * kBiasBytes + 8 * t;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float b0, b1;
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                     : "=f"(b0), "=f"(b1)
                     : "r"(bias + 32 * c));
        s[4 * c] = fmaf(s[4 * c], a.scale, b0);
        s[4 * c + 1] = fmaf(s[4 * c + 1], a.scale, b1);
        s[4 * c + 2] = fmaf(s[4 * c + 2], a.scale, b0);
        s[4 * c + 3] = fmaf(s[4 * c + 3], a.scale, b1);
      }
    } else if (key0 + kKeys > a.M) {  // the last tile: keys past M
#pragma unroll
      for (int c = 0; c < 16; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (key0 + 8 * c + 2 * t + e >= a.M) {
            s[4 * c + e] = -CUDART_INF_F;
            s[4 * c + 2 + e] = -CUDART_INF_F;
          }
        }
      }
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * c], s[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key0 < M, so the max is finite from the first tile on
    mn0 = fmaxf(m_0, mx0 * sc);
    mn1 = fmaxf(m_1, mx1 * sc);
    const float nb0 = -mn0, nb1 = -mn1;
    ls0 = ls1 = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      s[4 * c] = attn::fast_exp2(fmaf(s[4 * c], sc, nb0));
      s[4 * c + 1] = attn::fast_exp2(fmaf(s[4 * c + 1], sc, nb0));
      s[4 * c + 2] = attn::fast_exp2(fmaf(s[4 * c + 2], sc, nb1));
      s[4 * c + 3] = attn::fast_exp2(fmaf(s[4 * c + 3], sc, nb1));
      ls0 += s[4 * c] + s[4 * c + 1];
      ls1 += s[4 * c + 2] + s[4 * c + 3];
    }
  };
  // The accumulator and denominator move to the new max; P, rounded to
  // bf16, becomes the A operand of the next P.V.
  auto rescale_pack = [&](float mn0, float mn1, float ls0, float ls1) {
    const float a0 = attn::fast_exp2(m_0 - mn0), a1 = attn::fast_exp2(m_1 - mn1);
    m_0 = mn0;
    m_1 = mn1;
    l_0 = l_0 * a0 + ls0;
    l_1 = l_1 * a1 + ls1;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      o[4 * c] *= a0;
      o[4 * c + 1] *= a0;
      o[4 * c + 2] *= a1;
      o[4 * c + 3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      p[kk][0] = attn::pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = attn::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = attn::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = attn::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  if (wg == 1) pass_turn();  // warpgroup 0 issues first (ping-pong)
  int n = 0;                 // items done by this block
  int ntiles = wk.ntiles;    // K/V tiles of the current run
  bool resident = false;     // its tiles stay in their stages for the whole run
  for (int r = blockIdx.x; r < wk.runs; r += gridDim.x) {
    int bh, t0, t1;
    wk.run(r, bh, t0, t1);
    const int b = bh / a.H, h = bh - b * a.H;
    if (kCross) {
      ntiles = key_tiles(a, wk, b);
      resident = ntiles <= R::stages;
    }
    for (int tq = t0; tq < t1; ++tq, ++n) {
      const int q0 = tq * kRows;
      // the run's last item releases the resident tiles; otherwise each tile
      // is released once its P.V is done
      const bool last_of_run = !resident || tq + 1 == t1;
      const int qi = n % R::qbufs;
      const uint32_t qbuf = base + qi * R::q_bytes;
      dq = smem_desc(qbuf + wg * (kMainTile / 2), 1024, kSwizzle128);
      dq_tail = kWide ? smem_desc(qbuf + kMainTile + wg * (kMainTile / 2), 1024, kSwizzle128)
                      : smem_desc(qbuf + kMainTile + wg * (kTailTile / 2), 256, kSwizzle32);
      m_0 = m_1 = a.m0;
      l_0 = l_1 = 0.f;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
      mbar_wait(R::qfull(base, qi), (n / R::qbufs) & 1);  // this item's Q

      float mn0, mn1, ls0, ls1;
      acquire(0);
      issue_s(0);
      pass_turn();
      wgmma_wait<0>();
      hold(s);
      softmax(0, mn0, mn1, ls0, ls1);
      rescale_pack(mn0, mn1, ls0, ls1);
      for (int j = 1; j < ntiles; ++j) {
        // S of tile j and P.V of tile j - 1 go out together; tile j's
        // softmax runs while that P.V (and the other warpgroup's products)
        // are in flight
        acquire(j);
        issue_s(j);
        issue_pv(j - 1);
        pass_turn();
        wgmma_wait<1>();
        hold(s);
        softmax(j, mn0, mn1, ls0, ls1);
        wgmma_wait<0>();
        hold(o);
        hold(p);
        if (!resident) release(j - 1);
        rescale_pack(mn0, mn1, ls0, ls1);
      }
      if (kPingPong) bar_sync(1 + wg);
      wgmma_fence();
      issue_pv(ntiles - 1);
      pass_turn();
      wgmma_wait<0>();
      hold(o);
      if (!resident) {
        release(ntiles - 1);
      } else if (last_of_run) {
        for (int j = 0; j < ntiles; ++j) release(j);
      }
      if (!kTmaStore && lane == 0) mbar_arrive(R::qempty(base, qi));  // Q buffer free
      if (last_of_run) it += ntiles;

      // out = O / l and lse = m + log2(l) for rows below N; the `tail` padded
      // keys (logit -1e30, zero values) join the denominator first
      l_0 += __shfl_xor_sync(0xffffffffu, l_0, 1);
      l_0 += __shfl_xor_sync(0xffffffffu, l_0, 2);
      l_1 += __shfl_xor_sync(0xffffffffu, l_1, 1);
      l_1 += __shfl_xor_sync(0xffffffffu, l_1, 2);
      l_0 += static_cast<float>(a.tail) * attn::fast_exp2(attn::kMaskedLogit - m_0);
      l_1 += static_cast<float>(a.tail) * attn::fast_exp2(attn::kMaskedLogit - m_1);
      const float i0 = 1.f / l_0, i1 = 1.f / l_1;
      const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
      if (a.lse != nullptr && t == 0) {
        float* lse = a.lse + static_cast<long long>(bh) * a.N;
        if (r0 < a.N) lse[r0] = m_0 + log2f(l_0);
        if (r1 < a.N) lse[r1] = m_1 + log2f(l_1);
      }
      if constexpr (kTmaStore) {
        // O into this warpgroup's half of the Q buffer, whose Q.K^T is done,
        // in Q's swizzled layout: 16-byte chunk c of row r at c ^ (r & 7) in
        // the 128-byte rows, at c ^ ((r >> 2) & 1) in the 32-byte ones
        const uint32_t main = qbuf + wg * (kMainTile / 2);
        const uint32_t tail = kWide ? qbuf + kMainTile + wg * (kMainTile / 2)
                                    : qbuf + kMainTile + wg * (kTailTile / 2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lr = 16 * warp + g + 8 * e;  // row in this warpgroup's half
          const float inv = e ? i1 : i0;
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            if (c < 8 || W > 64) {
              const uint32_t v =
                  attn::pack_bf16(o[4 * c + 2 * e] * inv, o[4 * c + 2 * e + 1] * inv);
              const uint32_t at =
                  c < 8   ? main + lr * 128 + ((c ^ (lr & 7)) << 4)
                  : kWide ? tail + lr * 128 + (((c - 8) ^ (lr & 7)) << 4)
                          : tail + lr * 32 + (((c - 8) ^ ((lr >> 2) & 1)) << 4);
              st_shared(at + 4 * t, v);
            }
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_sync_warpgroup(wg);
        if (tid == 0) {
          const int row = q0 + 64 * wg;
          if (row < a.N) {
            tma_store(&maps.o, main, 0, h, row, b);
            if (kTail) tma_store(&maps.o_tail, tail, kMainCols, h, row, b);
            if (kWide) tma_store(&maps.o, tail, kMainCols, h, row, b);
          }
          // the previous item's store has read its buffer: release that one
          tma_store_commit_wait_read<1>();
          if (n > 0) mbar_arrive(R::qempty(base, (n - 1) % R::qbufs));
        }
      } else {
        TOut* out = static_cast<TOut*>(a.o) + b * a.os.sb + h * a.os.sh;
        TOut* o0 = out + static_cast<long long>(r0) * a.os.sn;
        TOut* o1 = out + static_cast<long long>(r1) * a.os.sn;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int col = 8 * c + 2 * t;
          if (col < a.dh) {  // dh % 8 == 0, so col + 1 < dh too
            if (r0 < a.N) attn::store_pair(o0 + col, o[4 * c] * i0, o[4 * c + 1] * i0);
            if (r1 < a.N) attn::store_pair(o1 + col, o[4 * c + 2] * i1, o[4 * c + 3] * i1);
          }
        }
      }
    }
  }
  if (kPingPong && wg == 0) bar_sync(1);  // matches warpgroup 1's last arrive
  // the last store reads its buffer before the block's shared memory goes
  if (kTmaStore && tid == 0) tma_store_commit_wait_read<0>();
}

// The kernel's body: the producer's loads, or a consumer's rows. The grid
// is persistent (block_work), and the producer loads the next items' Q and
// K/V tiles while the consumers finish the current one. kWide: width 128
// (80 < dh <= 128), else widths 64 and 80, told apart at run time.
template <typename TOut, bool kMask, bool kCross, bool kWide>
__device__ __forceinline__ void attention_body(const Maps& maps, const Args& a) {
  using R = Ring<kCross, kWide>;
  constexpr bool kTmaStore = kCross && std::is_same<TOut, attn::bf16>::value;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (attn::smem_addr(smem_raw) + 1023) & ~1023u;
  const Work wk = block_work(a);
  const bool has_tail = a.dh > kMainCols;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::stages; ++s) {
      mbar_init(R::full(base, s), 1);   // the producer's expect_tx
      mbar_init(R::empty(base, s), 8);  // lane 0 of each consumer warp
    }
    for (int q = 0; q < R::qbufs; ++q) {
      mbar_init(R::qfull(base, q), 1);
      // lane 0 of each consumer warp, or the thread of each consumer
      // warpgroup that stores its O from the buffer
      mbar_init(R::qempty(base, q), kTmaStore ? 2 : 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    // one thread loads; in the cross mode its whole warp finds the extents
    if (kCross ? threadIdx.x < 2 * 128 + 32 : threadIdx.x == 2 * 128) {
      const bool issue = !kCross || threadIdx.x == 2 * 128;
      const uint32_t chunk = has_tail ? R::q_bytes : kMainTile;
      const uint32_t tile_bytes =
          (has_tail ? R::stage_bytes : 2 * kMainTile) + (a.madd ? kBiasBytes : 0);
      int it = 0;  // ring position of the next K/V tile to load
      int n = 0;
      int ntiles = wk.ntiles;
      bool resident = false;
      for (int r = blockIdx.x; r < wk.runs; r += gridDim.x) {
        int bh, t0, t1;
        wk.run(r, bh, t0, t1);
        const int b = bh / a.H, h = bh - b * a.H;
        for (int tq = t0; tq < t1; ++tq, ++n) {
          const int q0 = tq * kRows;
          if (issue) {
            const int qi = n % R::qbufs;
            if (n >= R::qbufs) mbar_wait(R::qempty(base, qi), ((n / R::qbufs) - 1) & 1);
            const uint32_t qbuf = base + qi * R::q_bytes;
            mbar_expect_tx(R::qfull(base, qi), chunk);
            tma_load(qbuf, &maps.q, R::qfull(base, qi), 0, h, q0, b);
            if (has_tail) {
              tma_load(qbuf + kMainTile, kWide ? &maps.q : &maps.q_tail, R::qfull(base, qi),
                       kMainCols, h, q0, b);
            }
          }
          if (kCross && tq == t0) {  // the run's extent, while its first Q tile is in flight
            ntiles = key_tiles(a, wk, b);
            resident = ntiles <= R::stages;
          }
          // resident tiles are loaded for a run's first item only
          const bool load_kv = !resident || tq == t0;
          // in the cross mode the whole warp walks the tiles: lane 0 waits for
          // the stage and starts its K/V copies, every lane then writes its
          // share of the tile's biases, and lane 0's arrive (a release)
          // publishes them; the stage is full once the copies land too
          for (int j = 0; load_kv && j < ntiles; ++j) {
            const int pos = it + j;
            const int s = pos % R::stages;
            const uint32_t full = R::full(base, s);
            if (issue) {
              if (pos >= R::stages) mbar_wait(R::empty(base, s), ((pos / R::stages) - 1) & 1);
              const uint32_t st = base + R::stages_offset + s * R::stage_bytes;
              const int key0 = j * kKeys;
              if (kCross) {
                mbar_tx(full, tile_bytes);
              } else {
                mbar_expect_tx(full, tile_bytes);
              }
              tma_load(st, &maps.k, full, 0, h, key0, b);
              tma_load(st + kVOff, &maps.v, full, 0, h, key0, b);
              if (has_tail) {
                tma_load(st + kVTailOff, &maps.v, full, kMainCols, h, key0, b);
                tma_load(st + kKTailOff, kWide ? &maps.k : &maps.k_tail, full, kMainCols, h,
                         key0, b);
              }
              if (a.madd) {
                bulk_load(base + R::bias_offset + s * kBiasBytes,
                          a.madd + static_cast<long long>(b) * wk.ntiles * kKeys + key0,
                          kBiasBytes, full);
              }
            }
            if (kCross) {
              __syncwarp();
              write_tile_bias(base + R::bias_offset + s * kBiasBytes, a, b, j);
              __syncwarp();
              if (issue) mbar_arrive(full);
            }
          }
          if (load_kv) it += ntiles;
          if (kCross) __syncwarp();
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    if constexpr (kWide) {
      consume<TOut, kMask, 128, kCross>(maps, a, base, wg, wk);
    } else if (has_tail) {
      consume<TOut, kMask, 80, kCross>(maps, a, base, wg, wk);
    } else {
      consume<TOut, kMask, 64, kCross>(maps, a, base, wg, wk);
    }
  }
}

// ---------------------------------------------------------------- host

struct Launch {
  Maps maps;
  Args args;
  dim3 grid;
};

// Tensor maps, arguments and grid of one launch over bf16 q/k/v. With
// `o_maps`, o is a bf16 view that the cross mode stores through TMA.
inline int prepare(Launch& l, const void* q, const void* k, const void* v, const float* madd,
                   void* o, float* lse, int B, int H, int N, int M, int dh,
                   const attn::Strides& qs, const attn::Strides& ks, const attn::Strides& vs,
                   const attn::Strides& os, float scale, float m0, int tail,
                   bool cross = false, bool o_maps = false) {
  if (N < 1 || M < 1 || tail < 0 || dh < 1 || dh % 8 || dh > kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  l = Launch{};
  struct View {
    CUtensorMap *main, *rest;
    const void* ptr;
    int rows;
    const attn::Strides* s;
    int box_rows;
  };
  const View views[4] = {{&l.maps.q, &l.maps.q_tail, q, N, &qs, kRows},
                         {&l.maps.k, &l.maps.k_tail, k, M, &ks, kKeys},
                         {&l.maps.v, nullptr, v, M, &vs, kKeys},
                         {&l.maps.o, &l.maps.o_tail, o, N, &os, kRows / 2}};
  for (const View& x : views) {
    if (x.main == &l.maps.o && !o_maps) break;
    int err = encode(x.main, x.ptr, B, x.rows, H, dh, *x.s, kMainCols,
                     CU_TENSOR_MAP_SWIZZLE_128B, x.box_rows);
    if (!err && x.rest && width_of(dh) == 80)
      err = encode(x.rest, x.ptr, B, x.rows, H, dh, *x.s, kTailCols, CU_TENSOR_MAP_SWIZZLE_32B,
                   x.box_rows);
    if (err) return err;
  }
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int ntq = (N + kRows - 1) / kRows;
  // cross mode: as many blocks per (batch, head) as fill the SMs, each with
  // at least one query tile (shares <= ntq)
  const int shares = cross ? std::max(1, std::min(ntq, sms / (B * H))) : 0;
  l.args = Args{madd, o, lse, os, B, H, N, M, dh, scale, m0, tail, shares};
  const long long runs = static_cast<long long>(cross ? shares : ntq) * B * H;
  l.grid = dim3(static_cast<unsigned>(runs < sms ? runs : sms));
  return 0;
}

template <bool kCross, bool kWide, typename Kernel>
int run(Kernel* kernel, const Launch& l, cudaStream_t stream) {
  constexpr int bytes = Ring<kCross, kWide>::smem_bytes;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<l.grid, kThreads, bytes, stream>>>(l.maps, l.args);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the cross mode over bf16 q/k/v: the key mask `kmask` is
// required ([B, M] bytes, nonzero = valid, batch stride kmask_sb, keys
// contiguous), the running max starts from -inf and the TPU's padding of
// K/V to pad128(M) keys joins the denominator; a bf16 output is stored
// through TMA, an f32 one directly. `kernels` are the instantiations
// <bf16, narrow>, <f32, narrow>, <bf16, wide>, <f32, wide>: widths 64 and 80,
// and width 128.
template <typename K0, typename K1, typename K2, typename K3>
int launch_cross(K0* bf16_kernel, K1* f32_kernel, K2* bf16_wide_kernel, K3* f32_wide_kernel,
                 const void* q, const void* k, const void* v, const unsigned char* kmask,
                 long long kmask_sb, void* o, int f32, int B, int H, int N, int M, int dh,
                 const attn::Strides& qs, const attn::Strides& ks, const attn::Strides& vs,
                 const attn::Strides& os, float scale, cudaStream_t stream) {
  if (M > kCrossMaxKeys || kmask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Launch l;
  const int tail = (M + kKeys - 1) / kKeys * kKeys - M;
  const int err = prepare(l, q, k, v, nullptr, o, nullptr, B, H, N, M, dh, qs, ks, vs, os, scale,
                          -std::numeric_limits<float>::infinity(), tail, /*cross=*/true,
                          /*o_maps=*/!f32);
  if (err) return err;
  l.args.kmask = kmask;
  l.args.kmask_sb = kmask_sb;
  if (width_of(dh) == 128) {
    return f32 ? run<true, true>(f32_wide_kernel, l, stream)
               : run<true, true>(bf16_wide_kernel, l, stream);
  }
  return f32 ? run<true, false>(f32_kernel, l, stream) : run<true, false>(bf16_kernel, l, stream);
}

}  // namespace hopper
