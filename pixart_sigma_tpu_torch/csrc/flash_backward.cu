// Attention backward over strided [B, N, H, dh] bf16 views, from the row
// logsumexp that the forward saved (log2 units); bf16 or f32 gradients.
//
// Replaces the TPU kernels `_bwd_dkv_kernel` and `_bwd_dq_kernel`
// (pixart_sigma_tpu/ops/flash_attention.py, called from `_flash_bwd`). Both
// recompute the probabilities instead of storing them:
//   s  = q.k * scale + madd[key]            (scale = dh^-0.5 * log2(e))
//   P  = exp2(s - lse[row])
//   dP = dO . v,   dS = P * (dP - delta[row]) * ds_scale,  delta = rowsum(dO * O)
//   dV = P^T dO,   dK = dS^T q,   dQ = dS k
// with P and dS rounded to bf16 before their products and f32 sums. delta
// is computed by the caller in f32, as XLA does outside the Pallas kernels.
//
// On the TPU each grid step is one (q tile, k tile) pair and the sum over
// the swept axis lives in VMEM scratch across sequential grid steps. Hopper
// blocks run in no order, so the sweep is a loop inside a block, and each
// kernel is a persistent grid (one block of three warpgroups per SM) over
// work items, the warpgroup layout of the forward (hopper_attention.cuh):
// warpgroup 2 is the producer (its first warp streams tiles through a
// TMA/mbarrier ring; setmaxnreg gives its registers to the others) and
// warpgroups 0 and 1 the consumers, 64 rows each, on wgmma. Two kernels, no
// atomics: each sum is taken in one block's registers, in a fixed order, so
// the gradients are deterministic.
//
// - dq_kernel: items (128 query rows, batch * head), query tiles fastest so
//   the blocks in flight share one head's K/V in L2. The item's Q and dO
//   (K-major: 64 columns 128B-swizzled + 16 columns 32B-swizzled) sit in one
//   buffer; 128-key K/V tiles stream through a 3-stage ring with each tile's
//   128 key biases, which the producer warp writes beside them (-inf past M).
//   Over at most 512 keys (captions: items of one to four tiles) Q and dO
//   are double-buffered and the ring has two stages, so the next item's
//   copies overlap this one's few tiles.
//   Per tile: S = Q.K^T and dP = dO.V^T (wgmma m64n128k16, both operands in
//   shared memory), dS in registers, then dQ += dS.K with dS as the register
//   A operand (m64n80k16) and K read MN-major. K is therefore stored as two
//   128B-swizzled 64-column atoms (columns [64, 128) zero-filled past dh),
//   which the K-major descriptors of S read too. S and dP of tile j go out
//   with dQ of tile j - 1, so the exponentials of tile j run while that
//   product is in flight.
// - dkv_kernel: items (128 keys, batch * head), key tiles fastest (with a
//   mask, batch * head fastest: see dkv_item). The item's K and V are loaded
//   into shared memory (two buffers, so the next item's load overlaps this
//   one) and from there into registers as wgmma A fragments, each consumer
//   warpgroup its 64 keys; 64-row tiles of q and dO stream through a 4-stage
//   ring, each as two 128B atoms, since the tile is the B operand of a
//   K-major product (S^T = K.Q^T, dP^T = V.dO^T, m64n64k16) and of an
//   MN-major one (dV += P^T.dO, dK += dS^T.Q, m64n80k16), all four with the
//   A operand in registers (K, V, P^T, dS^T), so each k-step reads only its
//   B tile from shared memory. The producer warp writes each tile's lse and
//   delta beside it (+inf and 0 past N, so those rows give P = 0).
//
// The caption key extent (caption_key_extent in ops/flash_attention.py):
// with a mask, every warp finds its batch element's last valid key (bias
// above -1e29) in the [B, M] bias row; the key tiles past it are never
// loaded or multiplied by dq, and a dkv item whose keys all lie past it
// writes zeros for dK and dV and streams nothing. This is exact: for every
// row of a caption with a valid key, P = exp2(-1e30 + ...) = 0 there, so
// dS = 0 and dV = 0. A caption with no valid key keeps every tile, so the
// TPU's gradient for such a row (P = 1 in f32, P = 0 in bf16, the mask
// rounded to the input dtype by the caller) is kept.
//
// Rows past N and keys past M: TMA zero-fills them (q, dO, K, V), lse is
// +inf and delta 0 past N and the bias is -inf past M, so P = 0 and dS = 0
// there and no product meets an infinity; no row past M (dK, dV) or N (dQ)
// is written.
//
// Bound on the card: at the 1024px training path (B * H = 64, N = M = 4096,
// dh = 72) dkv does four products of 2 N M dh flops per head (618 GFLOP,
// 0.625 ms at 989 TFLOP/s) and dq three (464 GFLOP, 0.469 ms), against
// ~230 MB of operands and outputs (0.07 ms at 3.35 TB/s): the tensor cores
// bound both. dh = 72 runs as 80 columns (0.9 of the issued products
// useful). At the caption shape (M = 300, 3-19 valid keys) the work over the
// extent is one key tile per caption and the bytes of q, dO, lse, delta and
// dQ bound.
//
// Head dims up to 256, at the padded width 64, 80, 128 or 256
// (hopper_common.cuh; the Python wrapper pads a head dim that is not a
// multiple of 8 with zero columns). Width 128 (80 < dh <= 128) changes
// three things, as its accumulators no longer fit beside the overlap of the
// narrower widths in the 240 registers a consumer thread gets:
// - every K-major operand past column 64 is a second 128B atom (Q, dO, K,
//   V), so the products run 4 + 4 k-steps and dQ, dK, dV are N = 128;
// - the sweeps do not overlap tile j's S and dP with tile j - 1's gradient
//   product: each tile's products are issued and waited for in turn (dq:
//   S, dP 128 + dQ 64 registers live instead of 224), and dkv reads K and V
//   as shared-memory A operands instead of register fragments;
// - the rings shrink to fit 227 KB: dq one Q buffer and two K/V stages for
//   every key count, dkv one K/V buffer and four q/dO stages.
// Width 256 (128 < dh <= 256) keeps width 128's products in turn, with four
// 128B atoms per operand (4 x 4 k-steps, N = 256 gradient products) and
// 64-key tiles (keys_of), since a 128-row tile is 64 KB and an m64n256
// accumulator 128 registers:
// - dq: the item's Q and dO (128 rows, 128 KB) and one 64-key K/V stage
//   (64 KB); S and dP are m64n64 (dQ 128 + S 32 + dP 32 registers), and
//   no copy overlaps the products (two stages would need 256 KB);
// - dkv: items of 64 keys, whole on each consumer warpgroup, one gradient
//   each (dK + dV would be 256 registers): warpgroup 0 dV += P^T.dO,
//   warpgroup 1 dK += dS^T.Q. Both compute S^T (P^T is needed by both, and
//   the second product costs warpgroup 1 a third more tensor work but no
//   exchange through shared memory and no barrier between them), warpgroup 1
//   also dP^T; K/V (64 KB) and two 64-row q/dO stages (2 x 64 KB).

#include <type_traits>

#include "hopper_common.cuh"

namespace bwd {

using attn::bf16;
using hopper::kMainCols;
using hopper::kSwizzle128;
using hopper::kSwizzle32;
using hopper::kTailCols;

constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
// keys per dq K/V tile and per dkv item: hopper::keys_of(width), 128 or 64
constexpr int kRows = 128;     // query rows per dq item
constexpr int kQTile = 64;     // query rows per streamed dkv tile
constexpr int kMainBytes = 128 * 128;  // a 128-row, 64-column 128B-swizzled chunk (16 KB)
constexpr int kTailBytes = 128 * 32;   // a 128-row, 16-column 32B-swizzled chunk (4 KB)
constexpr int kQAtom = kQTile * 128;   // a 64-row 128B atom (8 KB)

// dq_kernel's shared memory at ring width kRing (hopper::ring_of): `qbufs`
// Q buffers (Q atom a at a * kMainBytes, width 80's tail at kMainBytes, dO
// the same from do_main), the K/V stages (K atom a at a * kv_atom, so at
// width 80 columns [64, 128) are a second 128B atom; V atom a at v_main +
// a * kv_atom, width 80's V tail at v_tail; the tile's biases), then the
// barriers full[stages], empty[stages], qfull[qbufs], qempty[qbufs]; 1024
// bytes of slack to align the base. Long key sweeps take one Q buffer and
// three K/V stages; sweeps of at most kShortKeys keys (captions), whose
// items are one to four tiles long, take two Q buffers and two stages, so
// the next item's Q and dO arrive while this one's few tiles run.
// Width 128 holds columns [64, 128) of Q, dO and V as a second 128B atom
// each, one Q buffer and two stages for every key count; width 256 four
// atoms each, one Q buffer and one stage of 64 keys.
constexpr int kShortKeys = 512;

template <int kQBufs, int kRing>
struct DqRing {
  static_assert(kRing == 80 || kRing == 128 || kRing == 256, "a ring width");
  static constexpr int keys = hopper::keys_of(kRing);
  static constexpr int kv_atom = keys * 128;  // a 64-column 128B atom of a K or V tile
  static constexpr int hi = kRing == 80 ? kTailBytes : kMainBytes;  // Q or dO columns past 64
  static constexpr int qbufs = kRing == 80 ? kQBufs : 1;
  static constexpr int stages = kRing == 256 ? 1 : kRing == 128 || kQBufs == 2 ? 2 : 3;
  static constexpr int q_tail = kMainBytes;
  static constexpr int do_main = kRing == 256 ? 4 * kMainBytes : kMainBytes + hi;
  static constexpr int do_tail = do_main + kMainBytes;
  static constexpr int q_bytes = 2 * do_main;
  static constexpr int k_hi = kv_atom;
  static constexpr int v_main = kRing == 256 ? 4 * kv_atom : 2 * kv_atom;
  static constexpr int v_tail = v_main + kv_atom;
  static constexpr int bias = kRing == 256 ? 8 * kv_atom : 3 * kv_atom + hi;
  static constexpr int stage_bytes = bias + 1024;
  static constexpr int stages_offset = qbufs * q_bytes;
  static constexpr int bar_offset = stages_offset + stages * stage_bytes;
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

// dkv_kernel's shared memory at ring width kRing: the K/V buffers (K atom a
// at a * kv_atom, width 80's K tail at k_tail, V the same from v_main; two
// buffers at widths 64 and 80, else one), the q/dO stages (q atom a of
// columns [64 a, 64 a + 64) at a * kQAtom, dO the same from do_lo, the
// tile's 64 lse and 64 delta), then the barriers full[stages],
// empty[stages], kvfull[kvbufs], kvempty[kvbufs]. Width 256: 64-key items,
// four atoms each, two stages.
template <int kRing>
struct DkvRing {
  static_assert(kRing == 80 || kRing == 128 || kRing == 256, "a ring width");
  static constexpr int keys = hopper::keys_of(kRing);  // keys per item
  static constexpr int kv_atom = keys * 128;
  static constexpr int hi = kRing == 80 ? kTailBytes : kMainBytes;
  static constexpr int atoms = kRing == 256 ? 4 : 2;  // 64-column atoms of a q or dO tile
  static constexpr int stages = kRing == 256 ? 2 : 4;
  static constexpr int kvbufs = kRing == 80 ? 2 : 1;
  static constexpr int k_tail = kv_atom;
  static constexpr int v_main = kRing == 256 ? 4 * kv_atom : kv_atom + hi;
  static constexpr int v_tail = v_main + kv_atom;
  static constexpr int kv_bytes = 2 * v_main;
  static constexpr int q_hi = kQAtom, do_lo = atoms * kQAtom, do_hi = do_lo + kQAtom,
                       lse = 2 * atoms * kQAtom, delta = lse + 4 * kQTile;
  static constexpr int stage_bytes = 2 * atoms * kQAtom + 1024;
  static constexpr int stages_offset = kvbufs * kv_bytes;
  static constexpr int bar_offset = stages_offset + stages * stage_bytes;
  static constexpr int smem_bytes = bar_offset + (2 * stages + 2 * kvbufs) * 8 + 1024;
  static_assert(smem_bytes <= 232448, "more shared memory than a block may use");

  __device__ static uint32_t full(uint32_t base, int s) { return base + bar_offset + 8 * s; }
  __device__ static uint32_t empty(uint32_t base, int s) {
    return base + bar_offset + 8 * (stages + s);
  }
  __device__ static uint32_t kvfull(uint32_t base, int i) {
    return base + bar_offset + 8 * (2 * stages + i);
  }
  __device__ static uint32_t kvempty(uint32_t base, int i) {
    return base + bar_offset + 8 * (2 * stages + kvbufs + i);
  }
};

// TMA descriptors of the bf16 [B, rows, H, dh] views: 64-column boxes with
// the 128B swizzle (read at column 0 and, as a second atom, at column 64),
// and 16-column boxes with the 32B swizzle for the K-major tails at width
// 80. dq_kernel uses q, q_tail, dout, dout_tail (128-row boxes), k, v and
// v_tail; dkv_kernel q and dout (64-row boxes), k, k_tail, v and v_tail.
// Width 128 uses no tail map.
struct Maps {
  CUtensorMap q, q_tail, dout, dout_tail, k, k_tail, v, v_tail;
};

struct Args {
  const float* madd;   // [B, M] additive key mask (0 / -1e30) or null
  const float* lse;    // [B * H, N] log2 units
  const float* delta;  // [B * H, N]
  void* dq;            // [B, N, H, dh] views, bf16 or f32
  void* dk;
  void* dv;
  attn::Strides dqs, dks, dvs;
  int B, H, N, M, dh;
  float scale;     // logit scale in log2 units
  float ds_scale;  // the chain factor of dS (ln 2 * scale for exp2)
};

// ---------------------------------------------------------------- device

// Key tiles of kKeys keys that batch element b's rows need, found by the
// calling warp (all 32 lanes) from its bias row: the last valid key (bias
// above -1e29), plus one, in whole tiles. Past it every row with a valid
// key has P = 0 exactly. With no mask or no valid key, all tiles.
template <int kKeys>
__device__ __forceinline__ int key_tiles(const Args& a, int b) {
  const int ntiles = (a.M + kKeys - 1) / kKeys;
  if (a.madd == nullptr) return ntiles;
  const float* row = a.madd + static_cast<long long>(b) * a.M;
  const int lane = threadIdx.x & 31;
  int last = -1;
  for (int key = lane; key < a.M; key += 32) {
    if (__ldg(row + key) > 0.1f * attn::kMaskedLogit) last = key;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  return last < 0 ? ntiles : last / kKeys + 1;
}

// The bias of key `key` of batch element b: the mask inside [0, M), -inf past it.
__device__ __forceinline__ float key_bias(const Args& a, int b, int key) {
  if (key >= a.M) return -CUDART_INF_F;
  return a.madd ? __ldg(a.madd + static_cast<long long>(b) * a.M + key) : 0.f;
}

__device__ __forceinline__ void ld_shared_v2(uint32_t addr, float& x, float& y) {
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(x), "=f"(y) : "r"(addr));
}

// acc, a wgmma m64nW accumulator (n64 when dh <= 64, n80, n128; per warp
// w and lane 4 g + t, acc[4 c + e] holds row 16 w + g (+ 8 for e >= 2),
// column 8 c + 2 t + (e & 1)), into rows r0 and r0 + 8 below `rows` of `out`.
template <typename TOut, int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N], void* out,
                                           const attn::Strides& s, int b, int h, int r0,
                                           int rows, int dh) {
  const int t = threadIdx.x & 3;
  TOut* base = static_cast<TOut*>(out) + b * s.sb + h * s.sh;
  TOut* o0 = base + static_cast<long long>(r0) * s.sn;
  TOut* o1 = o0 + 8 * s.sn;
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const int col = 8 * c + 2 * t;
    if (col < dh) {  // dh % 8 == 0, so col + 1 < dh too
      if (r0 < rows) attn::store_pair(o0 + col, acc[4 * c], acc[4 * c + 1]);
      if (r0 + 8 < rows) attn::store_pair(o1 + col, acc[4 * c + 2], acc[4 * c + 3]);
    }
  }
}

// Accumulator pairs (8 kk + 2 i, 8 kk + 2 i + 1) of an m64nK product, rounded
// to bf16: the A fragments of the next product, 16 columns per k-step.
template <int KK, int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KK][4], const float (&x)[N]) {
  static_assert(N == 8 * KK, "one k-step per 8 accumulator registers");
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[kk][i] = attn::pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
    }
}

// The wgmma A fragments of rows r and r + 8 of a 128-row tile that TMA
// wrote as 64 columns with the 128B swizzle at `main` (16-byte chunk c of
// row r at c ^ (r & 7)) and, with kTail, columns [64, 80) with the 32B
// swizzle at `tail` (chunk c at c ^ ((r >> 2) & 1)): per k-step of 16
// columns, (row r, columns 2 t, 2 t + 1), (row r + 8, the same), (row r,
// columns 2 t + 8, 2 t + 9), (row r + 8, the same).
template <bool kTail>
__device__ __forceinline__ void load_a(uint32_t (&a)[5][4], uint32_t main, uint32_t tail, int r,
                                       int t) {
  auto ld = [](uint32_t addr) {
    uint32_t x;
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(x) : "r"(addr));
    return x;
  };
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t chunk = static_cast<uint32_t>((2 * kk + half) ^ (r & 7)) << 4;
      a[kk][2 * half] = ld(main + r * 128 + chunk + 4 * t);
      a[kk][2 * half + 1] = ld(main + (r + 8) * 128 + chunk + 4 * t);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t chunk = static_cast<uint32_t>(half ^ ((r >> 2) & 1)) << 4;
    a[4][2 * half] = kTail ? ld(tail + r * 32 + chunk + 4 * t) : 0u;
    a[4][2 * half + 1] = kTail ? ld(tail + (r + 8) * 32 + chunk + 4 * t) : 0u;
  }
}

// ---------------------------------------------------------------- dq

template <typename TOut, int W, int kQBufs>
__device__ __forceinline__ void dq_consume(const Args& a, uint32_t base, int wg) {
  constexpr bool kTail = W == 80, kWide = W == 128;
  constexpr int kAcc = hopper::acc_regs(W);
  using R = DqRing<kQBufs, hopper::ring_of(W)>;
  constexpr int kKeys = R::keys, kS = kKeys / 2, kSteps = kKeys / 16;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntq = (a.N + kRows - 1) / kRows, runs = ntq * a.B * a.H;
  int it = 0;  // ring position of the current item's first K/V tile
  auto slot = [&](int j) { return (it + j) % R::stages; };
  auto stage = [&](int j) { return base + R::stages_offset + slot(j) * R::stage_bytes; };

  float s[kS], dp[kS], dq[kAcc];
  uint32_t ds[kSteps][4];
#pragma unroll
  for (int i = 0; i < kS; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) ds[i][0] = ds[i][1] = ds[i][2] = ds[i][3] = 0u;
  uint64_t dq_main, dq_tail, do_main, do_tail;  // this warpgroup's rows of the Q buffer
  float lse0, lse1, dl0, dl1;

  auto acquire = [&](int j) {
    hopper::mbar_wait(R::full(base, slot(j)), ((it + j) / R::stages) & 1);
    hopper::wgmma_fence();
  };
  auto release = [&](int j) {
    if (lane == 0) hopper::mbar_arrive(R::empty(base, slot(j)));
  };
  // S = Q.K^T and dP = dO.V^T of tile j, one commit group
  auto issue_sdp = [&](int j) {
    const uint32_t st = stage(j);
    const uint64_t dk = hopper::smem_desc(st, 1024, kSwizzle128);
    const uint64_t dv = hopper::smem_desc(st + R::v_main, 1024, kSwizzle128);
    if constexpr (W == 256) {  // atom a of Q and dO 16 KB apart, of K and V 8 KB
#pragma unroll
      for (int at = 0; at < 4; ++at)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_ss_n64(s, dq_main + at * (kMainBytes >> 4) + 2 * kk,
                               dk + at * (R::kv_atom >> 4) + 2 * kk, at + kk > 0);
#pragma unroll
      for (int at = 0; at < 4; ++at)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_ss_n64(dp, do_main + at * (kMainBytes >> 4) + 2 * kk,
                               dv + at * (R::kv_atom >> 4) + 2 * kk, at + kk > 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::wgmma_ss_n128(s, dq_main + 2 * kk, dk + 2 * kk, kk > 0);
      const uint64_t dk_hi = hopper::smem_desc(st + R::k_hi, 1024, kSwizzle128);
      if (kTail) hopper::wgmma_ss_n128(s, dq_tail, dk_hi, 1);
      if (kWide) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::wgmma_ss_n128(s, dq_tail + 2 * kk, dk_hi + 2 * kk, 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::wgmma_ss_n128(dp, do_main + 2 * kk, dv + 2 * kk, kk > 0);
      if (kTail) {
        hopper::wgmma_ss_n128(dp, do_tail, hopper::smem_desc(st + R::v_tail, 256, kSwizzle32), 1);
      }
      if (kWide) {
        const uint64_t dv_hi = hopper::smem_desc(st + R::v_tail, 1024, kSwizzle128);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::wgmma_ss_n128(dp, do_tail + 2 * kk, dv_hi + 2 * kk, 1);
      }
    }
    hopper::wgmma_commit();
  };
  // dQ += dS.K of tile j (dS in ds), K read MN-major: a k-step is 16 key
  // rows of 128 bytes in each of K's two atoms
  auto issue_dq = [&](int j) {
    const uint64_t dk = hopper::smem_desc(stage(j), 1024, kSwizzle128, R::k_hi);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      hopper::wgmma_rs_mn<W>(dq, ds[kk], dk + kk * (16 * 128 / 16));
    hopper::wgmma_commit();
  };
  // P = exp2(s * scale + bias - lse) and, in dp, dS = P (dP - delta) ds_scale
  auto grads = [&](int j) {
    const uint32_t bias = stage(j) + R::bias + 8 * t;
#pragma unroll
    for (int c = 0; c < kS / 4; ++c) {
      float b0, b1;
      ld_shared_v2(bias + 32 * c, b0, b1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = attn::fast_exp2(fmaf(s[4 * c + e], a.scale, (e & 1) ? b1 : b0) -
                                        (e < 2 ? lse0 : lse1));
        dp[4 * c + e] = p * (dp[4 * c + e] - (e < 2 ? dl0 : dl1)) * a.ds_scale;
      }
    }
  };

  int n = 0;  // items done by this block
  int ext_b = -1, ntiles = 0;
  for (int r = blockIdx.x; r < runs; r += gridDim.x, ++n) {
    const int bh = r / ntq, tq = r - bh * ntq;
    const int b = bh / a.H, h = bh - b * a.H;
    if (b != ext_b) {
      ntiles = key_tiles<kKeys>(a, b);
      ext_b = b;
    }
    const int r0 = tq * kRows + 64 * wg + 16 * warp + g;
    const float* lse = a.lse + static_cast<long long>(bh) * a.N;
    const float* delta = a.delta + static_cast<long long>(bh) * a.N;
    lse0 = r0 < a.N ? __ldg(lse + r0) : CUDART_INF_F;
    lse1 = r0 + 8 < a.N ? __ldg(lse + r0 + 8) : CUDART_INF_F;
    dl0 = r0 < a.N ? __ldg(delta + r0) : 0.f;
    dl1 = r0 + 8 < a.N ? __ldg(delta + r0 + 8) : 0.f;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) dq[i] = 0.f;
    const int qi = n % R::qbufs;
    const uint32_t qbuf = base + qi * R::q_bytes;
    dq_main = hopper::smem_desc(qbuf + wg * (kMainBytes / 2), 1024, kSwizzle128);
    do_main = hopper::smem_desc(qbuf + R::do_main + wg * (kMainBytes / 2), 1024, kSwizzle128);
    if (W >= 128) {
      dq_tail = hopper::smem_desc(qbuf + R::q_tail + wg * (kMainBytes / 2), 1024, kSwizzle128);
      do_tail = hopper::smem_desc(qbuf + R::do_tail + wg * (kMainBytes / 2), 1024, kSwizzle128);
    } else {
      dq_tail = hopper::smem_desc(qbuf + R::q_tail + wg * (kTailBytes / 2), 256, kSwizzle32);
      do_tail = hopper::smem_desc(qbuf + R::do_tail + wg * (kTailBytes / 2), 256, kSwizzle32);
    }
    hopper::mbar_wait(R::qfull(base, qi), (n / R::qbufs) & 1);  // this item's Q and dO

    if constexpr (W >= 128) {
      // each tile's products in turn: S and dP, their gradients, then dQ
      for (int j = 0; j < ntiles; ++j) {
        acquire(j);
        issue_sdp(j);
        hopper::wgmma_wait<0>();
        hopper::hold(s);
        hopper::hold(dp);
        grads(j);
        pack_a(ds, dp);
        if (j + 1 == ntiles && lane == 0) hopper::mbar_arrive(R::qempty(base, qi));
        hopper::wgmma_fence();
        issue_dq(j);
        hopper::wgmma_wait<0>();
        hopper::hold(dq);
        hopper::hold(ds);
        release(j);
      }
      it += ntiles;
      store_rows<TOut>(dq, a.dq, a.dqs, b, h, r0, a.N, a.dh);
      continue;
    }
    acquire(0);
    issue_sdp(0);
    hopper::wgmma_wait<0>();
    hopper::hold(s);
    hopper::hold(dp);
    grads(0);
    pack_a(ds, dp);
    for (int j = 1; j < ntiles; ++j) {
      // S and dP of tile j and dQ of tile j - 1 go out together; tile j's
      // exponentials run while that product is in flight
      acquire(j);
      issue_sdp(j);
      issue_dq(j - 1);
      hopper::wgmma_wait<1>();
      hopper::hold(s);
      hopper::hold(dp);
      grads(j);
      hopper::wgmma_wait<0>();
      hopper::hold(dq);
      hopper::hold(ds);
      release(j - 1);
      pack_a(ds, dp);
    }
    if (lane == 0) hopper::mbar_arrive(R::qempty(base, qi));  // every S and dP is done
    hopper::wgmma_fence();
    issue_dq(ntiles - 1);
    hopper::wgmma_wait<0>();
    hopper::hold(dq);
    release(ntiles - 1);
    it += ntiles;
    store_rows<TOut>(dq, a.dq, a.dqs, b, h, r0, a.N, a.dh);
  }
}

template <int W, int kQBufs>
__device__ __forceinline__ void dq_produce(const Maps& maps, const Args& a, uint32_t base) {
  constexpr bool kHi = W > 64, kWide = W == 128;  // columns past 64; as a second 128B atom
  using R = DqRing<kQBufs, hopper::ring_of(W)>;
  constexpr int kKeys = R::keys;
  const int lane = threadIdx.x & 31;
  const bool issue = lane == 0;
  const int ntq = (a.N + kRows - 1) / kRows, runs = ntq * a.B * a.H;
  const uint32_t q_bytes = kHi ? R::q_bytes : 2 * kMainBytes;
  const uint32_t tile_bytes = W == 256 ? 8 * R::kv_atom
                              : kHi    ? 3 * kMainBytes + R::hi
                                       : 2 * kMainBytes;
  int it = 0, n = 0, ext_b = -1, ntiles = 0;
  for (int r = blockIdx.x; r < runs; r += gridDim.x, ++n) {
    const int bh = r / ntq, tq = r - bh * ntq;
    const int b = bh / a.H, h = bh - b * a.H;
    const int q0 = tq * kRows;
    if (issue) {
      const int qi = n % R::qbufs;
      if (n >= R::qbufs) hopper::mbar_wait(R::qempty(base, qi), ((n / R::qbufs) - 1) & 1);
      const uint32_t qbuf = base + qi * R::q_bytes, qfull = R::qfull(base, qi);
      hopper::mbar_expect_tx(qfull, q_bytes);
      hopper::tma_load(qbuf, &maps.q, qfull, 0, h, q0, b);
      hopper::tma_load(qbuf + R::do_main, &maps.dout, qfull, 0, h, q0, b);
      if (W == 256) {
        for (int at = 1; at < 4; ++at) {
          hopper::tma_load(qbuf + at * kMainBytes, &maps.q, qfull, at * kMainCols, h, q0, b);
          hopper::tma_load(qbuf + R::do_main + at * kMainBytes, &maps.dout, qfull,
                           at * kMainCols, h, q0, b);
        }
      } else if (kHi) {
        hopper::tma_load(qbuf + R::q_tail, kWide ? &maps.q : &maps.q_tail, qfull, kMainCols, h,
                         q0, b);
        hopper::tma_load(qbuf + R::do_tail, kWide ? &maps.dout : &maps.dout_tail, qfull,
                         kMainCols, h, q0, b);
      }
    }
    if (b != ext_b) {  // while the first Q copies are in flight
      ntiles = key_tiles<kKeys>(a, b);
      ext_b = b;
    }
    for (int j = 0; j < ntiles; ++j) {
      const int pos = it + j, s = pos % R::stages;
      const uint32_t st = base + R::stages_offset + s * R::stage_bytes;
      const uint32_t full = R::full(base, s);
      const int key0 = j * kKeys;
      float bias[kKeys / 32];  // loaded before the wait, so their latency hides behind it
#pragma unroll
      for (int e = 0; e < kKeys / 32; ++e) bias[e] = key_bias(a, b, key0 + 32 * e + lane);
      if (issue) {
        if (pos >= R::stages) hopper::mbar_wait(R::empty(base, s), ((pos / R::stages) - 1) & 1);
        hopper::mbar_tx(full, tile_bytes);
        hopper::tma_load(st, &maps.k, full, 0, h, key0, b);
        hopper::tma_load(st + R::v_main, &maps.v, full, 0, h, key0, b);
        if (W == 256) {
          for (int at = 1; at < 4; ++at) {
            hopper::tma_load(st + at * R::kv_atom, &maps.k, full, at * kMainCols, h, key0, b);
            hopper::tma_load(st + R::v_main + at * R::kv_atom, &maps.v, full, at * kMainCols, h,
                             key0, b);
          }
        } else if (kHi) {
          hopper::tma_load(st + R::k_hi, &maps.k, full, kMainCols, h, key0, b);
          hopper::tma_load(st + R::v_tail, kWide ? &maps.v : &maps.v_tail, full, kMainCols, h,
                           key0, b);
        }
      }
      __syncwarp();  // lane 0 has seen the stage free
#pragma unroll
      for (int e = 0; e < kKeys / 32; ++e) {
        hopper::st_shared(st + R::bias + 4 * (32 * e + lane), __float_as_uint(bias[e]));
      }
      __syncwarp();
      if (issue) hopper::mbar_arrive(full);  // publishes the biases (a release)
    }
    it += ntiles;
  }
}

// ---------------------------------------------------------------- dkv

// dkv item r: (batch * head bh, key tile kt). Without a mask, key tiles run
// fastest, so the blocks in flight stream the same head's q and dO from L2.
// With one, batch * head runs fastest: the items past a caption's extent
// (which cost only their zeros) then fall on blocks of their own instead of
// beside a live item of the same caption.
__device__ __forceinline__ void dkv_item(const Args& a, int r, int nkt, int& bh, int& kt) {
  if (a.madd == nullptr) {
    bh = r / nkt;
    kt = r - bh * nkt;
  } else {
    const int BH = a.B * a.H;
    kt = r / BH;
    bh = r - kt * BH;
  }
}

template <typename TOut, int W>
__device__ __forceinline__ void dkv_consume(const Args& a, uint32_t base, int wg) {
  constexpr bool kTail = W == 80, kWide = W == 128;
  constexpr int kAcc = hopper::acc_regs(W);
  using R = DkvRing<hopper::ring_of(W)>;
  constexpr int kKeys = R::keys;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nkt = (a.M + kKeys - 1) / kKeys, nqt = (a.N + kQTile - 1) / kQTile;
  const int runs = nkt * a.B * a.H;
  int it = 0;  // ring position of the current item's first q tile
  auto slot = [&](int i) { return (it + i) % R::stages; };
  auto stage = [&](int i) { return base + R::stages_offset + slot(i) * R::stage_bytes; };

  float s[32], dp[32], dk[kAcc], dv[kAcc];
  uint32_t pt[4][4], dst[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) pt[i][e] = dst[i][e] = 0u;
  // this warpgroup's K and V rows as wgmma A fragments (widths 64 and 80),
  // or (width 128) the descriptors of its 64 rows of K and V in shared memory
  uint32_t ka[kWide ? 1 : 5][4], va[kWide ? 1 : 5][4];
  uint64_t k_lo = 0, k_hi = 0, v_lo = 0, v_hi = 0;
  float bias0, bias1;

  auto acquire = [&](int i) {
    hopper::mbar_wait(R::full(base, slot(i)), ((it + i) / R::stages) & 1);
    hopper::wgmma_fence();
  };
  auto release = [&](int i) {
    if (lane == 0) hopper::mbar_arrive(R::empty(base, slot(i)));
  };
  // S^T = K.Q^T and dP^T = V.dO^T of tile i (keys x queries), one commit group
  auto issue_sdp = [&](int i) {
    const uint32_t st = stage(i);
    const uint64_t bq = hopper::smem_desc(st, 1024, kSwizzle128);
    const uint64_t bo = hopper::smem_desc(st + R::do_lo, 1024, kSwizzle128);
    if constexpr (kWide) {
      const uint64_t bq_hi = hopper::smem_desc(st + R::q_hi, 1024, kSwizzle128);
      const uint64_t bo_hi = hopper::smem_desc(st + R::do_hi, 1024, kSwizzle128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::wgmma_ss_n64(s, k_lo + 2 * kk, bq + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::wgmma_ss_n64(s, k_hi + 2 * kk, bq_hi + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::wgmma_ss_n64(dp, v_lo + 2 * kk, bo + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::wgmma_ss_n64(dp, v_hi + 2 * kk, bo_hi + 2 * kk, 1);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::wgmma_rs_n64_kmajor(s, ka[kk], bq + 2 * kk, kk > 0);
      if (kTail) {
        hopper::wgmma_rs_n64_kmajor(s, ka[4], hopper::smem_desc(st + R::q_hi, 1024, kSwizzle128),
                                    1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::wgmma_rs_n64_kmajor(dp, va[kk], bo + 2 * kk, kk > 0);
      if (kTail) {
        hopper::wgmma_rs_n64_kmajor(dp, va[4],
                                    hopper::smem_desc(st + R::do_hi, 1024, kSwizzle128), 1);
      }
    }
    hopper::wgmma_commit();
  };
  // dV += P^T.dO and dK += dS^T.Q of tile i, q and dO read MN-major: a
  // k-step is 16 query rows of 128 bytes in each of the tile's two atoms
  auto issue_dkv = [&](int i) {
    const uint32_t st = stage(i);
    const uint64_t bq = hopper::smem_desc(st, 1024, kSwizzle128, R::q_hi);
    const uint64_t bo = hopper::smem_desc(st + R::do_lo, 1024, kSwizzle128, R::q_hi);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::wgmma_rs_mn<W>(dv, pt[kk], bo + kk * (16 * 128 / 16));
      hopper::wgmma_rs_mn<W>(dk, dst[kk], bq + kk * (16 * 128 / 16));
    }
    hopper::wgmma_commit();
  };
  // in s, P^T = exp2(s * scale + bias - lse); in dp, dS^T = P^T (dP^T - delta) ds_scale
  auto grads = [&](int i) {
    const uint32_t st = stage(i) + 8 * t;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float l0, l1, d0, d1;
      ld_shared_v2(st + R::lse + 32 * c, l0, l1);
      ld_shared_v2(st + R::delta + 32 * c, d0, d1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = attn::fast_exp2(fmaf(s[4 * c + e], a.scale, e < 2 ? bias0 : bias1) -
                                        ((e & 1) ? l1 : l0));
        dp[4 * c + e] = p * (dp[4 * c + e] - ((e & 1) ? d1 : d0)) * a.ds_scale;
        s[4 * c + e] = p;
      }
    }
  };

  int n = 0;  // items this block has swept
  int ext_b = -1, ntiles = 0;
  for (int r = blockIdx.x; r < runs; r += gridDim.x) {
    int bh, kt;
    dkv_item(a, r, nkt, bh, kt);
    const int b = bh / a.H, h = bh - b * a.H;
    if (b != ext_b) {
      ntiles = key_tiles<kKeys>(a, b);
      ext_b = b;
    }
    const int r0 = kt * kKeys + 64 * wg + 16 * warp + g;  // this thread's keys r0, r0 + 8
#pragma unroll
    for (int i = 0; i < kAcc; ++i) dk[i] = dv[i] = 0.f;
    if (kt < ntiles) {  // else every key lies past the extent: dK = dV = 0
      const int kb = n % R::kvbufs;
      const uint32_t kv = base + kb * R::kv_bytes;
      bias0 = key_bias(a, b, r0);
      bias1 = key_bias(a, b, r0 + 8);
      hopper::mbar_wait(R::kvfull(base, kb), (n / R::kvbufs) & 1);
      if constexpr (kWide) {
        // each tile's products in turn, K and V read from shared memory; the
        // K/V buffer is free once the last S^T and dP^T are done
        const uint32_t rows = wg * (kMainBytes / 2);  // this warpgroup's 64 keys
        k_lo = hopper::smem_desc(kv + rows, 1024, kSwizzle128);
        k_hi = hopper::smem_desc(kv + R::k_tail + rows, 1024, kSwizzle128);
        v_lo = hopper::smem_desc(kv + R::v_main + rows, 1024, kSwizzle128);
        v_hi = hopper::smem_desc(kv + R::v_tail + rows, 1024, kSwizzle128);
        for (int i = 0; i < nqt; ++i) {
          acquire(i);
          issue_sdp(i);
          hopper::wgmma_wait<0>();
          hopper::hold(s);
          hopper::hold(dp);
          if (i + 1 == nqt && lane == 0) hopper::mbar_arrive(R::kvempty(base, kb));
          grads(i);
          pack_a(pt, s);
          pack_a(dst, dp);
          hopper::wgmma_fence();
          issue_dkv(i);
          hopper::wgmma_wait<0>();
          hopper::hold(dk);
          hopper::hold(dv);
          hopper::hold(pt);
          hopper::hold(dst);
          release(i);
        }
        it += nqt;
        ++n;
      } else {
        load_a<kTail>(ka, kv, kv + R::k_tail, 64 * wg + 16 * warp + g, t);
        load_a<kTail>(va, kv + R::v_main, kv + R::v_tail, 64 * wg + 16 * warp + g, t);

        acquire(0);
        issue_sdp(0);
        hopper::wgmma_wait<0>();
        hopper::hold(s);
        hopper::hold(dp);
        grads(0);
        pack_a(pt, s);
        pack_a(dst, dp);
        for (int i = 1; i < nqt; ++i) {
          acquire(i);
          issue_sdp(i);
          issue_dkv(i - 1);
          hopper::wgmma_wait<1>();
          hopper::hold(s);
          hopper::hold(dp);
          grads(i);
          hopper::wgmma_wait<0>();
          hopper::hold(dk);
          hopper::hold(dv);
          hopper::hold(pt);
          hopper::hold(dst);
          release(i - 1);
          pack_a(pt, s);
          pack_a(dst, dp);
        }
        hopper::wgmma_fence();
        issue_dkv(nqt - 1);
        hopper::wgmma_wait<0>();
        hopper::hold(dk);
        hopper::hold(dv);
        release(nqt - 1);
        if (lane == 0) hopper::mbar_arrive(R::kvempty(base, kb));
        it += nqt;
        ++n;
      }
    }
    store_rows<TOut>(dk, a.dk, a.dks, b, h, r0, a.M, a.dh);
    store_rows<TOut>(dv, a.dv, a.dvs, b, h, r0, a.M, a.dh);
  }
}

// Width 256: one consumer warpgroup's gradient, dV (kDk false, warpgroup 0)
// or dK (warpgroup 1), of the item's 64 keys, rows 16 w + g and + 8 of
// warp w. Per q tile, products in turn: S^T = K.Q^T (and, for dK,
// dP^T = V.dO^T), K, V, q and dO all read from shared memory as four
// K-major atoms; P^T (dS^T for dK) into A fragments; then dV += P^T.dO (dK
// += dS^T.Q), the tile read MN-major, N = 256.
template <typename TOut, bool kDk>
__device__ __forceinline__ void dkv_consume_split(const Args& a, uint32_t base) {
  using R = DkvRing<256>;
  constexpr int kKeys = R::keys;
  static_assert(R::kvbufs == 1, "one K/V buffer");
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nkt = (a.M + kKeys - 1) / kKeys, nqt = (a.N + kQTile - 1) / kQTile;
  const int runs = nkt * a.B * a.H;
  int it = 0;  // ring position of the current item's first q tile
  auto slot = [&](int i) { return (it + i) % R::stages; };
  auto stage = [&](int i) { return base + R::stages_offset + slot(i) * R::stage_bytes; };

  float s[32], dp[32], acc[128];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[i][e] = 0u;
  const uint64_t kd = hopper::smem_desc(base, 1024, kSwizzle128);
  const uint64_t vd = hopper::smem_desc(base + R::v_main, 1024, kSwizzle128);

  int n = 0;  // items this block has swept
  int ext_b = -1, ntiles = 0;
  for (int r = blockIdx.x; r < runs; r += gridDim.x) {
    int bh, kt;
    dkv_item(a, r, nkt, bh, kt);
    const int b = bh / a.H, h = bh - b * a.H;
    if (b != ext_b) {
      ntiles = key_tiles<kKeys>(a, b);
      ext_b = b;
    }
    const int r0 = kt * kKeys + 16 * warp + g;  // this thread's keys r0, r0 + 8
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    if (kt < ntiles) {  // else every key lies past the extent: dK = dV = 0
      const float bias0 = key_bias(a, b, r0), bias1 = key_bias(a, b, r0 + 8);
      hopper::mbar_wait(R::kvfull(base, 0), n & 1);
      for (int i = 0; i < nqt; ++i) {
        hopper::mbar_wait(R::full(base, slot(i)), ((it + i) / R::stages) & 1);
        hopper::wgmma_fence();
        const uint32_t st = stage(i);
        const uint64_t bq = hopper::smem_desc(st, 1024, kSwizzle128);
        const uint64_t bo = hopper::smem_desc(st + R::do_lo, 1024, kSwizzle128);
#pragma unroll
        for (int at = 0; at < 4; ++at)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::wgmma_ss_n64(s, kd + at * (R::kv_atom >> 4) + 2 * kk,
                                 bq + at * (kQAtom >> 4) + 2 * kk, at + kk > 0);
        if (kDk) {
#pragma unroll
          for (int at = 0; at < 4; ++at)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              hopper::wgmma_ss_n64(dp, vd + at * (R::kv_atom >> 4) + 2 * kk,
                                   bo + at * (kQAtom >> 4) + 2 * kk, at + kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::hold(s);
        hopper::hold(dp);
        // the K/V buffer is free once the item's last S^T and dP^T are done
        if (i + 1 == nqt && lane == 0) hopper::mbar_arrive(R::kvempty(base, 0));
        // P^T = exp2(s * scale + bias - lse); for dK, dS^T = P^T (dP^T - delta) ds_scale
        const uint32_t side = st + 8 * t;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float l0, l1, d0, d1;
          ld_shared_v2(side + R::lse + 32 * c, l0, l1);
          ld_shared_v2(side + R::delta + 32 * c, d0, d1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = attn::fast_exp2(fmaf(s[4 * c + e], a.scale, e < 2 ? bias0 : bias1) -
                                            ((e & 1) ? l1 : l0));
            if (kDk) {
              dp[4 * c + e] = p * (dp[4 * c + e] - ((e & 1) ? d1 : d0)) * a.ds_scale;
            } else {
              s[4 * c + e] = p;
            }
          }
        }
        if constexpr (kDk) {
          pack_a(pa, dp);
        } else {
          pack_a(pa, s);
        }
        hopper::wgmma_fence();
        // dK += dS^T.Q or dV += P^T.dO: a k-step is 16 query rows of 128
        // bytes in each of the tile's four atoms
        const uint64_t bmn =
            hopper::smem_desc(st + (kDk ? 0 : R::do_lo), 1024, kSwizzle128, kQAtom);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::wgmma_rs_n256(acc, pa[kk], bmn + kk * (16 * 128 / 16));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::hold(acc);
        hopper::hold(pa);
        if (lane == 0) hopper::mbar_arrive(R::empty(base, slot(i)));
      }
      it += nqt;
      ++n;
    }
    store_rows<TOut>(acc, kDk ? a.dk : a.dv, kDk ? a.dks : a.dvs, b, h, r0, a.M, a.dh);
  }
}

template <int W>
__device__ __forceinline__ void dkv_produce(const Maps& maps, const Args& a, uint32_t base) {
  constexpr bool kHi = W > 64, kWide = W == 128;  // columns past 64; as a second 128B atom
  using R = DkvRing<hopper::ring_of(W)>;
  constexpr int kKeys = R::keys;
  const int lane = threadIdx.x & 31;
  const bool issue = lane == 0;
  const int nkt = (a.M + kKeys - 1) / kKeys, nqt = (a.N + kQTile - 1) / kQTile;
  const int runs = nkt * a.B * a.H;
  const uint32_t kv_bytes = kHi ? R::kv_bytes : 2 * kMainBytes;
  const uint32_t tile_bytes = kHi ? 2 * R::atoms * kQAtom : 2 * kQAtom;
  int it = 0, n = 0, ext_b = -1, ntiles = 0;
  for (int r = blockIdx.x; r < runs; r += gridDim.x) {
    int bh, kt;
    dkv_item(a, r, nkt, bh, kt);
    const int b = bh / a.H, h = bh - b * a.H;
    if (b != ext_b) {
      ntiles = key_tiles<kKeys>(a, b);
      ext_b = b;
    }
    if (kt >= ntiles) continue;  // the consumers write zeros
    const int kb = n % R::kvbufs;
    const int key0 = kt * kKeys;
    if (issue) {
      const uint32_t kv = base + kb * R::kv_bytes;
      const uint32_t kvfull = R::kvfull(base, kb);
      if (n >= R::kvbufs) {
        hopper::mbar_wait(R::kvempty(base, kb), ((n / R::kvbufs) - 1) & 1);
      }
      hopper::mbar_expect_tx(kvfull, kv_bytes);
      hopper::tma_load(kv, &maps.k, kvfull, 0, h, key0, b);
      hopper::tma_load(kv + R::v_main, &maps.v, kvfull, 0, h, key0, b);
      if (W == 256) {
        for (int at = 1; at < 4; ++at) {
          hopper::tma_load(kv + at * R::kv_atom, &maps.k, kvfull, at * kMainCols, h, key0, b);
          hopper::tma_load(kv + R::v_main + at * R::kv_atom, &maps.v, kvfull, at * kMainCols, h,
                           key0, b);
        }
      } else if (kHi) {
        hopper::tma_load(kv + R::k_tail, kWide ? &maps.k : &maps.k_tail, kvfull, kMainCols, h,
                         key0, b);
        hopper::tma_load(kv + R::v_tail, kWide ? &maps.v : &maps.v_tail, kvfull, kMainCols, h,
                         key0, b);
      }
    }
    const float* lse = a.lse + static_cast<long long>(bh) * a.N;
    const float* delta = a.delta + static_cast<long long>(bh) * a.N;
    for (int i = 0; i < nqt; ++i) {
      const int pos = it + i, s = pos % R::stages;
      const uint32_t st = base + R::stages_offset + s * R::stage_bytes;
      const uint32_t full = R::full(base, s);
      const int q0 = i * kQTile;
      float l[2], d[2];  // loaded before the wait, so their latency hides behind it
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = q0 + 32 * e + lane;
        l[e] = row < a.N ? __ldg(lse + row) : CUDART_INF_F;
        d[e] = row < a.N ? __ldg(delta + row) : 0.f;
      }
      if (issue) {
        if (pos >= R::stages) hopper::mbar_wait(R::empty(base, s), ((pos / R::stages) - 1) & 1);
        hopper::mbar_tx(full, tile_bytes);
        hopper::tma_load(st, &maps.q, full, 0, h, q0, b);
        hopper::tma_load(st + R::do_lo, &maps.dout, full, 0, h, q0, b);
        if (W == 256) {
          for (int at = 1; at < 4; ++at) {
            hopper::tma_load(st + at * kQAtom, &maps.q, full, at * kMainCols, h, q0, b);
            hopper::tma_load(st + R::do_lo + at * kQAtom, &maps.dout, full, at * kMainCols, h,
                             q0, b);
          }
        } else if (kHi) {
          hopper::tma_load(st + R::q_hi, &maps.q, full, kMainCols, h, q0, b);
          hopper::tma_load(st + R::do_hi, &maps.dout, full, kMainCols, h, q0, b);
        }
      }
      __syncwarp();  // lane 0 has seen the stage free
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        hopper::st_shared(st + R::lse + 4 * (32 * e + lane), __float_as_uint(l[e]));
        hopper::st_shared(st + R::delta + 4 * (32 * e + lane), __float_as_uint(d[e]));
      }
      __syncwarp();
      if (issue) hopper::mbar_arrive(full);  // publishes lse and delta (a release)
    }
    it += nqt;
    ++n;
  }
}

// ---------------------------------------------------------------- kernels

__device__ __forceinline__ uint32_t smem_base() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  return (attn::smem_addr(smem_raw) + 1023) & ~1023u;
}

template <typename TOut, int W, int kQBufs>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ Maps maps, const Args a) {
  using R = DqRing<kQBufs, hopper::ring_of(W)>;
  const uint32_t base = smem_base();
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::stages; ++s) {
      hopper::mbar_init(R::full(base, s), 1);   // the producer's arrive, after the biases
      hopper::mbar_init(R::empty(base, s), 8);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < R::qbufs; ++i) {
      hopper::mbar_init(R::qfull(base, i), 1);
      hopper::mbar_init(R::qempty(base, i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 2 * 128 + 32) dq_produce<W, kQBufs>(maps, a, base);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    dq_consume<TOut, W, kQBufs>(a, base, wg);
  }
}

template <typename TOut, int W>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ Maps maps, const Args a) {
  using R = DkvRing<hopper::ring_of(W)>;
  const uint32_t base = smem_base();
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::stages; ++s) {
      hopper::mbar_init(R::full(base, s), 1);   // the producer's arrive, after lse and delta
      hopper::mbar_init(R::empty(base, s), 8);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < R::kvbufs; ++i) {
      hopper::mbar_init(R::kvfull(base, i), 1);
      hopper::mbar_init(R::kvempty(base, i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 2 * 128 + 32) dkv_produce<W>(maps, a, base);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    if constexpr (W == 256) {
      if (wg == 0) {
        dkv_consume_split<TOut, false>(a, base);
      } else {
        dkv_consume_split<TOut, true>(a, base);
      }
    } else {
      dkv_consume<TOut, W>(a, base, wg);
    }
  }
}

// ---------------------------------------------------------------- host

// A bf16 view as a 64-column 128B-swizzled map of `box_rows` rows and, with
// `tail` at width 80, its 16-column 32B-swizzled map for columns [64, 80).
inline int encode_view(CUtensorMap* main, CUtensorMap* tail, const void* ptr, int B, int rows,
                       int H, int dh, const attn::Strides& s, int box_rows) {
  int err = hopper::encode(main, ptr, B, rows, H, dh, s, kMainCols, CU_TENSOR_MAP_SWIZZLE_128B,
                           box_rows);
  if (!err && tail != nullptr && hopper::width_of(dh) == 80)
    err = hopper::encode(tail, ptr, B, rows, H, dh, s, kTailCols, CU_TENSOR_MAP_SWIZZLE_32B,
                         box_rows);
  return err;
}

inline int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

template <typename Kernel>
int run(Kernel* kernel, int smem_bytes, long long items, const Maps& maps, const Args& a,
        cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long sms = sm_count();
  kernel<<<static_cast<unsigned>(items < sms ? items : sms), kThreads, smem_bytes, stream>>>(
      maps, a);
  return static_cast<int>(cudaGetLastError());
}

// The (batch, row, head) strides of view i of the 21 the entry points take.
inline attn::Strides strided(const long long* strides, int i) {
  return attn::Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

inline bool valid_shape(int N, int M, int dh) {
  return N >= 1 && M >= 1 && dh >= 1 && dh % 8 == 0 && dh <= hopper::kNarrowMaxHeadDim;
}

template <typename TOut, int W>
int run_dkv(long long items, const Maps& maps, const Args& a, cudaStream_t st) {
  return run(dkv_kernel<TOut, W>, DkvRing<hopper::ring_of(W)>::smem_bytes, items, maps, a, st);
}

// dq at width W: two Q buffers for short key sweeps (captions) at widths 64
// and 80, else one
template <typename TOut, int W>
int run_dq(long long items, int M, const Maps& maps, const Args& a, cudaStream_t st) {
  if constexpr (W < 128) {
    if (M <= kShortKeys) {
      return run(dq_kernel<TOut, W, 2>, DqRing<2, 80>::smem_bytes, items, maps, a, st);
    }
  }
  return run(dq_kernel<TOut, W, 1>, DqRing<1, hopper::ring_of(W)>::smem_bytes, items, maps, a,
             st);
}

// f(W) at the padded width W of dh: 64, 80, 128 or 256
template <typename F>
int at_width(int dh, F f) {
  switch (hopper::width_of(dh)) {
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 80:
      return f(std::integral_constant<int, 80>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
    default:
      return f(std::integral_constant<int, 256>{});
  }
}

}  // namespace bwd

// q/dout/dq are [B, N, H, dh] views and k/v/dk/dv [B, M, H, dh] views, each
// given by its (batch, row, head) strides in elements, in the order q, k, v,
// dout, dq, dk, dv (21 values in `strides`). q, k, v and dout are bf16 with
// a unit column stride and 16-byte aligned rows (TMA reads them in place);
// the gradients are bf16, or f32 when `f32` is non-zero. lse and delta are
// [B * H, N] f32; madd is [B, M] f32 or null. Each returns 0, the CUDA
// error code of its launch, or 10000 + the CUresult of a tensor map that
// could not be encoded.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* madd, const float* lse, const float* delta, void* dk,
                             void* dv, int f32, int B, int H, int N, int M, int dh,
                             const long long* strides, float scale, float ds_scale,
                             void* stream) {
  using namespace bwd;
  if (!valid_shape(N, M, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s3 = [&](int i) { return strided(strides, i); };
  Maps maps{};
  const int keys = hopper::keys_of(hopper::width_of(dh));
  int err = encode_view(&maps.q, nullptr, q, B, N, H, dh, s3(0), kQTile);
  if (!err) err = encode_view(&maps.dout, nullptr, dout, B, N, H, dh, s3(3), kQTile);
  if (!err) err = encode_view(&maps.k, &maps.k_tail, k, B, M, H, dh, s3(1), keys);
  if (!err) err = encode_view(&maps.v, &maps.v_tail, v, B, M, H, dh, s3(2), keys);
  if (err) return err;
  const Args a{madd, lse, delta, nullptr, dk, dv, {}, s3(5), s3(6), B, H, N, M, dh,
               scale, ds_scale};
  const long long items = static_cast<long long>((M + keys - 1) / keys) * B * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return at_width(dh, [&](auto w) {
    return f32 ? run_dkv<float, decltype(w)::value>(items, maps, a, st)
               : run_dkv<bf16, decltype(w)::value>(items, maps, a, st);
  });
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* madd, const float* lse, const float* delta, void* dq,
                            int f32, int B, int H, int N, int M, int dh,
                            const long long* strides, float scale, float ds_scale,
                            void* stream) {
  using namespace bwd;
  if (!valid_shape(N, M, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s3 = [&](int i) { return strided(strides, i); };
  Maps maps{};
  const int keys = hopper::keys_of(hopper::width_of(dh));
  int err = encode_view(&maps.q, &maps.q_tail, q, B, N, H, dh, s3(0), kRows);
  if (!err) err = encode_view(&maps.dout, &maps.dout_tail, dout, B, N, H, dh, s3(3), kRows);
  if (!err) err = encode_view(&maps.k, nullptr, k, B, M, H, dh, s3(1), keys);
  if (!err) err = encode_view(&maps.v, &maps.v_tail, v, B, M, H, dh, s3(2), keys);
  if (err) return err;
  const Args a{madd, lse, delta, dq, nullptr, nullptr, s3(4), {}, {}, B, H, N, M, dh,
               scale, ds_scale};
  const long long items = static_cast<long long>((N + kRows - 1) / kRows) * B * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return at_width(dh, [&](auto w) {
    return f32 ? run_dq<float, decltype(w)::value>(items, M, maps, a, st)
               : run_dq<bf16, decltype(w)::value>(items, M, maps, a, st);
  });
}

// Dynamic shared memory of one block (bytes) at the padded width `width`
// (64, 80, 128 or 256); keys per K/V tile (the unit of the key extent, and
// the keys of one dkv item) and the depth of dq's K/V ring over long key
// sweeps at that width, which the wrapper checks against its own.
extern "C" int flash_bwd_dkv_smem_bytes(int width) {
  return bwd::at_width(width, [](auto w) {
    return bwd::DkvRing<hopper::ring_of(decltype(w)::value)>::smem_bytes;
  });
}
extern "C" int flash_bwd_dq_smem_bytes(int width) {
  return bwd::at_width(width, [](auto w) {
    return bwd::DqRing<1, hopper::ring_of(decltype(w)::value)>::smem_bytes;
  });
}
extern "C" int flash_backward_key_tile(int width) {
  return bwd::at_width(width, [](auto w) {
    return bwd::DqRing<1, hopper::ring_of(decltype(w)::value)>::keys;
  });
}
extern "C" int flash_backward_key_stages(int width) {
  return bwd::at_width(width, [](auto w) {
    return bwd::DqRing<1, hopper::ring_of(decltype(w)::value)>::stages;
  });
}
