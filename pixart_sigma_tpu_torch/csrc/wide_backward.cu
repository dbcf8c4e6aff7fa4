// The attention backward at head dims above 256 (the wide form): dkv and dq
// over strided [B, N, H, dh] bf16 views, from the row logsumexp that the
// forward saved (log2 units); bf16 or f32 gradients.
//
// Replaces, past the narrow forms' widest width of 256, the TPU kernels
// `_bwd_dkv_kernel` and `_bwd_dq_kernel` (pixart_sigma_tpu/ops/
// flash_attention.py, called from `_flash_bwd`), with their function and
// that of flash_backward.cu:
//   s  = q.k * scale + madd[key]            (scale = dh^-0.5 * log2(e))
//   P  = exp2(s - lse[row])
//   dP = dO . v,   dS = P * (dP - delta[row]) * ds_scale,  delta = rowsum(dO * O)
//   dV = P^T dO,   dK = dS^T q,   dQ = dS k
// with P and dS rounded to bf16 before their products and f32 sums; delta
// comes from the caller in f32. The narrow forms keep a tile's Q and dO (dq)
// or K and V (dkv) in shared memory or registers at full width, which past
// 256 columns does not fit; here, as in wide_attention.cu, the head dim is
// streamed in 64-column 128B-swizzled atoms (TMA zero-fills past dh) and
// the gradients go in column groups of 128, a grid axis:
//
// - dq_kernel: a block takes 128 query rows, one column group g and one
//   batch * head. For each 64-key tile, S = Q.K^T and dP = dO.V^T are sums
//   over atoms: each atom's stage of the ring holds Q's and dO's atoms (128
//   rows) and K's and V's (64 keys), and each consumer warpgroup adds its 64
//   rows' m64n64k16 products. The next stage holds the tile's K columns of
//   the group (two atoms) and its 64 key biases (-inf past M), which the
//   producer warp writes; then dS in registers and dQ += dS.K (m64n128k16,
//   K read MN-major), 64 accumulator registers a thread.
// - dkv_kernel: a block takes 64 keys, one column group and one batch *
//   head; warpgroup 0 computes dV's columns of the group and warpgroup 1
//   dK's, as the narrow width 256 splits them. For each 64-row q tile,
//   S^T = K.Q^T (both warpgroups) and dP^T = V.dO^T (warpgroup 1) are sums
//   over atoms (a stage: K's, q's, V's and dO's atoms, 8 KB each); the next
//   stage holds the group's columns of q and dO (two atoms each) with the
//   tile's 64 lse and delta; then dV += P^T.dO or dK += dS^T.Q (m64n128k16).
// - every group recomputes S (and dP): ceil(dh / 128) times that work of one
//   pass, in the same order, so every group sees the same P.
// - the caption key extent (caption_key_extent in ops/flash_attention.py):
//   with a mask, every warp finds its batch element's last valid key (bias
//   above -1e29) in the [B, M] bias row; dq visits only the key tiles up to
//   it, and a dkv block whose keys all lie past it writes zeros. A caption
//   with no valid key keeps every tile.
// - rows past N and keys past M: TMA zero-fills them, lse is +inf and delta
//   0 past N and the bias -inf past M, so P = 0 and dS = 0 there; no row past
//   N (dQ) or M (dK, dV) is written.
//
// Warpgroup 2 is the producer (setmaxnreg gives its registers away; its
// first warp streams the stages, lane 0 issuing the copies), warpgroups 0
// and 1 the consumers; each consumer waits for a stage, issues its products,
// waits for them and releases the stage. Two kernels, no atomics: each sum
// is taken in one block's registers in a fixed order, so the gradients are
// deterministic.
//
// Bound on the card: at the 1024px training shapes (B = 4, N = M = 4096,
// H * dh = 1152) one pass is four products of 2 N M dh flops per head for
// dkv (618 GFLOP, 0.625 ms at 989 TFLOP/s) and three for dq (464 GFLOP,
// 0.469 ms), against ~230 MB of operands: the tensor cores bound both.
//
// Needs dh % 8 == 0, dh > 0 and 16-byte aligned strides (TMA), which the
// Python wrapper arranges; the wrapper sends only dh > 256 here.

#include "hopper_common.cuh"

namespace wide_bwd {

using attn::bf16;
using hopper::kMainCols;
using hopper::kSwizzle128;

constexpr int kThreads = 384;    // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kRows = 128;       // query rows per dq block
constexpr int kKeys = 64;        // keys per dq K/V tile and per dkv block
constexpr int kQTile = 64;       // query rows per dkv q/dO tile
constexpr int kGroupCols = 128;  // gradient columns per group (two atoms)
constexpr int kAtom = 64 * 128;  // a 64-row 64-column 128B atom (8 KB)

// dq's stages: an atom stage holds Q's atom (128 rows) at 0, K's at kDqK,
// dO's at kDqDo and V's at kDqV; a group stage K's two atoms of the group at
// 0 and kAtom and the tile's biases at kDqBias.
constexpr int kDqK = 2 * kAtom, kDqDo = 3 * kAtom, kDqV = 5 * kAtom, kDqBias = 6 * kAtom;
constexpr int kDqStage = kDqBias + 1024, kDqStages = 4;
// dkv's: an atom stage K's atom at 0, q's at kAtom, V's at 2 kAtom and dO's
// at 3 kAtom; a group stage q's two atoms of the group at 0, dO's at
// kDkvDo, the tile's lse at kDkvLse and delta at kDkvDelta.
constexpr int kDkvDo = 2 * kAtom, kDkvLse = 4 * kAtom, kDkvDelta = kDkvLse + 4 * kQTile;
constexpr int kDkvStage = kDkvLse + 1024, kDkvStages = 6;

template <int kStageBytes, int kStages>
struct Ring {
  static constexpr int stages = kStages;
  static constexpr int bar_offset = kStages * kStageBytes;
  static constexpr int smem_bytes = bar_offset + 2 * kStages * 8 + 1024;
  static_assert(smem_bytes <= 232448, "more shared memory than a block may use");
  __device__ static uint32_t full(uint32_t base, int pos) {
    return base + bar_offset + 8 * (pos % kStages);
  }
  __device__ static uint32_t empty(uint32_t base, int pos) {
    return base + bar_offset + 8 * (kStages + pos % kStages);
  }
  __device__ static uint32_t stage(uint32_t base, int pos) {
    return base + (pos % kStages) * kStageBytes;
  }
  // the consumers' wait for stage `pos`, and the producer's for it to be free
  __device__ static void wait_full(uint32_t base, int pos) {
    hopper::mbar_wait(full(base, pos), (pos / kStages) & 1);
  }
  __device__ static void wait_empty(uint32_t base, int pos) {
    if (pos >= kStages) hopper::mbar_wait(empty(base, pos), ((pos / kStages) - 1) & 1);
  }
};
using DqRing = Ring<kDqStage, kDqStages>;
using DkvRing = Ring<kDkvStage, kDkvStages>;

struct Maps {
  CUtensorMap q, dout, k, v;  // 64-column 128B-swizzled boxes
};

struct Args {
  const float* madd;   // [B, M] additive key mask (0 / -1e30) or null
  const float* lse;    // [B * H, N] log2 units
  const float* delta;  // [B * H, N]
  void* dq;            // [B, N, H, dh] views, bf16 or f32
  void* dk;
  void* dv;
  attn::Strides dqs, dks, dvs;
  int B, H, N, M, dh, atoms;
  float scale;     // logit scale in log2 units
  float ds_scale;  // the chain factor of dS (ln 2 * scale for exp2)
};

// ---------------------------------------------------------------- device

// Key tiles that batch element b's rows need, found by the calling warp
// (all 32 lanes) from its bias row: the last valid key (bias above -1e29),
// plus one, in whole tiles. With no mask or no valid key, all tiles.
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

// Accumulator pairs (8 kk + 2 i, 8 kk + 2 i + 1) of an m64n64 product,
// rounded to bf16: the A fragments of the next product.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = attn::pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// acc, an m64n128 accumulator (per warp w and lane 4 g + t, acc[4 c + e]
// holds row 16 w + g (+ 8 for e >= 2), column 8 c + 2 t + (e & 1) of the
// group), into rows r0 and r0 + 8 below `rows`, columns from col0 below dh.
template <typename TOut>
__device__ __forceinline__ void store_rows(const float (&acc)[64], void* out,
                                           const attn::Strides& s, int b, int h, int r0,
                                           int rows, int col0, int dh) {
  const int t = threadIdx.x & 3;
  TOut* base = static_cast<TOut*>(out) + b * s.sb + h * s.sh;
  TOut* o0 = base + static_cast<long long>(r0) * s.sn;
  TOut* o1 = o0 + 8 * s.sn;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int col = col0 + 8 * c + 2 * t;
    if (col < dh) {  // dh % 8 == 0, so col + 1 < dh too
      if (r0 < rows) attn::store_pair(o0 + col, acc[4 * c], acc[4 * c + 1]);
      if (r0 + 8 < rows) attn::store_pair(o1 + col, acc[4 * c + 2], acc[4 * c + 3]);
    }
  }
}

// The sum over atoms of an m64n64 product into d, from an atom stage at st:
// A at st + a_off (+ a_rows, this warpgroup's rows), B at st + b_off, both
// K-major; the first k-step of atom 0 starts the sum.
__device__ __forceinline__ void atom_products(float (&d)[32], uint32_t st, int a_off, int b_off,
                                              int at) {
  const uint64_t da = hopper::smem_desc(st + a_off, 1024, kSwizzle128);
  const uint64_t db = hopper::smem_desc(st + b_off, 1024, kSwizzle128);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::wgmma_ss_n64(d, da + 2 * kk, db + 2 * kk, at + kk > 0);
}

// acc += A.B for the four k-steps of 16: A the register fragments a, B the
// group's two atoms at st (MN-major, kAtom apart, 16 rows of 128 bytes a step).
__device__ __forceinline__ void group_product(float (&acc)[64], const uint32_t (&a)[4][4],
                                              uint32_t st) {
  const uint64_t db = hopper::smem_desc(st, 1024, kSwizzle128, kAtom);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::wgmma_rs_n128(acc, a[kk], db + kk * (16 * 128 / 16));
}

// ---------------------------------------------------------------- dq

template <typename TOut>
__device__ __forceinline__ void dq_consume(const Args& a, uint32_t base, int wg) {
  using R = DqRing;
  const int tq = blockIdx.x, g = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int ntiles = key_tiles(a, b);
  const int r0 = tq * kRows + 64 * wg + 16 * warp + gq;
  const float* lse = a.lse + static_cast<long long>(bh) * a.N;
  const float* delta = a.delta + static_cast<long long>(bh) * a.N;
  const float lse0 = r0 < a.N ? __ldg(lse + r0) : CUDART_INF_F;
  const float lse1 = r0 + 8 < a.N ? __ldg(lse + r0 + 8) : CUDART_INF_F;
  const float dl0 = r0 < a.N ? __ldg(delta + r0) : 0.f;
  const float dl1 = r0 + 8 < a.N ? __ldg(delta + r0 + 8) : 0.f;
  const int rows = wg * kAtom;  // this warpgroup's 64 rows of a 128-row atom

  float s[32], dp[32], acc[64];
  uint32_t ds[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int pos = 0;
  auto release = [&]() {
    if (lane == 0) hopper::mbar_arrive(R::empty(base, pos));
    ++pos;
  };
  for (int j = 0; j < ntiles; ++j) {
    // S = Q.K^T and dP = dO.V^T, atom by atom
    for (int at = 0; at < a.atoms; ++at) {
      R::wait_full(base, pos);
      hopper::wgmma_fence();
      const uint32_t st = R::stage(base, pos);
      atom_products(s, st, rows, kDqK, at);
      atom_products(dp, st, kDqDo + rows, kDqV, at);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::hold(s);
      hopper::hold(dp);
      release();
    }
    // the group stage: dS = P (dP - delta) ds_scale, then dQ += dS.K
    R::wait_full(base, pos);
    const uint32_t st = R::stage(base, pos);
    const uint32_t bias = st + kDqBias + 8 * t;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float b0, b1;
      ld_shared_v2(bias + 32 * c, b0, b1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = attn::fast_exp2(fmaf(s[4 * c + e], a.scale, (e & 1) ? b1 : b0) -
                                        (e < 2 ? lse0 : lse1));
        dp[4 * c + e] = p * (dp[4 * c + e] - (e < 2 ? dl0 : dl1)) * a.ds_scale;
      }
    }
    pack_a(ds, dp);
    hopper::wgmma_fence();
    group_product(acc, ds, st);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::hold(acc);
    hopper::hold(ds);
    release();
  }
  store_rows<TOut>(acc, a.dq, a.dqs, b, h, r0, a.N, g * kGroupCols, a.dh);
}

__device__ __forceinline__ void dq_produce(const Maps& maps, const Args& a, uint32_t base) {
  using R = DqRing;
  const int q0 = blockIdx.x * kRows, g = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, h = bh - b * a.H;
  const int lane = threadIdx.x & 31;
  const bool issue = lane == 0;
  const int ntiles = key_tiles(a, b);
  int pos = 0;
  for (int j = 0; j < ntiles; ++j) {
    const int key0 = j * kKeys;
    for (int at = 0; at < a.atoms; ++at, ++pos) {
      if (issue) {
        R::wait_empty(base, pos);
        const uint32_t st = R::stage(base, pos), full = R::full(base, pos);
        const int col = at * kMainCols;
        hopper::mbar_expect_tx(full, 6 * kAtom);
        hopper::tma_load(st, &maps.q, full, col, h, q0, b);
        hopper::tma_load(st + kDqK, &maps.k, full, col, h, key0, b);
        hopper::tma_load(st + kDqDo, &maps.dout, full, col, h, q0, b);
        hopper::tma_load(st + kDqV, &maps.v, full, col, h, key0, b);
      }
    }
    float bias[kKeys / 32];  // loaded before the wait, so their latency hides behind it
#pragma unroll
    for (int e = 0; e < kKeys / 32; ++e) bias[e] = key_bias(a, b, key0 + 32 * e + lane);
    const uint32_t st = R::stage(base, pos), full = R::full(base, pos);
    if (issue) {
      R::wait_empty(base, pos);
      hopper::mbar_tx(full, 2 * kAtom);
      for (int c = 0; c < 2; ++c)  // an atom wholly past dh is zero-filled
        hopper::tma_load(st + c * kAtom, &maps.k, full, g * kGroupCols + c * kMainCols, h, key0,
                         b);
    }
    __syncwarp();  // lane 0 has seen the stage free
#pragma unroll
    for (int e = 0; e < kKeys / 32; ++e)
      hopper::st_shared(st + kDqBias + 4 * (32 * e + lane), __float_as_uint(bias[e]));
    __syncwarp();
    if (issue) hopper::mbar_arrive(full);  // publishes the biases (a release)
    ++pos;
  }
}

// ---------------------------------------------------------------- dkv

// Warpgroup 0 (kDk false) computes dV's columns of the group, warpgroup 1
// (kDk true) dK's, for the block's 64 keys: rows 16 w + g and + 8 of warp w.
template <typename TOut, bool kDk>
__device__ __forceinline__ void dkv_consume(const Args& a, uint32_t base) {
  using R = DkvRing;
  const int kt = blockIdx.x, g = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int ntiles = key_tiles(a, b);
  const int nqt = (a.N + kQTile - 1) / kQTile;
  const int r0 = kt * kKeys + 16 * warp + (lane >> 2);  // this thread's keys r0, r0 + 8

  float s[32], dp[32], acc[64];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  if (kt < ntiles) {  // else every key lies past the extent: dK = dV = 0
    const float bias0 = key_bias(a, b, r0), bias1 = key_bias(a, b, r0 + 8);
    int pos = 0;
    auto release = [&]() {
      if (lane == 0) hopper::mbar_arrive(R::empty(base, pos));
      ++pos;
    };
    for (int i = 0; i < nqt; ++i) {
      // S^T = K.Q^T and, for dK, dP^T = V.dO^T, atom by atom
      for (int at = 0; at < a.atoms; ++at) {
        R::wait_full(base, pos);
        hopper::wgmma_fence();
        const uint32_t st = R::stage(base, pos);
        atom_products(s, st, 0, kAtom, at);
        if (kDk) atom_products(dp, st, 2 * kAtom, 3 * kAtom, at);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::hold(s);
        hopper::hold(dp);
        release();
      }
      // the group stage: P^T = exp2(s * scale + bias - lse); for dK,
      // dS^T = P^T (dP^T - delta) ds_scale; then dV += P^T.dO or dK += dS^T.Q
      R::wait_full(base, pos);
      const uint32_t st = R::stage(base, pos);
      const uint32_t side = st + 8 * t;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float l0, l1, d0, d1;
        ld_shared_v2(side + kDkvLse + 32 * c, l0, l1);
        ld_shared_v2(side + kDkvDelta + 32 * c, d0, d1);
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
      group_product(acc, pa, st + (kDk ? 0 : kDkvDo));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::hold(acc);
      hopper::hold(pa);
      release();
    }
  }
  store_rows<TOut>(acc, kDk ? a.dk : a.dv, kDk ? a.dks : a.dvs, b, h, r0, a.M, g * kGroupCols,
                   a.dh);
}

__device__ __forceinline__ void dkv_produce(const Maps& maps, const Args& a, uint32_t base) {
  using R = DkvRing;
  const int kt = blockIdx.x, g = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, h = bh - b * a.H;
  const int lane = threadIdx.x & 31;
  const bool issue = lane == 0;
  if (kt >= key_tiles(a, b)) return;  // the consumers write zeros
  const int nqt = (a.N + kQTile - 1) / kQTile;
  const int key0 = kt * kKeys;
  const float* lse = a.lse + static_cast<long long>(bh) * a.N;
  const float* delta = a.delta + static_cast<long long>(bh) * a.N;
  int pos = 0;
  for (int i = 0; i < nqt; ++i) {
    const int q0 = i * kQTile;
    for (int at = 0; at < a.atoms; ++at, ++pos) {
      if (issue) {
        R::wait_empty(base, pos);
        const uint32_t st = R::stage(base, pos), full = R::full(base, pos);
        const int col = at * kMainCols;
        hopper::mbar_expect_tx(full, 4 * kAtom);
        hopper::tma_load(st, &maps.k, full, col, h, key0, b);
        hopper::tma_load(st + kAtom, &maps.q, full, col, h, q0, b);
        hopper::tma_load(st + 2 * kAtom, &maps.v, full, col, h, key0, b);
        hopper::tma_load(st + 3 * kAtom, &maps.dout, full, col, h, q0, b);
      }
    }
    float l[2], d[2];  // loaded before the wait, so their latency hides behind it
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = q0 + 32 * e + lane;
      l[e] = row < a.N ? __ldg(lse + row) : CUDART_INF_F;
      d[e] = row < a.N ? __ldg(delta + row) : 0.f;
    }
    const uint32_t st = R::stage(base, pos), full = R::full(base, pos);
    if (issue) {
      R::wait_empty(base, pos);
      hopper::mbar_tx(full, 4 * kAtom);
      for (int c = 0; c < 2; ++c) {  // an atom wholly past dh is zero-filled
        const int col = g * kGroupCols + c * kMainCols;
        hopper::tma_load(st + c * kAtom, &maps.q, full, col, h, q0, b);
        hopper::tma_load(st + kDkvDo + c * kAtom, &maps.dout, full, col, h, q0, b);
      }
    }
    __syncwarp();  // lane 0 has seen the stage free
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      hopper::st_shared(st + kDkvLse + 4 * (32 * e + lane), __float_as_uint(l[e]));
      hopper::st_shared(st + kDkvDelta + 4 * (32 * e + lane), __float_as_uint(d[e]));
    }
    __syncwarp();
    if (issue) hopper::mbar_arrive(full);  // publishes lse and delta (a release)
    ++pos;
  }
}

// ---------------------------------------------------------------- kernels

}  // namespace wide_bwd

// The ring's barriers: full[s] (the producer's arrive) and empty[s] (lane 0
// of each consumer warp); returns the 1024-aligned base of shared memory.
template <typename R>
__device__ __forceinline__ uint32_t wide_bwd_setup() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (attn::smem_addr(smem_raw) + 1023) & ~1023u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::stages; ++s) {
      hopper::mbar_init(R::full(base, s), 1);
      hopper::mbar_init(R::empty(base, s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return base;
}

template <typename TOut>
__global__ void __launch_bounds__(wide_bwd::kThreads, 1)
    wide_dq_kernel(const __grid_constant__ wide_bwd::Maps maps, const wide_bwd::Args a) {
  const uint32_t base = wide_bwd_setup<wide_bwd::DqRing>();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 2 * 128 + 32) wide_bwd::dq_produce(maps, a, base);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    wide_bwd::dq_consume<TOut>(a, base, wg);
  }
}

template <typename TOut>
__global__ void __launch_bounds__(wide_bwd::kThreads, 1)
    wide_dkv_kernel(const __grid_constant__ wide_bwd::Maps maps, const wide_bwd::Args a) {
  const uint32_t base = wide_bwd_setup<wide_bwd::DkvRing>();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 2 * 128 + 32) wide_bwd::dkv_produce(maps, a, base);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    if (wg == 0) {
      wide_bwd::dkv_consume<TOut, false>(a, base);
    } else {
      wide_bwd::dkv_consume<TOut, true>(a, base);
    }
  }
}

namespace wide_bwd {

// The (batch, row, head) strides of view i of the 21 the entry points take.
inline attn::Strides strided(const long long* strides, int i) {
  return attn::Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

inline int encode(CUtensorMap* map, const void* ptr, int B, int rows, int H, int dh,
                  const attn::Strides& s, int box_rows) {
  return hopper::encode(map, ptr, B, rows, H, dh, s, kMainCols, CU_TENSOR_MAP_SWIZZLE_128B,
                        box_rows);
}

// One launch of `kernel` over blocks (row tiles, groups, B * H).
template <typename Kernel>
int run(Kernel* kernel, int smem_bytes, int tiles, const Maps& maps, const Args& a,
        cudaStream_t stream) {
  const long long groups = (a.dh + kGroupCols - 1) / kGroupCols, bhs = 1LL * a.B * a.H;
  if (groups > 65535 || bhs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles, static_cast<unsigned>(groups), static_cast<unsigned>(bhs));
  kernel<<<grid, kThreads, smem_bytes, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

inline bool valid_shape(int N, int M, int dh) {
  return N >= 1 && M >= 1 && dh >= 1 && dh % 8 == 0;
}

}  // namespace wide_bwd

// The arguments of flash_bwd_dkv and flash_bwd_dq (flash_backward.cu): q,
// dout, dq are [B, N, H, dh] views and k, v, dk, dv [B, M, H, dh] views,
// each given by its (batch, row, head) strides in elements, in the order q,
// k, v, dout, dq, dk, dv (21 values in `strides`); q, k, v and dout bf16
// with a unit column stride and 16-byte aligned rows; the gradients bf16, or
// f32 when `f32` is non-zero; lse and delta [B * H, N] f32; madd [B, M] f32
// or null. Each returns 0, the CUDA error code of its launch, or 10000 + the
// CUresult of a tensor map that could not be encoded.
extern "C" int wide_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const float* madd, const float* lse, const float* delta, void* dk,
                            void* dv, int f32, int B, int H, int N, int M, int dh,
                            const long long* strides, float scale, float ds_scale,
                            void* stream) {
  using namespace wide_bwd;
  if (!valid_shape(N, M, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s3 = [&](int i) { return strided(strides, i); };
  Maps maps{};
  int err = encode(&maps.q, q, B, N, H, dh, s3(0), kQTile);
  if (!err) err = encode(&maps.dout, dout, B, N, H, dh, s3(3), kQTile);
  if (!err) err = encode(&maps.k, k, B, M, H, dh, s3(1), kKeys);
  if (!err) err = encode(&maps.v, v, B, M, H, dh, s3(2), kKeys);
  if (err) return err;
  const Args a{madd, lse, delta, nullptr, dk, dv, {}, s3(5), s3(6), B, H, N, M, dh,
               (dh + kMainCols - 1) / kMainCols, scale, ds_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (M + kKeys - 1) / kKeys;
  return f32 ? run(wide_dkv_kernel<float>, DkvRing::smem_bytes, tiles, maps, a, st)
             : run(wide_dkv_kernel<bf16>, DkvRing::smem_bytes, tiles, maps, a, st);
}

extern "C" int wide_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const float* madd, const float* lse, const float* delta, void* dq,
                           int f32, int B, int H, int N, int M, int dh, const long long* strides,
                           float scale, float ds_scale, void* stream) {
  using namespace wide_bwd;
  if (!valid_shape(N, M, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s3 = [&](int i) { return strided(strides, i); };
  Maps maps{};
  int err = encode(&maps.q, q, B, N, H, dh, s3(0), kRows);
  if (!err) err = encode(&maps.dout, dout, B, N, H, dh, s3(3), kRows);
  if (!err) err = encode(&maps.k, k, B, M, H, dh, s3(1), kKeys);
  if (!err) err = encode(&maps.v, v, B, M, H, dh, s3(2), kKeys);
  if (err) return err;
  const Args a{madd, lse, delta, dq, nullptr, nullptr, s3(4), {}, {}, B, H, N, M, dh,
               (dh + kMainCols - 1) / kMainCols, scale, ds_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (N + kRows - 1) / kRows;
  return f32 ? run(wide_dq_kernel<float>, DqRing::smem_bytes, tiles, maps, a, st)
             : run(wide_dq_kernel<bf16>, DqRing::smem_bytes, tiles, maps, a, st);
}

// Dynamic shared memory of one block (bytes); keys per K/V tile (the unit of
// the key extent, and the keys of one dK/dV block) and gradient columns per
// group, which the wrapper checks.
extern "C" int wide_bwd_dkv_smem_bytes() { return wide_bwd::DkvRing::smem_bytes; }
extern "C" int wide_bwd_dq_smem_bytes() { return wide_bwd::DqRing::smem_bytes; }
extern "C" int wide_backward_key_tile() { return wide_bwd::kKeys; }
extern "C" int wide_backward_group_cols() { return wide_bwd::kGroupCols; }
