// The streamed attention forward that onepass_attention.cu and
// flash_forward.cu share, written for Hopper (sm_90a): wgmma for both
// products, a TMA/mbarrier ring for K/V, and the softmax of one warpgroup
// overlapped with the tensor-core work of the other.
//
// A persistent grid: one block of three warpgroups per SM walks the work
// items (128 query rows, batch * head), query tiles fastest, so that the
// blocks in flight share one head's K/V in the 50 MB L2, and the loads of
// the next item overlap the end of the current one:
// - warpgroup 2 is the producer. It gives its registers to the consumers
//   (setmaxnreg), and one of its threads loads each item's Q into one of two
//   buffers and its K/V tiles of 128 keys into a ring of kStages
//   shared-memory stages with TMA (cp.async.bulk.tensor). Each stage and
//   each Q buffer has a "full" mbarrier, which the copies' bytes complete,
//   and an "empty" one, on which the eight consumer warps release it. No
//   thread computes a copy address.
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
// The head dim (a multiple of 8 up to 80) is split in two column chunks, as
// a 128-byte TMA swizzle row holds 64 bf16: columns [0, 64) in 128-byte rows
// with the 128B swizzle; for Q and K (K-major) columns [64, 80) in 32-byte
// rows with the 32B swizzle, so Q.K^T runs 4 + 1 k-steps of 16; for V
// (MN-major, whose swizzle atom is 64 columns wide) columns [64, 128) as a
// second 128B atom, so P.V is one N = 80 product per 16 keys. TMA
// zero-fills the columns past dh and the rows past N or M, so the padding
// never reaches device memory; with dh <= 64 the second chunks are skipped.
//
// The softmax runs in f32 in log2 units: one FFMA folds the logit scale and
// the running max into each exponent (exp2(s * scale - m)). With a key mask
// the bias is added first (s * scale + bias): the wrapper pads the bias rows
// to whole tiles with -inf, and the producer copies each tile's 128 biases
// into shared memory beside its K/V, so the consumers test no bounds.
// Without one, keys past M get the logit -inf in the last tile. `tail`
// padded keys at logit -1e30 join each row's denominator at the end, as the
// TPU kernels pad K/V.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "attention_common.cuh"

namespace hopper {

constexpr int kRows = 128;     // query rows per block: two consumer warpgroups x 64
constexpr int kKeys = 128;     // keys per tile, the wgmma N of S = Q.K^T
constexpr int kStages = 3;     // depth of the K/V ring
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kMainCols = 64;  // head-dim columns [0, 64): 128-byte rows, 128B swizzle
constexpr int kTailCols = 16;  // Q and K columns [64, 80): 32-byte rows, 32B swizzle
constexpr int kMainTile = kKeys * kMainCols * 2;  // 16384 B
constexpr int kTailTile = kKeys * kTailCols * 2;  // 4096 B
static_assert(kRows == kKeys, "Q and K/V chunks share one TMA box");
// One stage (each part 1024-byte aligned): K main, V main, V columns
// [64, 128) as a second 128B-swizzled atom right after V main (TMA
// zero-fills the columns past dh), so that one wgmma of N = 80 reads both,
// and the K tail.
constexpr int kVOff = kMainTile, kVTailOff = 2 * kMainTile, kKTailOff = 3 * kMainTile;
constexpr int kStageBytes = 3 * kMainTile + kTailTile;
// The block: two Q buffers (main, tail), the stages, each stage's 128 mask
// biases, then the barriers full[kStages], empty[kStages], qfull[2] and
// qempty[2]; 1024 bytes of slack to align the base.
constexpr int kQBytes = kMainTile + kTailTile;
constexpr int kStagesOffset = 2 * kQBytes;
constexpr int kBiasBytes = kKeys * 4;
constexpr int kBiasOffset = kStagesOffset + kStages * kStageBytes;
constexpr int kBarOffset = kBiasOffset + kStages * kBiasBytes;
constexpr int kSmemBytes = kBarOffset + (2 * kStages + 4) * 8 + 1024;
constexpr int kEncodeError = 10000;  // + CUresult of a failed tensor-map encode

// TMA descriptors of the bf16 [B, rows, H, dh] views: 64-column boxes with
// the 128B swizzle (V's second chunk is the same box at column 64), and
// 16-column boxes with the 32B swizzle for the tails of Q and K.
struct Maps {
  CUtensorMap q, q_tail, k, k_tail, v;
};

struct Args {
  const float* madd;  // [B, pad128(M)] additive key mask (0 / -1e30; -inf past M) or null
  void* o;            // [B, N, H, dh], bf16 or f32
  float* lse;         // [B * H, N] row logsumexp in log2 units, or null
  attn::Strides os;
  int B, H, N, M, dh;
  float scale;  // logit scale in log2 units
  float m0;     // the running max before any key
  int tail;     // padded keys at logit -1e30 that join each row's denominator
};

// ---------------------------------------------------------------- device

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the barrier's phase of `parity` completes. A wait that lasts
// 2^28 polls (many seconds) traps, so a pipeline fault ends the launch with
// an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) into shared memory at `dst`; they complete the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A box of the 4D map (coordinates: column, head, row, batch) into shared
// memory at `dst`; its bytes complete the mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// Named barriers 1 and 2 over the 256 consumer threads (0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wait that ends it.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void hold(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

constexpr uint64_t kSwizzle128 = 1, kSwizzle32 = 3;

// wgmma shared-memory matrix descriptor: start address, leading byte offset
// (for an MN-major operand, the distance between its 64-column swizzle
// atoms; unused by K-major ones), stride byte offset between 8-row groups
// (8 rows of 128 or 32 bytes) and the swizzle mode; offsets in 16-byte
// units. Adding n to a descriptor moves its start by 16 n bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t group_bytes,
                                              uint64_t swizzle, uint32_t atom_bytes = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(atom_bytes >> 4) << 16) |
         (static_cast<uint64_t>(group_bytes >> 4) << 32) | (swizzle << 62);
}

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A from registers, B MN-major in
// shared memory (d[32..39] untouched).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 80] += A[64 x 16] . B[16 x 80]: as wgmma_rs_n64, B spanning two
// 64-column swizzle atoms.
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Accumulator layout of wgmma m64nN (per warp w of the warpgroup, lane =
// 4 g + t): d[4 c + e] holds row 16 w + g (e < 2) or 16 w + g + 8 (e >= 2),
// column 8 c + 2 t + (e & 1). Two 8-column chunks of S are one 16-key A
// fragment of P, so P never leaves registers.

// The consumer warpgroup `wg` (0 or 1): its 64 query rows against every key.
// kTail: dh > 64, so the products also run columns [64, 80).
template <typename TOut, bool kMask, bool kTail>
__device__ __forceinline__ void consume(const Args& a, uint32_t base, int wg, int ntq,
                                        int items, int ntiles) {
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t bars = base + kBarOffset;
  // ring position `it` + tile j of the current item
  int it = 0;
  auto stage = [&](int j) { return base + kStagesOffset + ((it + j) % kStages) * kStageBytes; };

  float s[64], o[40];
  uint32_t p[8][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0u;
  float m_0, m_1, l_0, l_1;
  uint64_t dq, dq_tail;
  const float sc = kMask ? 1.f : a.scale;  // the scale left after the mask step

  // Tile j has arrived and it is this warpgroup's turn on the tensor cores.
  auto acquire = [&](int j) {
    mbar_wait(bars + 8 * ((it + j) % kStages), ((it + j) / kStages) & 1);
    bar_sync(1 + wg);
    wgmma_fence();
  };
  // The other consumer's turn; lane 0 of each warp releases tile j's stage.
  auto pass_turn = [&]() { bar_arrive(2 - wg); };
  auto release = [&](int j) {
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + (it + j) % kStages));
  };
  // S = Q.K^T of tile j, one commit group.
  auto issue_s = [&](int j) {
    const uint32_t st = stage(j);
    const uint64_t dk = smem_desc(st, 1024, kSwizzle128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    if (kTail) wgmma_ss_n128(s, dq_tail, smem_desc(st + kKTailOff, 256, kSwizzle32), 1);
    wgmma_commit();
  };
  // O += P.V of tile j (P of that tile in p), one commit group: a k-step
  // is 16 key rows of 128 bytes in each of V's two atoms.
  auto issue_pv = [&](int j) {
    const uint64_t dv = smem_desc(stage(j) + kVOff, 1024, kSwizzle128, kVTailOff - kVOff);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kTail) {
        wgmma_rs_n80(o, p[kk], dv + kk * (16 * 128 / 16));
      } else {
        wgmma_rs_n64(o, p[kk], dv + kk * (16 * 128 / 16));
      }
    }
    wgmma_commit();
  };
  // Tile j's softmax on its logits in s: the new row max mn and, in s,
  // p = exp2(logit - mn), with their row sums ls (this thread's share).
  auto softmax = [&](int j, float& mn0, float& mn1, float& ls0, float& ls1) {
    const int key0 = j * kKeys;
    if (kMask) {  // the tile's biases, -inf past M, arrived with its K/V
      const uint32_t bias = base + kBiasOffset + ((it + j) % kStages) * kBiasBytes + 8 * t;
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
    for (int c = 0; c < 10; ++c) {
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

  if (wg == 1) pass_turn();  // warpgroup 0 issues first
  int n = 0;  // items done by this block
  for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
    const int bh = w / ntq;
    const int b = bh / a.H, h = bh - b * a.H;
    const int q0 = (w - bh * ntq) * kRows;
    const uint32_t qbuf = base + (n & 1) * kQBytes;
    dq = smem_desc(qbuf + wg * (kMainTile / 2), 1024, kSwizzle128);
    dq_tail = smem_desc(qbuf + kMainTile + wg * (kTailTile / 2), 256, kSwizzle32);
    m_0 = m_1 = a.m0;
    l_0 = l_1 = 0.f;
#pragma unroll
    for (int i = 0; i < 40; ++i) o[i] = 0.f;
    mbar_wait(bars + 8 * (2 * kStages + (n & 1)), (n >> 1) & 1);  // this item's Q

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
      release(j - 1);
      rescale_pack(mn0, mn1, ls0, ls1);
    }
    bar_sync(1 + wg);
    wgmma_fence();
    issue_pv(ntiles - 1);
    pass_turn();
    wgmma_wait<0>();
    hold(o);
    release(ntiles - 1);
    if (lane == 0) mbar_arrive(bars + 8 * (2 * kStages + 2 + (n & 1)));  // Q buffer free
    it += ntiles;

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
    TOut* out = static_cast<TOut*>(a.o) + b * a.os.sb + h * a.os.sh;
    TOut* o0 = out + static_cast<long long>(r0) * a.os.sn;
    TOut* o1 = out + static_cast<long long>(r1) * a.os.sn;
#pragma unroll
    for (int c = 0; c < 10; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < a.dh) {  // dh % 8 == 0, so col + 1 < dh too
        if (r0 < a.N) attn::store_pair(o0 + col, o[4 * c] * i0, o[4 * c + 1] * i0);
        if (r1 < a.N) attn::store_pair(o1 + col, o[4 * c + 2] * i1, o[4 * c + 3] * i1);
      }
    }
  }
  if (wg == 0) bar_sync(1);  // matches warpgroup 1's last arrive
}

// The kernel's body: the producer's loads, or a consumer's rows. The grid
// is persistent: block i takes the work items (query tile, batch * head)
// i, i + gridDim.x, ..., query tiles fastest, so the blocks in flight share
// a head's K/V in L2, and the producer loads the next item's Q and first
// K/V tiles while the consumers finish the current one.
template <typename TOut, bool kMask>
__device__ __forceinline__ void attention_body(const Maps& maps, const Args& a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (attn::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + kBarOffset;
  const int ntq = (a.N + kRows - 1) / kRows;
  const int items = ntq * a.B * a.H;
  const int ntiles = (a.M + kKeys - 1) / kKeys;
  const bool has_tail = a.dh > kMainCols;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);              // full: the producer's expect_tx
      mbar_init(bars + 8 * (kStages + s), 8);  // empty: lane 0 of each consumer warp
    }
    for (int q = 0; q < 2; ++q) {
      mbar_init(bars + 8 * (2 * kStages + q), 1);      // qfull
      mbar_init(bars + 8 * (2 * kStages + 2 + q), 8);  // qempty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 2 * 128) {
      const uint32_t chunk = has_tail ? kMainTile + kTailTile : kMainTile;
      const uint32_t tile_bytes =
          (has_tail ? kStageBytes : 2 * kMainTile) + (a.madd ? kBiasBytes : 0);
      int it = 0;  // ring position of the item's first tile
      int n = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
        const int bh = w / ntq;
        const int b = bh / a.H, h = bh - b * a.H;
        const int q0 = (w - bh * ntq) * kRows;
        const uint32_t qfull = bars + 8 * (2 * kStages + (n & 1));
        if (n >= 2) mbar_wait(bars + 8 * (2 * kStages + 2 + (n & 1)), ((n >> 1) - 1) & 1);
        const uint32_t qbuf = base + (n & 1) * kQBytes;
        mbar_expect_tx(qfull, chunk);
        tma_load(qbuf, &maps.q, qfull, 0, h, q0, b);
        if (has_tail) tma_load(qbuf + kMainTile, &maps.q_tail, qfull, kMainCols, h, q0, b);
        for (int j = 0; j < ntiles; ++j, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(bars + 8 * (kStages + s), ((it / kStages) - 1) & 1);
          const uint32_t st = base + kStagesOffset + s * kStageBytes;
          const uint32_t full = bars + 8 * s;
          const int key0 = j * kKeys;
          mbar_expect_tx(full, tile_bytes);
          tma_load(st, &maps.k, full, 0, h, key0, b);
          tma_load(st + kVOff, &maps.v, full, 0, h, key0, b);
          if (has_tail) {
            tma_load(st + kVTailOff, &maps.v, full, kMainCols, h, key0, b);
            tma_load(st + kKTailOff, &maps.k_tail, full, kMainCols, h, key0, b);
          }
          if (a.madd) {
            bulk_load(base + kBiasOffset + s * kBiasBytes,
                      a.madd + static_cast<long long>(b) * ntiles * kKeys + key0, kBiasBytes,
                      full);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    if (has_tail) {
      consume<TOut, kMask, true>(a, base, wg, ntq, items, ntiles);
    } else {
      consume<TOut, kMask, false>(a, base, wg, ntq, items, ntiles);
    }
  }
}

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library that the process already
// uses, so the kernels link against nothing beyond the CUDA runtime.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A bf16 [B, rows, H, dh] view with element strides `s` as a 4D map over
// (column, head, row, batch): boxes of `cols` columns x 128 rows of one head,
// zero-filled past dh and past `rows`.
inline int encode(CUtensorMap* map, const void* ptr, int B, int rows, int H, int dh,
                  const attn::Strides& s, int cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.sh) * 2,
                                 static_cast<cuuint64_t>(s.sn) * 2,
                                 static_cast<cuuint64_t>(s.sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, kKeys, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

struct Launch {
  Maps maps;
  Args args;
  dim3 grid;
};

// Tensor maps, arguments and grid of one launch over bf16 q/k/v.
inline int prepare(Launch& l, const void* q, const void* k, const void* v, const float* madd,
                   void* o, float* lse, int B, int H, int N, int M, int dh,
                   const attn::Strides& qs, const attn::Strides& ks, const attn::Strides& vs,
                   const attn::Strides& os, float scale, float m0, int tail) {
  if (N < 1 || M < 1 || tail < 0 || dh % 8 || dh > kMainCols + kTailCols)
    return static_cast<int>(cudaErrorInvalidValue);
  l = Launch{};
  struct View {
    CUtensorMap *main, *rest;
    const void* ptr;
    int rows;
    const attn::Strides* s;
  };
  const View views[3] = {{&l.maps.q, &l.maps.q_tail, q, N, &qs},
                         {&l.maps.k, &l.maps.k_tail, k, M, &ks},
                         {&l.maps.v, nullptr, v, M, &vs}};
  for (const View& x : views) {
    int err = encode(x.main, x.ptr, B, x.rows, H, dh, *x.s, kMainCols, CU_TENSOR_MAP_SWIZZLE_128B);
    if (!err && x.rest && dh > kMainCols)
      err = encode(x.rest, x.ptr, B, x.rows, H, dh, *x.s, kTailCols, CU_TENSOR_MAP_SWIZZLE_32B);
    if (err) return err;
  }
  l.args = Args{madd, o, lse, os, B, H, N, M, dh, scale, m0, tail};
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long long items = static_cast<long long>((N + kRows - 1) / kRows) * B * H;
  l.grid = dim3(static_cast<unsigned>(items < sms ? items : sms));
  return 0;
}

template <typename Kernel>
int run(Kernel* kernel, const Launch& l, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<l.grid, kThreads, kSmemBytes, stream>>>(l.maps, l.args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper
