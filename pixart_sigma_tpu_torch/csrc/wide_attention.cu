// The attention forwards at head dims above 256 (the wide form): onepass,
// flash, allheads and headsmajor, each a __global__ of its own over strided
// [B, rows, H, dh] bf16 views, bf16 or f32 output.
//
// Replaces, past the narrow forms' widest width of 256, the TPU kernels
// `_onepass_kernel`, `_fwd_kernel`, `_allheads_kernel` and
// `_headsmajor_kernel` (pixart_sigma_tpu/ops/flash_attention.py), which take
// every head dim by padding it to a multiple of 128 lanes in VMEM. The narrow
// forms (hopper_attention.cuh) keep a 128-row item's Q in shared memory and
// its m64nW output accumulator in registers; past 256 columns neither fits
// (Q alone is 96 KB at dh 384, 288 KB at 1152; O would take dh / 2 registers
// a thread). So here the head dim is streamed, and shared memory and
// registers do not depend on dh:
//
// - atoms: the head dim is split into 64-column 128B-swizzled TMA boxes,
//   `atoms` = ceil(dh / 64) of them; TMA zero-fills the columns past dh.
// - the logits S = Q.K^T of a 64-key tile are a sum over atoms: for each
//   atom the producer warp loads Q's atom (128 rows, 16 KB) and K's atom (64
//   keys, 8 KB) into one stage of a TMA/mbarrier ring, and each consumer
//   warpgroup adds its 64 rows' m64n64k16 products of that atom into S.
//   Nothing is resident at full width.
// - the output's columns go in groups of kGroupCols = 128, a grid axis: a
//   block computes O[:, 128 g, 128 g + 128) of its 128 query rows (one
//   launch for all groups). After a tile's S, the ring's next stage holds
//   that tile's V columns of the group (two atoms, 16 KB) and its 64 mask
//   biases; P, rounded to bf16, stays in registers as the A operand of
//   O += P.V (m64n128k16, V read MN-major), 64 accumulator registers a
//   thread at every dh.
// - every group recomputes the logits: ceil(dh / 128) times the S work of
//   one pass. The groups run the same products in the same order and the
//   same softmax arithmetic, so their row max, sum and lse are equal bit for
//   bit and each normalises its columns alike. Only group 0 writes the lse,
//   unless the caller asks for every group's (`lse_gs`, a check).
// - the modes are the narrow forms' (the same Args): onepass (running max
//   from -inf, the scale in f32), flash (q pre-scaled, scale 1, running max
//   from -1e30, `tail` keys of the key block), both with an optional
//   [B, pad128(M)] f32 bias row that the producer copies beside V; the
//   `tail` padded keys join each row's denominator at the end. The cross
//   mode (allheads, headsmajor) reads the [B, M] byte mask: every warp finds
//   the caption's key extent (hopper::key_tiles) and streams only the tiles
//   up to it, and the producer warp writes each tile's biases from the byte
//   mask (hopper::write_tile_bias); K/V pad to pad128(M) keys at logit -1e30.
//
// One block of three warpgroups per (query tile, group, batch * head):
// warpgroup 2 is the producer (setmaxnreg gives its registers away; its
// first warp's lane 0 issues the copies, and in the cross mode the warp
// writes the biases), warpgroups 0 and 1 the consumers, 64 query rows each.
// Each consumer waits for a stage, issues its products, waits for them and
// releases the stage: a simple kernel, with no overlap of the softmax with
// the products beyond what the two warpgroups give each other.
//
// Bound on the card: at the 1024px shapes (B = 4, N = M = 4096, H * dh =
// 1152) the work of one pass is 4 N M dh flops per head, 309 GFLOP, 0.31 ms
// at 989 TFLOP/s, against 151 MB of q/k/v/out (0.05 ms at 3.35 TB/s): the
// tensor cores bound it; the kernel issues ceil(dh / 128) times the S
// products. Captions: the bytes of q and out bound it, as in the narrow
// forms.
//
// Needs dh % 8 == 0, dh > 0 and 16-byte aligned strides (TMA), which the
// Python wrapper arranges (pad_head_dim, _tma_operand); the wrapper sends
// only dh > 256 here.

#include <limits>

#include "hopper_attention.cuh"

namespace wide {

using hopper::kMainCols;
using hopper::kSwizzle128;

constexpr int kRows = 128;       // query rows per item: two consumer warpgroups x 64
constexpr int kKeys = 64;        // keys per K/V tile
constexpr int kGroupCols = 128;  // output columns per group (two atoms)
constexpr int kThreads = 384;    // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kQAtom = kRows * 128;  // a 128-row 64-column atom of Q (16 KB)
constexpr int kKAtom = kKeys * 128;  // a 64-key atom of K or V (8 KB)
// A stage holds one atom of Q and of K (S stages), or the group's two V
// atoms with the tile's biases at kBias (V stages).
constexpr int kBias = kQAtom + kKAtom;
constexpr int kStageBytes = kBias + 1024;
constexpr int kStages = 8;
constexpr int kBarOffset = kStages * kStageBytes;
constexpr int kSmemBytes = kBarOffset + 2 * kStages * 8 + 1024;
static_assert(kSmemBytes <= 232448, "more shared memory than a block may use");
static_assert(hopper::kPadKeys % kKeys == 0, "the padded mask rows hold whole tiles");

struct Maps {
  CUtensorMap q, k, v;  // 64-column 128B-swizzled boxes: 128 rows of q, 64 of k and v
};

struct Args {
  hopper::Args a;   // the narrow forms' arguments (madd, o, lse, strides, shape, modes)
  long long lse_gs; // elements between the groups' lse rows; 0: group 0 alone writes
  int atoms;        // 64-column atoms of the head dim
};

__device__ __forceinline__ uint32_t full(uint32_t base, int s) { return base + kBarOffset + 8 * s; }
__device__ __forceinline__ uint32_t empty(uint32_t base, int s) {
  return base + kBarOffset + 8 * (kStages + s);
}
__device__ __forceinline__ uint32_t stage(uint32_t base, int pos) {
  return base + (pos % kStages) * kStageBytes;
}

// The K/V tiles a block streams: the caption's extent in the cross mode
// (all 32 lanes of the calling warp), else every tile of M keys.
template <bool kCross>
__device__ __forceinline__ int key_tiles(const hopper::Args& a, int b) {
  hopper::Work wk{};
  wk.ntiles = (a.M + kKeys - 1) / kKeys;
  if constexpr (kCross) return hopper::key_tiles<kKeys>(a, wk, b);
  return wk.ntiles;
}

// The producer warp: for each key tile, `atoms` S stages (Q and K atom at)
// and one V stage (the group's V columns and the tile's biases).
template <bool kCross>
__device__ __forceinline__ void produce(const Maps& maps, const Args& x, uint32_t base, int b,
                                        int h, int q0, int g) {
  const hopper::Args& a = x.a;
  const bool issue = (threadIdx.x & 31) == 0;
  const int ntiles = key_tiles<kCross>(a, b);
  const long long madd_row = (a.M + hopper::kPadKeys - 1) / hopper::kPadKeys * hopper::kPadKeys;
  int pos = 0;
  for (int j = 0; j < ntiles; ++j) {
    const int key0 = j * kKeys;
    for (int at = 0; at < x.atoms; ++at, ++pos) {
      if (issue) {
        const int s = pos % kStages;
        if (pos >= kStages) hopper::mbar_wait(empty(base, s), ((pos / kStages) - 1) & 1);
        const uint32_t st = stage(base, pos);
        hopper::mbar_expect_tx(full(base, s), kQAtom + kKAtom);
        hopper::tma_load(st, &maps.q, full(base, s), at * kMainCols, h, q0, b);
        hopper::tma_load(st + kQAtom, &maps.k, full(base, s), at * kMainCols, h, key0, b);
      }
    }
    const int s = pos % kStages;
    const uint32_t st = stage(base, pos);
    if (issue) {
      if (pos >= kStages) hopper::mbar_wait(empty(base, s), ((pos / kStages) - 1) & 1);
      const uint32_t bytes = 2 * kKAtom + (a.madd ? kKeys * 4 : 0);
      if (kCross) {
        hopper::mbar_tx(full(base, s), bytes);
      } else {
        hopper::mbar_expect_tx(full(base, s), bytes);
      }
      // the second atom lies wholly past dh in a last group of 64 columns:
      // TMA fills it with zeros
      for (int c = 0; c < 2; ++c) {
        hopper::tma_load(st + c * kKAtom, &maps.v, full(base, s), g * kGroupCols + c * kMainCols,
                         h, key0, b);
      }
      if (a.madd) {
        hopper::bulk_load(st + kBias, a.madd + static_cast<long long>(b) * madd_row + key0,
                          kKeys * 4, full(base, s));
      }
    }
    if (kCross) {  // lane 0 has seen the stage free; its arrive publishes the biases
      __syncwarp();
      hopper::write_tile_bias<kKeys>(st + kBias, a, b, j);
      __syncwarp();
      if (issue) hopper::mbar_arrive(full(base, s));
    }
    ++pos;
  }
}

// Consumer warpgroup wg: its 64 query rows of the item against the keys, the
// output columns of group g. Accumulator layout of wgmma m64nN (per warp w,
// lane 4 gq + t): d[4 c + e] holds row 16 w + gq (e < 2) or + 8 (e >= 2),
// column 8 c + 2 t + (e & 1).
template <typename TOut, bool kMask, bool kCross>
__device__ __forceinline__ void consume(const Args& x, uint32_t base, int wg, int bh, int b,
                                        int h, int q0, int g) {
  const hopper::Args& a = x.a;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int ntiles = key_tiles<kCross>(a, b);
  const float sc = kMask ? 1.f : a.scale;  // the scale left after the mask step

  float s[32], o[64];
  uint32_t p[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m_0 = a.m0, m_1 = a.m0, l_0 = 0.f, l_1 = 0.f;
  int pos = 0;
  auto acquire = [&]() {
    hopper::mbar_wait(full(base, pos % kStages), (pos / kStages) & 1);
    hopper::wgmma_fence();
  };
  auto release = [&]() {
    if (lane == 0) hopper::mbar_arrive(empty(base, pos % kStages));
    ++pos;
  };

  for (int j = 0; j < ntiles; ++j) {
    // S of tile j, atom by atom
    for (int at = 0; at < x.atoms; ++at) {
      acquire();
      const uint32_t st = stage(base, pos);
      const uint64_t dq = hopper::smem_desc(st + wg * (kQAtom / 2), 1024, kSwizzle128);
      const uint64_t dk = hopper::smem_desc(st + kQAtom, 1024, kSwizzle128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::wgmma_ss_n64(s, dq + 2 * kk, dk + 2 * kk, at + kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::hold(s);
      release();
    }
    // the V stage: the tile's softmax (its biases arrived with V), then P.V
    acquire();
    const uint32_t st = stage(base, pos);
    const int key0 = j * kKeys;
    if (kMask) {
      const uint32_t bias = st + kBias + 8 * t;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float b0, b1;
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(b0), "=f"(b1) : "r"(bias + 32 * c));
        s[4 * c] = fmaf(s[4 * c], a.scale, b0);
        s[4 * c + 1] = fmaf(s[4 * c + 1], a.scale, b1);
        s[4 * c + 2] = fmaf(s[4 * c + 2], a.scale, b0);
        s[4 * c + 3] = fmaf(s[4 * c + 3], a.scale, b1);
      }
    } else if (key0 + kKeys > a.M) {  // the last tile: keys past M
#pragma unroll
      for (int c = 0; c < 8; ++c) {
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
    for (int c = 0; c < 8; ++c) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * c], s[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key0 < M, so the max is finite from the first tile on
    const float mn0 = fmaxf(m_0, mx0 * sc), mn1 = fmaxf(m_1, mx1 * sc);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      s[4 * c] = attn::fast_exp2(fmaf(s[4 * c], sc, -mn0));
      s[4 * c + 1] = attn::fast_exp2(fmaf(s[4 * c + 1], sc, -mn0));
      s[4 * c + 2] = attn::fast_exp2(fmaf(s[4 * c + 2], sc, -mn1));
      s[4 * c + 3] = attn::fast_exp2(fmaf(s[4 * c + 3], sc, -mn1));
      ls0 += s[4 * c] + s[4 * c + 1];
      ls1 += s[4 * c + 2] + s[4 * c + 3];
    }
    const float a0 = attn::fast_exp2(m_0 - mn0), a1 = attn::fast_exp2(m_1 - mn1);
    m_0 = mn0;
    m_1 = mn1;
    l_0 = l_0 * a0 + ls0;
    l_1 = l_1 * a1 + ls1;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      o[4 * c] *= a0;
      o[4 * c + 1] *= a0;
      o[4 * c + 2] *= a1;
      o[4 * c + 3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) p[kk][i] = attn::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    }
    hopper::wgmma_fence();
    // O += P.V: a k-step is 16 key rows of 128 bytes in each of the group's
    // two V atoms, kKAtom apart
    const uint64_t dv = hopper::smem_desc(st, 1024, kSwizzle128, kKAtom);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::wgmma_rs_n128(o, p[kk], dv + kk * (16 * 128 / 16));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::hold(o);
    hopper::hold(p);
    release();
  }

  // out = O / l and lse = m + log2(l) for rows below N; the `tail` padded
  // keys (logit -1e30, zero values) join the denominator first
  l_0 += __shfl_xor_sync(0xffffffffu, l_0, 1);
  l_0 += __shfl_xor_sync(0xffffffffu, l_0, 2);
  l_1 += __shfl_xor_sync(0xffffffffu, l_1, 1);
  l_1 += __shfl_xor_sync(0xffffffffu, l_1, 2);
  l_0 += static_cast<float>(a.tail) * attn::fast_exp2(attn::kMaskedLogit - m_0);
  l_1 += static_cast<float>(a.tail) * attn::fast_exp2(attn::kMaskedLogit - m_1);
  const float i0 = 1.f / l_0, i1 = 1.f / l_1;
  const int r0 = q0 + 64 * wg + 16 * warp + gq, r1 = r0 + 8;
  if (a.lse != nullptr && t == 0 && (g == 0 || x.lse_gs != 0)) {
    float* lse = a.lse + g * x.lse_gs + static_cast<long long>(bh) * a.N;
    if (r0 < a.N) lse[r0] = m_0 + log2f(l_0);
    if (r1 < a.N) lse[r1] = m_1 + log2f(l_1);
  }
  TOut* out = static_cast<TOut*>(a.o) + b * a.os.sb + h * a.os.sh;
  TOut* o0 = out + static_cast<long long>(r0) * a.os.sn;
  TOut* o1 = out + static_cast<long long>(r1) * a.os.sn;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int col = g * kGroupCols + 8 * c + 2 * t;
    if (col < a.dh) {  // dh % 8 == 0, so col + 1 < dh too
      if (r0 < a.N) attn::store_pair(o0 + col, o[4 * c] * i0, o[4 * c + 1] * i0);
      if (r1 < a.N) attn::store_pair(o1 + col, o[4 * c + 2] * i1, o[4 * c + 3] * i1);
    }
  }
}

// One block: query tile blockIdx.x, column group blockIdx.y, batch * head
// blockIdx.z (query tiles fastest, so the blocks in flight share a head's
// K/V in L2).
template <typename TOut, bool kMask, bool kCross>
__device__ __forceinline__ void body(const Maps& maps, const Args& x) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (attn::smem_addr(smem_raw) + 1023) & ~1023u;
  const int q0 = blockIdx.x * kRows, g = blockIdx.y, bh = blockIdx.z;
  const int b = bh / x.a.H, h = bh - b * x.a.H;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full(base, s), 1);   // the producer's arrive
      hopper::mbar_init(empty(base, s), 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 2 * 128 + 32) produce<kCross>(maps, x, base, b, h, q0, g);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<TOut, kMask, kCross>(x, base, wg, bh, b, h, q0, g);
  }
}

}  // namespace wide

template <typename TOut, bool kMask>
__global__ void __launch_bounds__(wide::kThreads, 1)
    wide_onepass_kernel(const __grid_constant__ wide::Maps maps, const wide::Args x) {
  wide::body<TOut, kMask, false>(maps, x);
}

template <typename TOut, bool kMask>
__global__ void __launch_bounds__(wide::kThreads, 1)
    wide_flash_fwd_kernel(const __grid_constant__ wide::Maps maps, const wide::Args x) {
  wide::body<TOut, kMask, false>(maps, x);
}

template <typename TOut>
__global__ void __launch_bounds__(wide::kThreads, 1)
    wide_allheads_kernel(const __grid_constant__ wide::Maps maps, const wide::Args x) {
  wide::body<TOut, true, true>(maps, x);
}

template <typename TOut>
__global__ void __launch_bounds__(wide::kThreads, 1)
    wide_headsmajor_kernel(const __grid_constant__ wide::Maps maps, const wide::Args x) {
  wide::body<TOut, true, true>(maps, x);
}

namespace wide {

// Tensor maps, arguments and grid of one launch, then the launch.
template <typename Kernel>
int launch(Kernel* kernel, const void* q, const void* k, const void* v, const hopper::Args& a,
           long long lse_gs, const attn::Strides& qs, const attn::Strides& ks,
           const attn::Strides& vs, cudaStream_t stream) {
  if (a.N < 1 || a.M < 1 || a.tail < 0 || a.dh < 1 || a.dh % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps{};
  int err = hopper::encode(&maps.q, q, a.B, a.N, a.H, a.dh, qs, kMainCols,
                           CU_TENSOR_MAP_SWIZZLE_128B, kRows);
  if (!err) err = hopper::encode(&maps.k, k, a.B, a.M, a.H, a.dh, ks, kMainCols,
                                 CU_TENSOR_MAP_SWIZZLE_128B, kKeys);
  if (!err) err = hopper::encode(&maps.v, v, a.B, a.M, a.H, a.dh, vs, kMainCols,
                                 CU_TENSOR_MAP_SWIZZLE_128B, kKeys);
  if (err) return err;
  const long long groups = (a.dh + kGroupCols - 1) / kGroupCols, bhs = 1LL * a.B * a.H;
  if (groups > 65535 || bhs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Args x{a, lse_gs, (a.dh + kMainCols - 1) / kMainCols};
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.N + kRows - 1) / kRows, static_cast<unsigned>(groups),
                  static_cast<unsigned>(bhs));
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(maps, x);
  return static_cast<int>(cudaGetLastError());
}

// onepass (kFlash false) or flash over bf16 q/k/v with an optional mask bias.
template <bool kFlash>
int self_launch(const void* q, const void* k, const void* v, const float* madd, void* o,
                float* lse, long long lse_gs, int f32, int B, int H, int N, int M, int dh,
                int tail, float m0, const attn::Strides& qs, const attn::Strides& ks,
                const attn::Strides& vs, const attn::Strides& os, float scale, void* stream) {
  hopper::Args a{};
  a.madd = madd;
  a.o = o;
  a.lse = lse;
  a.os = os;
  a.B = B, a.H = H, a.N = N, a.M = M, a.dh = dh;
  a.scale = scale;
  a.m0 = m0;
  a.tail = tail;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto kernel) { return launch(kernel, q, k, v, a, lse_gs, qs, ks, vs, s); };
  if constexpr (kFlash) {
    if (f32) return madd ? go(wide_flash_fwd_kernel<float, true>) : go(wide_flash_fwd_kernel<float, false>);
    return madd ? go(wide_flash_fwd_kernel<attn::bf16, true>)
                : go(wide_flash_fwd_kernel<attn::bf16, false>);
  } else {
    if (f32) return madd ? go(wide_onepass_kernel<float, true>) : go(wide_onepass_kernel<float, false>);
    return madd ? go(wide_onepass_kernel<attn::bf16, true>)
                : go(wide_onepass_kernel<attn::bf16, false>);
  }
}

// allheads or headsmajor: the [B, M] byte mask is required, the running max
// starts from -inf and the TPU's padding of K/V to pad128(M) keys joins the
// denominator.
int cross_launch(bool headsmajor, const void* q, const void* k, const void* v,
                 const unsigned char* kmask, long long kmask_sb, void* o, int f32, int B, int H,
                 int N, int M, int dh, const attn::Strides& qs, const attn::Strides& ks,
                 const attn::Strides& vs, const attn::Strides& os, float scale, void* stream) {
  if (M > hopper::kCrossMaxKeys || kmask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  hopper::Args a{};
  a.o = o;
  a.os = os;
  a.B = B, a.H = H, a.N = N, a.M = M, a.dh = dh;
  a.scale = scale;
  a.m0 = -std::numeric_limits<float>::infinity();
  a.tail = (M + hopper::kPadKeys - 1) / hopper::kPadKeys * hopper::kPadKeys - M;
  a.kmask = kmask;
  a.kmask_sb = kmask_sb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto kernel) { return launch(kernel, q, k, v, a, 0, qs, ks, vs, s); };
  if (headsmajor) return f32 ? go(wide_headsmajor_kernel<float>) : go(wide_headsmajor_kernel<attn::bf16>);
  return f32 ? go(wide_allheads_kernel<float>) : go(wide_allheads_kernel<attn::bf16>);
}

}  // namespace wide

// The entry points take the narrow forms' arguments (onepass_attention.cu,
// flash_forward.cu, cross_attention.cu); onepass and flash also `lse_gs`:
// 0 writes the lse of group 0 only into the [B * H, N] buffer, else every
// group g writes its own at lse + g * lse_gs (a check that the groups agree).
// Each returns 0, a CUDA error code of the launch, or 10000 + the CUresult
// of a tensor map that could not be encoded.
extern "C" int wide_onepass_attention(const void* q, const void* k, const void* v,
                                      const float* madd, void* o, float* lse, long long lse_gs,
                                      int f32, int B, int H, int N, int M, int dh, long long q_sb,
                                      long long q_sn, long long q_sh, long long k_sb,
                                      long long k_sn, long long k_sh, long long v_sb,
                                      long long v_sn, long long v_sh, long long o_sb,
                                      long long o_sn, long long o_sh, float scale, void* stream) {
  const int tail = (M + hopper::kPadKeys - 1) / hopper::kPadKeys * hopper::kPadKeys - M;
  return wide::self_launch<false>(q, k, v, madd, o, lse, lse_gs, f32, B, H, N, M, dh, tail,
                                  -std::numeric_limits<float>::infinity(), {q_sb, q_sn, q_sh},
                                  {k_sb, k_sn, k_sh}, {v_sb, v_sn, v_sh}, {o_sb, o_sn, o_sh},
                                  scale, stream);
}

extern "C" int wide_flash_forward(const void* q, const void* k, const void* v, const float* madd,
                                  void* o, float* lse, long long lse_gs, int f32, int B, int H,
                                  int N, int M, int dh, int tail, long long q_sb, long long q_sn,
                                  long long q_sh, long long k_sb, long long k_sn, long long k_sh,
                                  long long v_sb, long long v_sn, long long v_sh, long long o_sb,
                                  long long o_sn, long long o_sh, float scale, void* stream) {
  return wide::self_launch<true>(q, k, v, madd, o, lse, lse_gs, f32, B, H, N, M, dh, tail,
                                 attn::kMaskedLogit, {q_sb, q_sn, q_sh}, {k_sb, k_sn, k_sh},
                                 {v_sb, v_sn, v_sh}, {o_sb, o_sn, o_sh}, scale, stream);
}

extern "C" int wide_allheads_attention(const void* q, const void* k, const void* v,
                                       const unsigned char* mask, long long mask_sb, void* o,
                                       int f32, int B, int H, int N, int M, int dh,
                                       long long q_sb, long long q_sn, long long q_sh,
                                       long long k_sb, long long k_sn, long long k_sh,
                                       long long v_sb, long long v_sn, long long v_sh,
                                       long long o_sb, long long o_sn, long long o_sh,
                                       float scale, void* stream) {
  return wide::cross_launch(false, q, k, v, mask, mask_sb, o, f32, B, H, N, M, dh,
                            {q_sb, q_sn, q_sh}, {k_sb, k_sn, k_sh}, {v_sb, v_sn, v_sh},
                            {o_sb, o_sn, o_sh}, scale, stream);
}

extern "C" int wide_headsmajor_attention(const void* q, const void* k, const void* v,
                                         const unsigned char* mask, long long mask_sb, void* o,
                                         int f32, int B, int H, int N, int M, int dh,
                                         long long q_sb, long long q_sn, long long q_sh,
                                         long long k_sb, long long k_sn, long long k_sh,
                                         long long v_sb, long long v_sn, long long v_sh,
                                         long long o_sb, long long o_sn, long long o_sh,
                                         float scale, void* stream) {
  return wide::cross_launch(true, q, k, v, mask, mask_sb, o, f32, B, H, N, M, dh,
                            {q_sb, q_sn, q_sh}, {k_sb, k_sn, k_sh}, {v_sb, v_sn, v_sh},
                            {o_sb, o_sn, o_sh}, scale, stream);
}

// Dynamic shared memory of one block (bytes), keys per K/V tile (the unit of
// the caption extent) and output columns per group; the wrapper checks the
// last two against its own.
extern "C" int wide_attention_smem_bytes() { return wide::kSmemBytes; }
extern "C" int wide_attention_key_tile() { return wide::kKeys; }
extern "C" int wide_attention_group_cols() { return wide::kGroupCols; }
