// Masked caption cross-attention on the flat [B, N, C] layout, C = H * dh,
// bf16 or f32.
//
// Replaces the TPU kernel `_allheads_kernel` (pixart_sigma_tpu/ops/
// flash_attention.py), which reads q and writes out in the [B, N, C] layout
// of the projections, loops over the heads inside the kernel and keeps the
// caption K/V resident. Here one block of 8 warps serves (128 query rows,
// one head, one batch element): it addresses its head as a column slice of
// the flat rows, so no head transpose is ever materialised, and it loads the
// head's whole K/V slice (at most 512 keys; 300 captions x 72 x 2 B x 2 =
// 86 KB) into shared memory once and keeps it there while its 8 warps sweep
// it in 64-key online-softmax steps (attention_common.cuh).
//
// Bound on the card: at the 1024px path (B = 4, N = 4096, M = 300, C = 1152)
// the work is 22.6 GFLOP against 81 MB of q/k/v/out, below the H100's
// ~295 flop/byte balance point, so memory bounds it. The design reads q and
// writes out exactly once, straight from and to the projection layout, and
// re-reads only the small K/V slices, which stay in L2.
//
// K/V may be column slices of one [B, M, 2C] tensor (the hoisted caption
// K/V): every row is addressed through its own stride. Needs dh % 8 == 0,
// dh <= 80, 16-byte aligned rows, M <= 512; the Python wrapper checks it all.

#include "attention_common.cuh"

namespace attn {

constexpr int kAllheadsRows = 128;  // query rows per block: 8 warps x 16
constexpr int kAllheadsThreads = 256;
constexpr int kAllheadsMaxKeys = 512;

constexpr int allheads_smem_bytes(int M) {  // Q + the resident K, V
  return (kAllheadsRows + 2 * ((M + kKeyTile - 1) / kKeyTile * kKeyTile)) * kPitch * 2;
}

template <typename T>
__global__ void __launch_bounds__(kAllheadsThreads) allheads_kernel(Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m_pad = (p.M + kKeyTile - 1) / kKeyTile * kKeyTile;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kAllheadsRows * kPitch;
  bf16* sV = sK + m_pad * kPitch;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kAllheadsRows;
  const T* q = p.q + b * p.qs.sb + h * p.qs.sh;
  const T* k = p.k + b * p.ks.sb + h * p.ks.sh;
  const T* v = p.v + b * p.vs.sb + h * p.vs.sh;
  T* o = p.o + b * p.os.sb + h * p.os.sh;
  const float* madd = p.madd + static_cast<long long>(b) * p.M;

  if (p.dh < kHeadPad) {
    zero_pad_cols(sQ, kAllheadsRows, p.dh);
    zero_pad_cols(sK, m_pad, p.dh);
  }
  load_rows(sQ, q, p.qs.sn, q0, kAllheadsRows, p.N, p.dh);
  load_rows(sK, k, p.ks.sn, 0, m_pad, p.M, p.dh);
  load_rows(sV, v, p.vs.sn, 0, m_pad, p.M, p.dh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint32_t qa[kHeadPad / 16][4];
  load_q_frags(qa, sQ + warp * 16 * kPitch, lane);
  RowState st;
  st.init();
  for (int key0 = 0; key0 < p.M; key0 += kKeyTile) {
    attend_tile(st, qa, sK + key0 * kPitch, sV + key0 * kPitch, key0, p.M, madd, p.scale, p.dh,
                lane);
  }
  store_rows(st, o, p.os.sn, q0 + warp * 16, p.N, p.dh, lane, p.M, nullptr);
}

template <typename T>
cudaError_t launch_allheads(const void* q, const void* k, const void* v, const float* madd,
                            void* o, int B, int H, int N, int M, int dh, const Strides& qs,
                            const Strides& ks, const Strides& vs, const Strides& os, float scale,
                            cudaStream_t stream) {
  const Params<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), madd, static_cast<T*>(o), nullptr, qs, ks, vs, os,
                    B, H, N, M, dh, scale};
  cudaError_t err = cudaFuncSetAttribute(allheads_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         allheads_smem_bytes(kAllheadsMaxKeys));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kAllheadsRows - 1) / kAllheadsRows, H, B);
  allheads_kernel<T><<<grid, kAllheadsThreads, allheads_smem_bytes(M), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace attn

// q/o rows of C = H * dh values, head h at columns [h * dh, (h + 1) * dh);
// q/k/v/o are bf16, or f32 when `f32` is non-zero.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int allheads_attention(const void* q, const void* k, const void* v, const float* madd,
                                  void* o, int f32, int B, int H, int N, int M, int dh,
                                  long long q_sb, long long q_sn, long long k_sb, long long k_sn,
                                  long long v_sb, long long v_sn, long long o_sb, long long o_sn,
                                  float scale, void* stream) {
  using namespace attn;
  if (M < 1 || M > kAllheadsMaxKeys || madd == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_sn, dh}, ks{k_sb, k_sn, dh}, vs{v_sb, v_sn, dh}, os{o_sb, o_sn, dh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      f32 ? launch_allheads<float>(q, k, v, madd, o, B, H, N, M, dh, qs, ks, vs, os, scale, s)
          : launch_allheads<bf16>(q, k, v, madd, o, B, H, N, M, dh, qs, ks, vs, os, scale, s);
  return static_cast<int>(err);
}

// Dynamic shared memory of one block for M keys (bytes).
extern "C" int allheads_attention_smem_bytes(int M) { return attn::allheads_smem_bytes(M); }
