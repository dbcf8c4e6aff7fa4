// Attention backward over strided [B, N, H, dh] bf16 or f32 views, from the
// row logsumexp that the onepass forward saved (log2 units).
//
// Replaces the TPU kernels `_bwd_dkv_kernel` and `_bwd_dq_kernel`
// (pixart_sigma_tpu/ops/flash_attention.py, called from `_flash_bwd`). Both
// recompute the probabilities instead of storing them:
//   s  = q.k * scale + madd[key]            (scale = dh^-0.5 * log2(e))
//   P  = exp2(s - lse[row])
//   dP = dO . v,   dS = P * (dP - delta[row]) * dh^-0.5,  delta = rowsum(dO * O)
//   dV = P^T dO,   dK = dS^T q,   dQ = dS k
// delta is computed by the caller in f32, as XLA does outside the Pallas
// kernels.
//
// On the TPU each grid step is one (q tile, k tile) pair and the sum over the
// swept axis lives in VMEM scratch across sequential grid steps. Hopper
// blocks run in no order, so the sweep becomes a loop inside the block:
// - dkv_kernel: one block of 4 warps per (64 keys, batch * head). Each warp
//   keeps its 16 keys' K and V as mma A fragments and its dK/dV accumulators
//   (16 x 80 f32 each) in registers, while the block streams 64-row tiles of
//   q, dO, lse and delta through a cp.async double buffer. Transposed
//   products (S^T = K Q^T, dP^T = V dO^T) keep every intermediate in the
//   key-major fragment layout, so P^T and dS^T feed the next two products
//   straight from registers.
// - dq_kernel: one block of 4 warps per (64 query rows, batch * head). Each
//   warp keeps its rows' q and dO fragments, lse, delta and a 16 x 80 f32
//   dQ accumulator in registers while K/V stream in 64-key tiles.
// Grids use ceil-div and mask their tails: keys at or past M get logit -inf
// (and madd, when given, carries the key mask), query rows at or past N get
// lse = +inf so their P is 0, and no row past M (dK/dV) or N (dQ) is
// written. dh = 72 is zero-padded to 80 in shared memory only.
//
// Bound on the card: at the 1024px training path (B * H = 64, N = M = 4096,
// dh = 72) dkv does four products of 2 N M dh flops per head (618 GFLOP) and
// dq three (464 GFLOP), against ~150 MB of operands, so the tensor cores
// bound both. The design keeps all products on bf16 mma.sync with f32
// accumulation and never writes P or dS to device memory; wgmma/TMA are the
// next step.

#include "attention_common.cuh"

namespace attn {

constexpr int kBwdThreads = 128;  // 4 warps x 16 rows
constexpr int kBwdRows = 64;      // keys per dkv block, query rows per dq block
constexpr int kBwdTile = 64;      // rows per streamed tile
constexpr int kBwdTileElems = kBwdTile * kPitch;
// dkv: K, V (resident) + 2 x (q, dO) tiles + 2 x (lse, delta)
constexpr int kDkvSmem = 6 * kBwdTileElems * 2 + 4 * kBwdTile * 4;
// dq: q, dO (resident) + 2 x (K, V) tiles
constexpr int kDqSmem = 6 * kBwdTileElems * 2;

template <typename T>
struct BwdParams {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* madd;   // [B, M] additive key mask (0 / -1e30) or null
  const float* lse;    // [B * H, N] log2 units
  const float* delta;  // [B * H, N]
  T* dq;
  T* dk;
  T* dv;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  int B, H, N, M, dh;
  float scale;     // dh^-0.5 * log2(e): logits in log2 units
  float ds_scale;  // dh^-0.5 = ln(2) * scale, the chain rule through exp2
};

// Bias of key `key`: the key mask inside [0, M), -inf past it.
__device__ __forceinline__ float key_bias(const float* madd, int key, int M) {
  if (key >= M) return -CUDART_INF_F;
  return madd ? __ldg(madd + key) : 0.f;
}

// acc (a warp's 16 rows x kHeadPad f32, C fragments) -> rows row0 + g and
// row0 + g + 8 below nrows.
template <typename T>
__device__ __forceinline__ void store_acc(const float (&acc)[kHeadPad / 8][4], T* o,
                                          long long stride, int row0, int nrows, int dh,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int dn = 0; dn < kHeadPad / 8; ++dn) {
    if (dn * 8 < dh) {
      const int col = dn * 8 + t * 2;
      if (r0 < nrows) store_pair(o + r0 * stride + col, acc[dn][0], acc[dn][1]);
      if (r1 < nrows) store_pair(o + r1 * stride + col, acc[dn][2], acc[dn][3]);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[kHeadPad / 8][4]) {
#pragma unroll
  for (int i = 0; i < kHeadPad / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// lse / delta of rows [row0, row0 + kBwdTile) into shared memory; rows at or
// past N get lse = +inf (P = 0) and delta = 0.
__device__ __forceinline__ void load_row_stats(float* sl, float* sd, const float* lse,
                                               const float* delta, int row0, int N) {
  for (int i = threadIdx.x; i < kBwdTile; i += blockDim.x) {
    const int row = row0 + i;
    sl[i] = row < N ? lse[row] : CUDART_INF_F;
    sd[i] = row < N ? delta[row] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads) dkv_kernel(BwdParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kBwdTileElems;
  bf16* sQ = sV + kBwdTileElems;      // two buffers
  bf16* sO = sQ + 2 * kBwdTileElems;  // dO, two buffers
  float* sL = reinterpret_cast<float*>(sO + 2 * kBwdTileElems);  // lse, two buffers
  float* sD = sL + 2 * kBwdTile;                                 // delta, two buffers

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int key0 = blockIdx.x * kBwdRows;
  const T* q = p.q + b * p.qs.sb + h * p.qs.sh;
  const T* k = p.k + b * p.ks.sb + h * p.ks.sh;
  const T* v = p.v + b * p.vs.sb + h * p.vs.sh;
  const T* dout = p.dout + b * p.dos.sb + h * p.dos.sh;
  const float* lse = p.lse + static_cast<long long>(blockIdx.y) * p.N;
  const float* delta = p.delta + static_cast<long long>(blockIdx.y) * p.N;
  const float* madd = p.madd ? p.madd + static_cast<long long>(b) * p.M : nullptr;

  if (p.dh < kHeadPad) {
    zero_pad_cols(sK, 2 * kBwdTile, p.dh);  // sK and sV are adjacent
    zero_pad_cols(sQ, 4 * kBwdTile, p.dh);  // both q and both dO buffers
  }
  load_rows(sK, k, p.ks.sn, key0, kBwdRows, p.M, p.dh);
  load_rows(sV, v, p.vs.sn, key0, kBwdRows, p.M, p.dh);
  load_rows(sQ, q, p.qs.sn, 0, kBwdTile, p.N, p.dh);
  load_rows(sO, dout, p.dos.sn, 0, kBwdTile, p.N, p.dh);
  load_row_stats(sL, sD, lse, delta, 0, p.N);
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = key0 + warp * 16 + g;  // this thread's keys kr and kr + 8
  const float bias[2] = {key_bias(madd, kr, p.M), key_bias(madd, kr + 8, p.M)};
  uint32_t ka[kHeadPad / 16][4], va[kHeadPad / 16][4];
  float dk[kHeadPad / 8][4], dv[kHeadPad / 8][4];
  zero_acc(dk);
  zero_acc(dv);

  const int ntiles = (p.N + kBwdTile - 1) / kBwdTile;
  for (int i = 0; i < ntiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < ntiles) {  // prefetch the next q tile into the other buffer
      const int nxt = (buf ^ 1) * kBwdTileElems;
      load_rows(sQ + nxt, q, p.qs.sn, (i + 1) * kBwdTile, kBwdTile, p.N, p.dh);
      load_rows(sO + nxt, dout, p.dos.sn, (i + 1) * kBwdTile, kBwdTile, p.N, p.dh);
      load_row_stats(sL + (buf ^ 1) * kBwdTile, sD + (buf ^ 1) * kBwdTile, lse, delta,
                     (i + 1) * kBwdTile, p.N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i == 0) {
      load_q_frags(ka, sK + warp * 16 * kPitch, lane);
      load_q_frags(va, sV + warp * 16 * kPitch, lane);
    }
    const bf16* cQ = sQ + buf * kBwdTileElems;
    const bf16* cO = sO + buf * kBwdTileElems;
    const float* cL = sL + buf * kBwdTile;
    const float* cD = sD + buf * kBwdTile;
#pragma unroll 1
    for (int qc = 0; qc < kBwdTile / 16; ++qc) {  // 16 queries per step
      // S^T and dP^T: C fragments, row = key (g | g + 8), col = query
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < kHeadPad / 16; ++kt) {
          const int off = (qc * 16 + nt * 8 + g) * kPitch + kt * 16 + t * 2;
          mma_16816(s[nt], ka[kt], ld_u32(cQ + off), ld_u32(cQ + off + 8));
          mma_16816(dp[nt], va[kt], ld_u32(cO + off), ld_u32(cO + off + 8));
        }
      }
      float pt[2][4], dst[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = qc * 16 + nt * 8 + t * 2 + (e & 1);
          pt[nt][e] = fast_exp2(s[nt][e] * p.scale + bias[e >> 1] - cL[row]);
          dst[nt][e] = pt[nt][e] * (dp[nt][e] - cD[row]) * p.ds_scale;
        }
      }
      // two adjacent 8-query C tiles are one A tile (16 keys x 16 queries)
      const uint32_t pa[4] = {pack_bf16(pt[0][0], pt[0][1]), pack_bf16(pt[0][2], pt[0][3]),
                              pack_bf16(pt[1][0], pt[1][1]), pack_bf16(pt[1][2], pt[1][3])};
      const uint32_t da[4] = {pack_bf16(dst[0][0], dst[0][1]), pack_bf16(dst[0][2], dst[0][3]),
                              pack_bf16(dst[1][0], dst[1][1]), pack_bf16(dst[1][2], dst[1][3])};
#pragma unroll
      for (int dn = 0; dn < kHeadPad / 8; ++dn) {
        if (dn * 8 < p.dh) {  // warp-uniform
          const int off = (qc * 16 + (lane & 15)) * kPitch + dn * 8;
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, cO + off);
          mma_16816(dv[dn], pa, b0, b1);
          ldmatrix_x2_trans(b0, b1, cQ + off);
          mma_16816(dk[dn], da, b0, b1);
        }
      }
    }
    __syncthreads();  // the next prefetch overwrites this buffer
  }
  T* dk_out = p.dk + b * p.dks.sb + h * p.dks.sh;
  T* dv_out = p.dv + b * p.dvs.sb + h * p.dvs.sh;
  store_acc(dk, dk_out, p.dks.sn, key0 + warp * 16, p.M, p.dh, lane);
  store_acc(dv, dv_out, p.dvs.sn, key0 + warp * 16, p.M, p.dh, lane);
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads) dq_kernel(BwdParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kBwdTileElems;
  bf16* sK = sO + kBwdTileElems;      // two buffers
  bf16* sV = sK + 2 * kBwdTileElems;  // two buffers

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int q0 = blockIdx.x * kBwdRows;
  const T* q = p.q + b * p.qs.sb + h * p.qs.sh;
  const T* k = p.k + b * p.ks.sb + h * p.ks.sh;
  const T* v = p.v + b * p.vs.sb + h * p.vs.sh;
  const T* dout = p.dout + b * p.dos.sb + h * p.dos.sh;
  const float* lse = p.lse + static_cast<long long>(blockIdx.y) * p.N;
  const float* delta = p.delta + static_cast<long long>(blockIdx.y) * p.N;
  const float* madd = p.madd ? p.madd + static_cast<long long>(b) * p.M : nullptr;

  if (p.dh < kHeadPad) zero_pad_cols(sQ, 6 * kBwdTile, p.dh);  // all six tiles
  load_rows(sQ, q, p.qs.sn, q0, kBwdRows, p.N, p.dh);
  load_rows(sO, dout, p.dos.sn, q0, kBwdRows, p.N, p.dh);
  load_rows(sK, k, p.ks.sn, 0, kBwdTile, p.M, p.dh);
  load_rows(sV, v, p.vs.sn, 0, kBwdTile, p.M, p.dh);
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows r0 and r0 + 8
  const float row_lse[2] = {r0 < p.N ? lse[r0] : CUDART_INF_F,
                            r0 + 8 < p.N ? lse[r0 + 8] : CUDART_INF_F};
  const float row_delta[2] = {r0 < p.N ? delta[r0] : 0.f, r0 + 8 < p.N ? delta[r0 + 8] : 0.f};
  uint32_t qa[kHeadPad / 16][4], oa[kHeadPad / 16][4];
  float dq[kHeadPad / 8][4];
  zero_acc(dq);

  const int ntiles = (p.M + kBwdTile - 1) / kBwdTile;
  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < ntiles) {  // prefetch the next key tile into the other buffer
      const int nxt = (buf ^ 1) * kBwdTileElems;
      load_rows(sK + nxt, k, p.ks.sn, (j + 1) * kBwdTile, kBwdTile, p.M, p.dh);
      load_rows(sV + nxt, v, p.vs.sn, (j + 1) * kBwdTile, kBwdTile, p.M, p.dh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      load_q_frags(qa, sQ + warp * 16 * kPitch, lane);
      load_q_frags(oa, sO + warp * 16 * kPitch, lane);
    }
    const bf16* cK = sK + buf * kBwdTileElems;
    const bf16* cV = sV + buf * kBwdTileElems;
#pragma unroll 1
    for (int kc = 0; kc < kBwdTile / 16; ++kc) {  // 16 keys per step
      // S and dP: C fragments, row = query (g | g + 8), col = key
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < kHeadPad / 16; ++kt) {
          const int off = (kc * 16 + nt * 8 + g) * kPitch + kt * 16 + t * 2;
          mma_16816(s[nt], qa[kt], ld_u32(cK + off), ld_u32(cK + off + 8));
          mma_16816(dp[nt], oa[kt], ld_u32(cV + off), ld_u32(cV + off + 8));
        }
      }
      float ds[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * kBwdTile + kc * 16 + nt * 8 + t * 2 + (e & 1);
          const float pr =
              fast_exp2(s[nt][e] * p.scale + key_bias(madd, key, p.M) - row_lse[e >> 1]);
          ds[nt][e] = pr * (dp[nt][e] - row_delta[e >> 1]) * p.ds_scale;
        }
      }
      const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                              pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
      for (int dn = 0; dn < kHeadPad / 8; ++dn) {
        if (dn * 8 < p.dh) {  // warp-uniform
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, cK + (kc * 16 + (lane & 15)) * kPitch + dn * 8);
          mma_16816(dq[dn], da, b0, b1);
        }
      }
    }
    __syncthreads();  // the next prefetch overwrites this buffer
  }
  T* dq_out = p.dq + b * p.dqs.sb + h * p.dqs.sh;
  store_acc(dq, dq_out, p.dqs.sn, q0 + warp * 16, p.N, p.dh, lane);
}

template <typename T>
BwdParams<T> make_params(const void* q, const void* k, const void* v, const void* dout,
                         const float* madd, const float* lse, const float* delta, void* dq,
                         void* dk, void* dv, int B, int H, int N, int M, int dh,
                         const long long* st, float scale, float ds_scale) {
  auto s3 = [&](int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  return BwdParams<T>{static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), static_cast<const T*>(dout), madd, lse, delta,
                      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
                      s3(0), s3(1), s3(2), s3(3), s3(4), s3(5), s3(6),
                      B, H, N, M, dh, scale, ds_scale};
}

template <typename T>
cudaError_t launch_dkv(const BwdParams<T>& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(dkv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + kBwdRows - 1) / kBwdRows, p.B * p.H);
  dkv_kernel<T><<<grid, kBwdThreads, kDkvSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const BwdParams<T>& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBwdRows - 1) / kBwdRows, p.B * p.H);
  dq_kernel<T><<<grid, kBwdThreads, kDqSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace attn

// q/dout/dq are [B, N, H, dh] views and k/v/dk/dv [B, M, H, dh] views, each
// given by its (batch, row, head) strides in elements, in the order q, k, v,
// dout, dq, dk, dv (21 values in `strides`); all bf16, or f32 when `f32` is
// non-zero. lse and delta are [B * H, N] f32; madd is [B, M] f32 or null.
// Each returns the CUDA error code of its launch (0 on success).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* madd, const float* lse, const float* delta, void* dk,
                             void* dv, int f32, int B, int H, int N, int M, int dh,
                             const long long* strides, float scale, float ds_scale,
                             void* stream) {
  using namespace attn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      f32 ? launch_dkv(make_params<float>(q, k, v, dout, madd, lse, delta, nullptr, dk, dv, B, H,
                                          N, M, dh, strides, scale, ds_scale), s)
          : launch_dkv(make_params<bf16>(q, k, v, dout, madd, lse, delta, nullptr, dk, dv, B, H,
                                         N, M, dh, strides, scale, ds_scale), s);
  return static_cast<int>(err);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* madd, const float* lse, const float* delta, void* dq,
                            int f32, int B, int H, int N, int M, int dh,
                            const long long* strides, float scale, float ds_scale,
                            void* stream) {
  using namespace attn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      f32 ? launch_dq(make_params<float>(q, k, v, dout, madd, lse, delta, dq, nullptr, nullptr,
                                         B, H, N, M, dh, strides, scale, ds_scale), s)
          : launch_dq(make_params<bf16>(q, k, v, dout, madd, lse, delta, dq, nullptr, nullptr,
                                        B, H, N, M, dh, strides, scale, ds_scale), s);
  return static_cast<int>(err);
}

// Dynamic shared memory of one block (bytes).
extern "C" int flash_bwd_dkv_smem_bytes() { return attn::kDkvSmem; }
extern "C" int flash_bwd_dq_smem_bytes() { return attn::kDqSmem; }
