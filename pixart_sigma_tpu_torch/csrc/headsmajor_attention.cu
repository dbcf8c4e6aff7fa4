// Masked caption cross-attention over strided [B, N, H, dh] bf16 or f32
// views, at most 512 keys, forward only.
//
// Replaces the TPU kernel `_headsmajor_kernel` (pixart_sigma_tpu/ops/
// flash_attention.py), the opt-in cross-attention path (`impl="headsmajor"`,
// `PIXART_CROSSATTN_IMPL=headsmajor`). On the TPU it works on a heads-major
// copy padded to 128 lanes, [B, H, N_pad, 128], so that every head is an
// aligned block; it keeps all heads' K/V of one batch element resident while
// the grid sweeps the query blocks, takes the exact row max over all keys
// and makes one exp sweep, with no online rescale. Here the layout question
// disappears, because the kernel reads each head through its strides, and
// the rest carries over: one block serves (block_q query rows, one head, one
// batch element), loads that head's whole K/V (M padded to 64 keys; 300
// captions x 80 x 2 B x 2 = 113 KB at most 512 keys) into shared memory once,
// and walks its query rows in sub-tiles of 128 (8 warps x 16 rows). Each
// warp makes two sweeps over the resident keys: the first takes the exact row
// max of the logits, the second computes p = exp2(s - max) once per logit,
// sums the f32 p into the denominator and multiplies the bf16-rounded p into
// the output (attention_common.cuh).
//
// The function is the TPU kernel's: logit = q.k * dh^-0.5 * log2(e) in f32
// plus the f32 mask bias (0 / -1e30), K/V padded to pad128(M) keys with zero
// values at logit -1e30, so a row whose keys are all masked gives
// sum(V) / pad128(M).
//
// Bound on the card: at the 1024px path (B = 4, N = 4096, M = 300, H = 16)
// the work is 22.6 GFLOP against 81 MB of q/k/v/out, below the H100's ~295
// flop/byte balance point, so memory bounds it (the first sweep's extra
// Q.K^T products cost tensor-core time the bytes leave idle). The design reads
// q and writes out exactly once and reads each head's K/V once per block_q
// query rows.
//
// Needs dh % 8 == 0, dh <= 80, 16-byte aligned rows, 1 <= M <= 512,
// block_q a multiple of 128; the Python wrapper checks all of it.

#include "attention_common.cuh"

namespace attn {

constexpr int kHeadsmajorRows = 128;  // query rows per sub-tile: 8 warps x 16
constexpr int kHeadsmajorThreads = 256;
constexpr int kHeadsmajorMaxKeys = 512;

constexpr int headsmajor_smem_bytes(int M) {  // Q sub-tile + the resident K, V
  return (kHeadsmajorRows + 2 * ((M + kKeyTile - 1) / kKeyTile * kKeyTile)) * kPitch * 2;
}

template <typename T>
__global__ void __launch_bounds__(kHeadsmajorThreads)
    headsmajor_kernel(Params<T> p, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m_pad = (p.M + kKeyTile - 1) / kKeyTile * kKeyTile;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kHeadsmajorRows * kPitch;
  bf16* sV = sK + m_pad * kPitch;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(p.N, row_begin + rows_per_block);
  const T* q = p.q + b * p.qs.sb + h * p.qs.sh;
  const T* k = p.k + b * p.ks.sb + h * p.ks.sh;
  const T* v = p.v + b * p.vs.sb + h * p.vs.sh;
  T* o = p.o + b * p.os.sb + h * p.os.sh;
  const float* madd = p.madd + static_cast<long long>(b) * p.M;
  const int tail = padded_tail_keys(p.M);

  if (p.dh < kHeadPad) {  // no copy writes these columns: zero them once
    zero_pad_cols(sQ, kHeadsmajorRows, p.dh);
    zero_pad_cols(sK, m_pad, p.dh);
  }
  load_rows(sK, k, p.ks.sn, 0, m_pad, p.M, p.dh);
  load_rows(sV, v, p.vs.sn, 0, m_pad, p.M, p.dh);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int q0 = row_begin; q0 < row_end; q0 += kHeadsmajorRows) {
    load_rows(sQ, q, p.qs.sn, q0, kHeadsmajorRows, p.N, p.dh);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    uint32_t qa[kHeadPad / 16][4];
    load_q_frags(qa, sQ + warp * 16 * kPitch, lane);
    float s[8][4];
    RowState st;
    st.init();
    for (int key0 = 0; key0 < p.M; key0 += kKeyTile) {  // sweep 1: the exact row max
      tile_logits(s, qa, sK + key0 * kPitch, key0, p.M, madd, p.scale, lane);
      tile_row_max(s, st.m[0], st.m[1]);
    }
    for (int key0 = 0; key0 < p.M; key0 += kKeyTile) {  // sweep 2: one exp per logit
      tile_logits(s, qa, sK + key0 * kPitch, key0, p.M, madd, p.scale, lane);
      accumulate_tile(st, s, sV + key0 * kPitch, p.dh, lane);
    }
    store_rows(st, o, p.os.sn, q0 + warp * 16, p.N, p.dh, lane, tail, nullptr);
    __syncthreads();  // the next sub-tile's load overwrites sQ
  }
}

template <typename T>
cudaError_t launch_headsmajor(const void* q, const void* k, const void* v, const float* madd,
                              void* o, int B, int H, int N, int M, int dh, int rows_per_block,
                              const Strides& qs, const Strides& ks, const Strides& vs,
                              const Strides& os, float scale, cudaStream_t stream) {
  const Params<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), madd, static_cast<T*>(o), nullptr, qs, ks, vs, os,
                    B, H, N, M, dh, scale};
  cudaError_t err = cudaFuncSetAttribute(headsmajor_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         headsmajor_smem_bytes(kHeadsmajorMaxKeys));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + rows_per_block - 1) / rows_per_block, H, B);
  headsmajor_kernel<T><<<grid, kHeadsmajorThreads, headsmajor_smem_bytes(M), stream>>>(
      p, rows_per_block);
  return cudaGetLastError();
}

}  // namespace attn

// q/k/v/o are bf16, or f32 when `f32` is non-zero; `madd` is the [B, M] f32
// mask bias (0 / -1e30). Each block serves `rows_per_block` query rows of one
// head. Returns the CUDA error code of the launch (0 on success).
extern "C" int headsmajor_attention(const void* q, const void* k, const void* v,
                                    const float* madd, void* o, int f32, int B, int H, int N,
                                    int M, int dh, int rows_per_block, long long q_sb,
                                    long long q_sn, long long q_sh, long long k_sb,
                                    long long k_sn, long long k_sh, long long v_sb,
                                    long long v_sn, long long v_sh, long long o_sb,
                                    long long o_sn, long long o_sh, float scale, void* stream) {
  using namespace attn;
  if (M < 1 || M > kHeadsmajorMaxKeys || madd == nullptr || rows_per_block < kHeadsmajorRows ||
      rows_per_block % kHeadsmajorRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh},
      os{o_sb, o_sn, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      f32 ? launch_headsmajor<float>(q, k, v, madd, o, B, H, N, M, dh, rows_per_block, qs, ks,
                                     vs, os, scale, s)
          : launch_headsmajor<bf16>(q, k, v, madd, o, B, H, N, M, dh, rows_per_block, qs, ks,
                                    vs, os, scale, s);
  return static_cast<int>(err);
}

// Dynamic shared memory of one block for M keys (bytes).
extern "C" int headsmajor_attention_smem_bytes(int M) { return attn::headsmajor_smem_bytes(M); }
