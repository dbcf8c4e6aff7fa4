// Self-attention forward over strided [B, N, H, dh] bf16 or f32 views, with
// an optional additive [B, M] key mask.
//
// Replaces the TPU kernel `_onepass_kernel` (pixart_sigma_tpu/ops/
// flash_attention.py), which keeps a head's whole K/V resident in VMEM and
// takes the exact row max in one sweep. On the H100 a head's K alone is
// 4096 x 72 x 2 B = 0.6 MB, far above the 227 KB of shared memory a block may
// use, so this kernel streams K/V instead: one block of 8 warps per
// (128 query rows, batch * head), K/V tiles of 64 keys double-buffered in
// shared memory with cp.async, and an online softmax in registers
// (`stream_attention` in attention_common.cuh, which flash_forward.cu shares).
// Logits never reach device memory.
//
// Bound on the card: at the 1024px path (B*H = 64, N = M = 4096, dh = 72) the
// work is 4 N M dh flops per head, 309 GFLOP, against 151 MB of q/k/v/out, so
// the tensor cores, not memory, bound it. The design keeps both products on
// mma.sync bf16 tensor-core instructions and pads dh = 72 to 80 (five k-steps
// of 16) only in shared memory. The next steps are wgmma and TMA.
//
// Reads q/k/v in place through their strides, so the qkv projection's output
// is used without a transpose or copy. Needs dh % 8 == 0, dh <= 80, 16-byte
// aligned rows; the Python wrapper checks all of it. f32 tiles are staged
// with plain loads, so only the bf16 instantiation overlaps them with compute.

#include "attention_common.cuh"

namespace attn {

template <typename T>
__global__ void __launch_bounds__(kStreamThreads) onepass_kernel(Params<T> p) {
  stream_attention(p, -CUDART_INF_F, padded_tail_keys(p.M));
}

template <typename T>
cudaError_t launch_onepass(const void* q, const void* k, const void* v, const float* madd,
                           void* o, float* lse, int B, int H, int N, int M, int dh,
                           const Strides& qs, const Strides& ks, const Strides& vs,
                           const Strides& os, float scale, cudaStream_t stream) {
  const Params<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), madd, static_cast<T*>(o), lse, qs, ks, vs, os,
                    B, H, N, M, dh, scale};
  return launch_stream(onepass_kernel<T>, p, stream);
}

}  // namespace attn

// q/k/v/o are bf16, or f32 when `f32` is non-zero. `lse` is null for
// inference, or a [B * H, N] f32 buffer for the row logsumexp (log2 units)
// that the backward kernels (flash_backward.cu) read.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int onepass_attention(const void* q, const void* k, const void* v, const float* madd,
                                 void* o, float* lse, int f32, int B, int H, int N, int M, int dh,
                                 long long q_sb, long long q_sn, long long q_sh, long long k_sb,
                                 long long k_sn, long long k_sh, long long v_sb, long long v_sn,
                                 long long v_sh, long long o_sb, long long o_sn, long long o_sh,
                                 float scale, void* stream) {
  using namespace attn;
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh},
      os{o_sb, o_sn, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      f32 ? launch_onepass<float>(q, k, v, madd, o, lse, B, H, N, M, dh, qs, ks, vs, os, scale, s)
          : launch_onepass<bf16>(q, k, v, madd, o, lse, B, H, N, M, dh, qs, ks, vs, os, scale, s);
  return static_cast<int>(err);
}

// Dynamic shared memory of one block (bytes).
extern "C" int onepass_attention_smem_bytes() { return attn::kStreamSmem; }
