// Long-sequence attention forward over strided [B, N, H, dh] bf16 or f32
// views, with an optional additive [B, M] key mask and row logsumexp.
//
// Replaces the TPU kernel `_fwd_kernel` (pixart_sigma_tpu/ops/
// flash_attention.py), the tiled online-softmax forward behind the JAX
// `flash_attention`: its grid's innermost axis sweeps K/V blocks in order and
// carries the running max, denominator and output accumulator in VMEM
// scratch. Hopper blocks run in no order, so here the sweep is a loop inside
// one block: 8 warps own 128 query rows (16 each), K/V stream through shared
// memory in 64-key tiles double-buffered with cp.async, and the online-softmax
// state stays in registers. Logits never reach device memory, so the length
// of the key sequence costs time, not memory. That body, `stream_attention`
// in attention_common.cuh, is the onepass kernel's too.
//
// The function is the JAX `flash_attention`'s, which differs from the
// onepass kernel's in four places, all reproduced here (the first two by the
// Python wrapper, the last two by this kernel's arguments to the body):
// - q arrives pre-scaled by dh^-0.5 * log2(e) in its own dtype (the Python
//   wrapper multiplies it, as JAX does), so the logit is q.k + madd[key] with
//   scale 1;
// - madd carries the key mask rounded to the inputs' dtype, as the TPU kernel
//   carries it in a spare lane of K: bf16(-1e30) lies below -1e30;
// - the running max starts at -1e30, the TPU scratch's initial value, so a
//   row whose logits all lie below it (bf16, every key masked) gets p = 0;
// - `tail` keys past M, the TPU's padding of K/V up to its key block, enter
//   the denominator at the logit -1e30 with zero values (`_kv_tail_mask`).
//
// Bound on the card: at the 2K path (B*H = 32, N = M = 16384, dh = 72) the
// work is 4 N M dh flops per head, 2.47 TFLOP, 2.50 ms at 989 TFLOP/s,
// against 302 MB of q/k/v/out (0.09 ms at 3.35 TB/s), so the tensor cores
// bound it, as they do at 4K (N = 65536). Both products run on mma.sync bf16
// tensor-core instructions, dh = 72 zero-padded to 80 in shared memory only.
// The grid keeps the query tiles fastest (blockIdx.x), so the blocks in
// flight work on one or two heads and share that head's K/V (4.7 MB at 16384
// keys) in the 50 MB L2 instead of reading it from HBM once per query tile.
//
// Reads q/k/v in place through their strides. Needs dh % 8 == 0, dh <= 80,
// 16-byte aligned rows; the Python wrapper checks all of it. f32 tiles are
// rounded to bf16 as they are staged, with plain loads.

#include "attention_common.cuh"

namespace attn {

template <typename T>
__global__ void __launch_bounds__(kStreamThreads) flash_fwd_kernel(Params<T> p, int tail) {
  stream_attention(p, kMaskedLogit, tail);
}

template <typename T>
cudaError_t launch_flash(const void* q, const void* k, const void* v, const float* madd, void* o,
                         float* lse, int B, int H, int N, int M, int dh, int tail,
                         const Strides& qs, const Strides& ks, const Strides& vs,
                         const Strides& os, float scale, cudaStream_t stream) {
  const Params<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), madd, static_cast<T*>(o), lse, qs, ks, vs, os,
                    B, H, N, M, dh, scale};
  return launch_stream(flash_fwd_kernel<T>, p, stream, tail);
}

}  // namespace attn

// q (pre-scaled, so `scale` is 1 on the flash path), k, v and o are bf16, or
// f32 when `f32` is non-zero. `madd` is null or a [B, M] f32 mask bias
// already rounded to the inputs' dtype; `tail` counts the padded keys at
// logit -1e30. `lse` is null, or a [B * H, N] f32 buffer for the row
// logsumexp (log2 units) that the backward kernels (flash_backward.cu) read.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_forward(const void* q, const void* k, const void* v, const float* madd,
                             void* o, float* lse, int f32, int B, int H, int N, int M, int dh,
                             int tail, long long q_sb, long long q_sn, long long q_sh,
                             long long k_sb, long long k_sn, long long k_sh, long long v_sb,
                             long long v_sn, long long v_sh, long long o_sb, long long o_sn,
                             long long o_sh, float scale, void* stream) {
  using namespace attn;
  if (M < 1 || tail < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh},
      os{o_sb, o_sn, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      f32 ? launch_flash<float>(q, k, v, madd, o, lse, B, H, N, M, dh, tail, qs, ks, vs, os,
                                scale, s)
          : launch_flash<bf16>(q, k, v, madd, o, lse, B, H, N, M, dh, tail, qs, ks, vs, os,
                               scale, s);
  return static_cast<int>(err);
}

// Dynamic shared memory of one block (bytes).
extern "C" int flash_forward_smem_bytes() { return attn::kStreamSmem; }
