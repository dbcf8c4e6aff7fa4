// Long-sequence attention forward over strided [B, N, H, dh] bf16 views,
// with an optional additive [B, M] key mask and row logsumexp; bf16 or f32
// output.
//
// Replaces the TPU kernel `_fwd_kernel` (pixart_sigma_tpu/ops/
// flash_attention.py), the tiled online-softmax forward behind the JAX
// `flash_attention`: its grid's innermost axis sweeps K/V blocks in order and
// carries the running max, denominator and output accumulator in VMEM
// scratch. Hopper blocks run in no order, so here the sweep is a loop inside
// one block: the body of hopper_attention.cuh, which onepass_attention.cu
// shares (a producer warpgroup streams 128-key K/V tiles through a 3-stage
// TMA/mbarrier ring; two consumer warpgroups of 64 query rows run Q.K^T and
// P.V on wgmma and keep the online-softmax state in registers). Logits never
// reach device memory, so the length of the key sequence costs time, not
// memory.
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
// bound it, as they do at 4K (N = 65536). Both products issue wgmma, dh = 72
// as 80 columns (64 + 16). The exponential is a second floor close to the
// first: 32 * 16384^2 = 8.6e9 ex2 take ~2.05 ms on the special-function
// units (16 per clock per SM, 1.98 GHz), so the softmax of one consumer
// warpgroup (one FFMA and one ex2 per logit) overlaps the other's wgmma.
// One block per SM walks the (query tile, head) items with query tiles
// fastest, so the blocks in flight work on one or two heads and share that
// head's K/V (4.7 MB at 16384 keys) in the 50 MB L2 instead of reading it
// from HBM once per query tile.
//
// Head dims up to 128, at the padded width 64, 80 or 128 as in
// onepass_attention.cu. Reads bf16 q/k/v in place through their strides;
// the Python wrapper rounds f32 inputs to bf16 first and pads a head dim
// that is not a multiple of 8 with zero columns. Needs dh % 8 == 0,
// dh <= 128 and 16-byte aligned strides, which TMA requires and the
// wrapper checks.

#include "hopper_attention.cuh"

template <typename TOut, bool kMask, bool kWide>
__global__ void __launch_bounds__(hopper::kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ hopper::Maps maps, const hopper::Args a) {
  hopper::attention_body<TOut, kMask, false, kWide>(maps, a);
}

template <bool kWide>
int flash_run(const hopper::Launch& l, bool f32, bool mask, cudaStream_t s) {
  if (f32) {
    return mask ? hopper::run<false, kWide>(flash_fwd_kernel<float, true, kWide>, l, s)
                : hopper::run<false, kWide>(flash_fwd_kernel<float, false, kWide>, l, s);
  }
  return mask ? hopper::run<false, kWide>(flash_fwd_kernel<attn::bf16, true, kWide>, l, s)
              : hopper::run<false, kWide>(flash_fwd_kernel<attn::bf16, false, kWide>, l, s);
}

// q (pre-scaled, so `scale` is 1 on the flash path), k and v are bf16; o is
// bf16, or f32 when `f32` is non-zero. `madd` is null or the f32 mask bias,
// [B, pad128(M)] with -inf past M, already rounded to the inputs' dtype;
// `tail` counts the padded keys at logit -1e30. `lse` is null, or a [B * H, N] f32 buffer for the row
// logsumexp (log2 units) that the backward kernels (flash_backward.cu) read.
// Returns 0, a CUDA error code of the launch, or 10000 + the CUresult of a
// tensor map that could not be encoded.
extern "C" int flash_forward(const void* q, const void* k, const void* v, const float* madd,
                             void* o, float* lse, int f32, int B, int H, int N, int M, int dh,
                             int tail, long long q_sb, long long q_sn, long long q_sh,
                             long long k_sb, long long k_sn, long long k_sh, long long v_sb,
                             long long v_sn, long long v_sh, long long o_sb, long long o_sn,
                             long long o_sh, float scale, void* stream) {
  hopper::Launch l;
  const int err = hopper::prepare(l, q, k, v, madd, o, lse, B, H, N, M, dh, {q_sb, q_sn, q_sh},
                                  {k_sb, k_sn, k_sh}, {v_sb, v_sn, v_sh}, {o_sb, o_sn, o_sh},
                                  scale, attn::kMaskedLogit, tail);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hopper::width_of(dh) == 128 ? flash_run<true>(l, f32, madd, s)
                                     : flash_run<false>(l, f32, madd, s);
}

// Dynamic shared memory of one block (bytes), keys per tile and the K/V
// ring's depth at the padded width `width` (64, 80 or 128; the wrapper
// checks the last two against its own).
extern "C" int flash_forward_smem_bytes(int width) {
  return width == 128 ? hopper::Ring<false, true>::smem_bytes
                      : hopper::Ring<false, false>::smem_bytes;
}
extern "C" int flash_forward_key_tile() { return hopper::kKeys; }
extern "C" int flash_forward_key_stages(int width) {
  return width == 128 ? hopper::Ring<false, true>::stages : hopper::Ring<false, false>::stages;
}
