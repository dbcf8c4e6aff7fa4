// Self-attention forward over strided [B, N, H, dh] bf16 views, with an
// optional additive [B, M] key mask and row logsumexp; bf16 or f32 output.
//
// Replaces the TPU kernel `_onepass_kernel` (pixart_sigma_tpu/ops/
// flash_attention.py), which keeps a head's whole K/V resident in VMEM and
// takes the exact row max in one sweep. On the H100 a head's K alone is
// 4096 x 72 x 2 B = 0.6 MB, above the 227 KB of shared memory a block may
// use, so this kernel streams K/V with an online softmax instead: the Hopper
// body of hopper_attention.cuh (TMA ring of 128-key tiles, wgmma for Q.K^T
// and P.V, two consumer warpgroups taking turns on the tensor cores), which
// flash_forward.cu shares. Logits never reach device memory. The function
// is the onepass one: the running max starts from -inf, the logit scale is
// applied in f32, and the TPU's padding of K/V to a multiple of 128 keys
// (logit -1e30, zero values) joins each row's denominator.
//
// Bound on the card: at the 1024px path (B*H = 64, N = M = 4096, dh = 72)
// the work is 4 N M dh flops per head, 309 GFLOP, 0.31 ms at 989 TFLOP/s,
// against 151 MB of q/k/v/out (0.05 ms at 3.35 TB/s): the tensor cores
// bound it. Both products issue wgmma; dh = 72 runs as 80 columns (64 + 16,
// the split TMA layout), 0.9 of the issued products useful. The second
// floor is the exponential: one ex2 per logit, 1.07e9 at that shape, which
// the 16 per clock per SM of the special-function units take ~0.26 ms at
// 1.98 GHz, near the tensor-core bound. So one consumer warpgroup's softmax
// (one FFMA and one ex2 per logit, the scale and max folded together) runs
// while the other warpgroup's products, and its own P.V, are in flight.
//
// Head dims up to 128: dh runs at the padded width 64, 80 or 128
// (hopper_common.cuh), each its own instantiation; at width 128 a K/V stage
// is 64 KB, so the ring holds three stages beside one Q buffer.
//
// Reads bf16 q/k/v in place through their strides (the qkv projection's
// output, with no transpose or copy); the Python wrapper rounds f32 inputs
// to bf16 first, as the tensor cores multiply in bf16 anyway, and pads a
// head dim that is not a multiple of 8 with zero columns. Needs
// dh % 8 == 0, dh <= 128 and 16-byte aligned strides, which TMA requires
// and the wrapper checks.

#include <limits>

#include "hopper_attention.cuh"

template <typename TOut, bool kMask, bool kWide>
__global__ void __launch_bounds__(hopper::kThreads, 1)
    onepass_kernel(const __grid_constant__ hopper::Maps maps, const hopper::Args a) {
  hopper::attention_body<TOut, kMask, false, kWide>(maps, a);
}

template <bool kWide>
int onepass_run(const hopper::Launch& l, bool f32, bool mask, cudaStream_t s) {
  if (f32) {
    return mask ? hopper::run<false, kWide>(onepass_kernel<float, true, kWide>, l, s)
                : hopper::run<false, kWide>(onepass_kernel<float, false, kWide>, l, s);
  }
  return mask ? hopper::run<false, kWide>(onepass_kernel<attn::bf16, true, kWide>, l, s)
              : hopper::run<false, kWide>(onepass_kernel<attn::bf16, false, kWide>, l, s);
}

// q/k/v are bf16; o is bf16, or f32 when `f32` is non-zero. `madd` is null
// or the f32 mask bias, [B, pad128(M)] with -inf past M. `lse` is null for
// inference, or a [B * H, N] f32 buffer for the row logsumexp (log2 units)
// that the backward kernels (flash_backward.cu) read. Returns 0, a CUDA error code of the launch, or
// 10000 + the CUresult of a tensor map that could not be encoded.
extern "C" int onepass_attention(const void* q, const void* k, const void* v, const float* madd,
                                 void* o, float* lse, int f32, int B, int H, int N, int M, int dh,
                                 long long q_sb, long long q_sn, long long q_sh, long long k_sb,
                                 long long k_sn, long long k_sh, long long v_sb, long long v_sn,
                                 long long v_sh, long long o_sb, long long o_sn, long long o_sh,
                                 float scale, void* stream) {
  hopper::Launch l;
  const int tail = (M + hopper::kKeys - 1) / hopper::kKeys * hopper::kKeys - M;
  const int err = hopper::prepare(l, q, k, v, madd, o, lse, B, H, N, M, dh, {q_sb, q_sn, q_sh},
                                  {k_sb, k_sn, k_sh}, {v_sb, v_sn, v_sh}, {o_sb, o_sn, o_sh},
                                  scale, -std::numeric_limits<float>::infinity(), tail);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hopper::width_of(dh) == 128 ? onepass_run<true>(l, f32, madd, s)
                                     : onepass_run<false>(l, f32, madd, s);
}

// Dynamic shared memory of one block (bytes), keys per tile and the K/V
// ring's depth at the padded width `width` (64, 80 or 128; the wrapper
// checks the last two against its own).
extern "C" int onepass_attention_smem_bytes(int width) {
  return width == 128 ? hopper::Ring<false, true>::smem_bytes
                      : hopper::Ring<false, false>::smem_bytes;
}
extern "C" int onepass_attention_key_tile() { return hopper::kKeys; }
extern "C" int onepass_attention_key_stages(int width) {
  return width == 128 ? hopper::Ring<false, true>::stages : hopper::Ring<false, false>::stages;
}
