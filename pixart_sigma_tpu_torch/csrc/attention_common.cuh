// Small helpers of the attention kernels (hopper_attention.cuh and
// flash_backward.cu): shared-memory addresses, the exponential of the
// softmax (log2 domain), bf16 packing of wgmma A fragments, output stores in
// bf16 or f32, the masked logit and the strides of a [B, N, H, dh] view.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace attn {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store_pair(bf16* o, float a, float b) {
  *reinterpret_cast<uint32_t*>(o) = pack_bf16(a, b);
}

__device__ __forceinline__ void store_pair(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

constexpr float kMaskedLogit = -1e30f;  // a masked key's logit, as in the TPU kernels

// Strided [B, N, H, dh] views: element (b, n, h, d) sits at
// b * sb + n * sn + h * sh + d.
struct Strides {
  long long sb, sn, sh;
};

}  // namespace attn
