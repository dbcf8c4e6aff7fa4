// Warp-level pieces of the attention kernels that run on mma.sync
// (flash_backward.cu), and the small helpers (smem_addr, fast_exp2,
// pack_bf16, store_pair, kMaskedLogit, Strides) that the Hopper body of the
// forward kernels (hopper_attention.cuh) shares with them.
//
// Each warp owns 16 rows. Products are bf16 mma.sync m16n8k16 with f32
// accumulation; the softmax runs in f32 in the log2 domain (exp2).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): with g = lane / 4 and
// t = lane % 4, A holds (row g | g+8, col 2t | 2t+1 | 2t+8 | 2t+9), B holds
// (k 2t | 2t+1 | 2t+8 | 2t+9, col g) and C holds (row g | g+8, col 2t | 2t+1).
// Two adjacent 8-key C tiles of S are exactly one A tile of P, so P never
// leaves registers.
//
// q/k/v/out are bf16 or f32 (`T`). f32 inputs are rounded to bf16 as they are
// staged into shared memory, so both products run on the bf16 tensor cores
// (as an f32 dot at default precision does on the TPU); the softmax,
// accumulation and an f32 output stay f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace attn {

typedef __nv_bfloat16 bf16;

constexpr int kHeadPad = 80;  // head dims up to 80, zero-padded to five k-steps of 16
constexpr int kPitch = kHeadPad + 8;  // shared-memory row pitch, free of bank conflicts

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `valid == false` writes zeros instead.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment of a row-major [k][n] tile: lanes 0-15 address rows k0..k0+15.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

// Eight values into shared memory as bf16 (zeros when `valid` is false):
// bf16 through cp.async, f32 through registers, rounded on the way.
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* src, bool valid) {
  cp_async_16(dst, src, valid);
}

__device__ __forceinline__ void copy_chunk(bf16* dst, const float* src, bool valid) {
  uint4 packed = make_uint4(0u, 0u, 0u, 0u);
  if (valid) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    packed = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                        pack_bf16(b.z, b.w));
  }
  *reinterpret_cast<uint4*>(dst) = packed;
}

// Rows [row0, row0 + rows) of a [*, dh] slice with row stride `stride`
// (elements) into shared memory at row pitch kPitch; rows at or past `nrows`
// are zero-filled. Needs dh % 8 == 0 and 16-byte aligned rows. bf16 copies
// complete at the next cp_async_wait, f32 ones at once.
template <typename T>
__device__ __forceinline__ void load_rows(bf16* dst, const T* src, long long stride, int row0,
                                          int rows, int nrows, int dh) {
  const int chunks = dh >> 3;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    const int row = row0 + r;
    const bool valid = row < nrows;
    copy_chunk(dst + r * kPitch + c * 8, src + (valid ? row : 0) * stride + c * 8, valid);
  }
}

// Zeroes columns [dh, kHeadPad) of `rows` rows: the head-dim padding that
// the Q.K^T product reads but no copy writes.
__device__ __forceinline__ void zero_pad_cols(bf16* dst, int rows, int dh) {
  const int w = kHeadPad - dh;
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
    dst[(i / w) * kPitch + dh + i % w] = __float2bfloat16(0.f);
  }
}

// A fragments of the warp's 16 query rows (sQ points at its first row).
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[kHeadPad / 16][4], const bf16* sQ,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kt = 0; kt < kHeadPad / 16; ++kt) {
    const bf16* p = sQ + g * kPitch + kt * 16 + t * 2;
    qa[kt][0] = ld_u32(p);
    qa[kt][1] = ld_u32(p + 8 * kPitch);
    qa[kt][2] = ld_u32(p + 8);
    qa[kt][3] = ld_u32(p + 8 * kPitch + 8);
  }
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
