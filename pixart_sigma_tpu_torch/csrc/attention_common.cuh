// Warp-level pieces shared by the two attention kernels
// (onepass_attention.cu, allheads_attention.cu).
//
// Each warp owns 16 query rows. Logits come from bf16 mma.sync m16n8k16 with
// f32 accumulation, the softmax runs in f32 in the log2 domain (exp2), and the
// probabilities go back into the tensor cores as bf16 for the P.V product.
// Keys are consumed 64 at a time with an online-softmax state (running max m,
// running denominator l, f32 output accumulator) kept in registers, so a step
// never touches device memory.
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

constexpr int kKeyTile = 64;  // keys per online-softmax step
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

struct RowState {
  float m[2];  // running max of rows g and g + 8 (log2 units)
  float l[2];  // this thread's share of the running denominators
  float acc[kHeadPad / 8][4];

  __device__ __forceinline__ void init() {
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < kHeadPad / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
};

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

// One online-softmax step over keys [key0, key0 + 64) held in sK / sV.
// Logit = q.k * scale + bias, bias = madd[key] (0 or -1e30, the key mask) for
// key < M and -inf past the last key; store_rows adds the padded tail of the
// TPU kernels back, so a fully masked row gives sum(V) / pad128(M) as they do.
__device__ __forceinline__ void attend_tile(RowState& st, const uint32_t (&qa)[kHeadPad / 16][4],
                                            const bf16* sK, const bf16* sV, int key0, int M,
                                            const float* madd, float scale, int dh, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kHeadPad / 16; ++kt) {
      const bf16* kp = sK + (nt * 8 + g) * kPitch + kt * 16 + t * 2;
      mma_16816(s[nt], qa[kt], ld_u32(kp), ld_u32(kp + 8));
    }
  }
  float mx0 = st.m[0], mx1 = st.m[1];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = key0 + nt * 8 + t * 2 + e;
      float bias = -CUDART_INF_F;
      if (key < M) bias = madd ? __ldg(madd + key) : 0.f;
      s[nt][e] = s[nt][e] * scale + bias;
      s[nt][e + 2] = s[nt][e + 2] * scale + bias;
      mx0 = fmaxf(mx0, s[nt][e]);
      mx1 = fmaxf(mx1, s[nt][e + 2]);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // key0 < M on every step, so the max is finite from the first step on
  const float a0 = fast_exp2(st.m[0] - mx0);
  const float a1 = fast_exp2(st.m[1] - mx1);
  st.m[0] = mx0;
  st.m[1] = mx1;
  st.l[0] *= a0;
  st.l[1] *= a1;
#pragma unroll
  for (int dn = 0; dn < kHeadPad / 8; ++dn) {
    st.acc[dn][0] *= a0;
    st.acc[dn][1] *= a0;
    st.acc[dn][2] *= a1;
    st.acc[dn][3] *= a1;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // 16 keys per P.V step
    float p[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nt = 2 * kk + h;
      p[h][0] = fast_exp2(s[nt][0] - mx0);
      p[h][1] = fast_exp2(s[nt][1] - mx0);
      p[h][2] = fast_exp2(s[nt][2] - mx1);
      p[h][3] = fast_exp2(s[nt][3] - mx1);
      st.l[0] += p[h][0] + p[h][1];
      st.l[1] += p[h][2] + p[h][3];
    }
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int dn = 0; dn < kHeadPad / 8; ++dn) {
      if (dn * 8 < dh) {  // warp-uniform
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, sV + (kk * 16 + (lane & 15)) * kPitch + dn * 8);
        mma_16816(st.acc[dn], pa, b0, b1);
      }
    }
  }
}

__device__ __forceinline__ void store_pair(bf16* o, float a, float b) {
  *reinterpret_cast<uint32_t*>(o) = pack_bf16(a, b);
}

__device__ __forceinline__ void store_pair(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

constexpr float kMaskedLogit = -1e30f;  // a masked key's logit, as in the TPU kernels

// Keys in [M, pad128(M)): the TPU kernels pad K/V to a multiple of 128 keys
// with zero values and the logit -1e30. They add nothing to a row with a
// valid key, but a row whose keys are all masked (max logit -1e30) counts
// each of them once in its denominator.
__device__ __forceinline__ int padded_tail_keys(int M) { return (M + 127) / 128 * 128 - M; }

// out[row] = acc / l for the warp's rows row0 + g and row0 + g + 8 below
// nrows, and, when `lse` is not null, lse[row] = m + log2(l) (log2 units).
template <typename T>
__device__ __forceinline__ void store_rows(RowState& st, T* o, long long stride, int row0,
                                           int nrows, int dh, int lane, int M, float* lse) {
  const int g = lane >> 2, t = lane & 3;
  float l0 = st.l[0], l1 = st.l[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float tail = static_cast<float>(padded_tail_keys(M));
  l0 += tail * fast_exp2(kMaskedLogit - st.m[0]);
  l1 += tail * fast_exp2(kMaskedLogit - st.m[1]);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const int r0 = row0 + g, r1 = row0 + g + 8;
  if (lse != nullptr && t == 0) {
    if (r0 < nrows) lse[r0] = st.m[0] + log2f(l0);
    if (r1 < nrows) lse[r1] = st.m[1] + log2f(l1);
  }
#pragma unroll
  for (int dn = 0; dn < kHeadPad / 8; ++dn) {
    if (dn * 8 < dh) {
      const int col = dn * 8 + t * 2;
      if (r0 < nrows) store_pair(o + r0 * stride + col, st.acc[dn][0] * i0, st.acc[dn][1] * i0);
      if (r1 < nrows) store_pair(o + r1 * stride + col, st.acc[dn][2] * i1, st.acc[dn][3] * i1);
    }
  }
}

// Strided [B, N, H, dh] views: element (b, n, h, d) sits at
// b * sb + n * sn + h * sh + d.
struct Strides {
  long long sb, sn, sh;
};

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const float* madd;  // [B, M] additive key mask (0 / -1e30) or null
  T* o;
  float* lse;  // [B * H, N] row logsumexp in log2 units, or null (inference)
  Strides qs, ks, vs, os;
  int B, H, N, M, dh;
  float scale;  // dh^-0.5 * log2(e)
};

}  // namespace attn
