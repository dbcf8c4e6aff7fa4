// Masked caption cross-attention, at most 512 keys, forward only: bf16
// q/k/v read in place through their strides, bf16 or f32 output. Two entry
// points, one per TPU kernel, each with a __global__ of its own:
//
// - allheads_attention (allheads_kernel) replaces `_allheads_kernel`
//   (pixart_sigma_tpu/ops/flash_attention.py), which reads q and writes out
//   in the [B, N, C] layout of the projections, loops over the heads inside
//   the kernel and keeps the caption K/V resident. Here the flat rows are
//   [B, N, H, dh] views (head h at columns [h dh, (h + 1) dh)), and K/V may
//   be column slices of the hoisted [B, M, 2C] caption tensor (rows 4 C
//   bytes apart): TMA reads all of them in place, so no head transpose is
//   ever materialised.
// - headsmajor_attention (headsmajor_kernel) replaces `_headsmajor_kernel`,
//   the opt-in path (`impl="headsmajor"`, `PIXART_CROSSATTN_IMPL=headsmajor`).
//   On the TPU it works on a heads-major copy padded to 128 lanes,
//   [B, H, N_pad, 128], so that every head is an aligned block. On the card
//   the layout question disappears (TMA reads each head of a [B, N, H, dh]
//   view through its strides). The grid walks 128-row query tiles of its
//   own; the wrapper's `block_q` (rows per block on the TPU) is checked and
//   does not reach the kernel.
//
// Both compute the TPU kernels' one function: logit = q.k * dh^-0.5 *
// log2(e) in f32 plus the mask bias (0 / -1e30), K/V padded to
// pad128(M) keys with zero values at logit -1e30, so a row whose keys are
// all masked gives sum(V) / pad128(M). The max is taken online over 128-key
// tiles (the TPU kernels take the exact max first); the difference is
// rounding.
//
// Bound on the card: bytes. At the 1024px path (B = 4, N = 4096, M = 300,
// C = 1152, 3-19 valid caption keys) q in and out are 75.5 MB, 22.6 us at
// 3.35 TB/s; at the 2K path (B = 2, N = 16384) 151 MB, 45 us. Over all
// keys (pad64(M) = 320 in 64-key tiles) the work would come close to that:
// 64 * 4096 * 320 = 8.4e7 ex2, ~20 us on the special-function units (16
// per clock per SM at 1.98 GHz), and 26.8 GFLOP of issued products, ~27 us
// at 989 TFLOP/s. Over the extent (one 128-key tile holds every valid key
// of the path's captions) they are 3.4e7 ex2, ~8 us, and 10.7 GFLOP, ~11 us
// (at 2K: 6.7e7 ex2, ~16 us, and 21.5 GFLOP, ~22 us), so the bytes bound.
//
// The design (hopper_attention.cuh, cross mode):
// - the extent: each block finds its batch element's last valid key from
//   its row of the byte mask (at most 512 bytes) and loads and multiplies
//   only the 128-key tiles up to it; a caption with no valid key keeps
//   every tile. The producer warp writes each tile's biases from the same
//   row, so for a bool mask the wrapper launches nothing but the kernel;
// - K/V resident: a block walks a share of one (batch, head)'s query tiles
//   and keeps that head's extent in shared memory for all of them (two
//   128-key stages; a longer extent streams through them for every query
//   tile: right, slower, and only for captions of more than 256 keys);
// - bytes in flight: a persistent grid, one block per SM, a producer warp
//   keeping up to five 128-row Q tiles (100 KB) in flight through TMA and
//   mbarriers; the output leaves by TMA store from the tile's Q buffer, so
//   no consumer waits on device memory;
// - DRAM locality: a head is 144 of each q row's 2304 bytes, so the shares
//   of all heads run side by side and the blocks in flight read whole rows
//   between them;
// - products on wgmma, one FFMA per logit folding the scale, the bias and the
//   running max into the exponent; the two consumer warpgroups run
//   independently, so one's softmax overlaps the other's products.
//
// Head dims up to 128, at the padded width 64, 80 or 128 as in
// onepass_attention.cu; at width 128 the two resident K/V stages sit beside
// three Q buffers (five at widths 64 and 80). f32 inputs are rounded to
// bf16 by the Python wrapper (the tensor cores multiply in bf16 anyway),
// which also pads a head dim that is not a multiple of 8 with zero columns
// (a heads-major copy: a head of the flat layout is then not 16-byte
// aligned). Needs dh % 8 == 0, dh <= 128, 16-byte aligned strides and
// 1 <= M <= 512, which the wrapper checks.

#include "hopper_attention.cuh"

template <typename TOut, bool kWide>
__global__ void __launch_bounds__(hopper::kThreads, 1)
    allheads_kernel(const __grid_constant__ hopper::Maps maps, const hopper::Args a) {
  hopper::attention_body<TOut, true, true, kWide>(maps, a);
}

template <typename TOut, bool kWide>
__global__ void __launch_bounds__(hopper::kThreads, 1)
    headsmajor_kernel(const __grid_constant__ hopper::Maps maps, const hopper::Args a) {
  hopper::attention_body<TOut, true, true, kWide>(maps, a);
}

// q/k/v are bf16 [B, rows, H, dh] views given by their element strides
// (batch, row, head); o is bf16, or f32 when `f32` is non-zero. `mask` is the
// [B, M] key mask, one byte per key (nonzero = valid, a bool tensor's
// bytes), keys contiguous and rows `mask_sb` bytes apart. Returns 0, a CUDA
// error code of the launch, or 10000 + the CUresult of a tensor map that
// could not be encoded. headsmajor_attention takes the same arguments.
extern "C" int allheads_attention(const void* q, const void* k, const void* v,
                                  const unsigned char* mask, long long mask_sb, void* o, int f32,
                                  int B, int H, int N, int M, int dh, long long q_sb,
                                  long long q_sn, long long q_sh, long long k_sb, long long k_sn,
                                  long long k_sh, long long v_sb, long long v_sn, long long v_sh,
                                  long long o_sb, long long o_sn, long long o_sh, float scale,
                                  void* stream) {
  return hopper::launch_cross(allheads_kernel<attn::bf16, false>, allheads_kernel<float, false>,
                              allheads_kernel<attn::bf16, true>, allheads_kernel<float, true>,
                              q, k, v, mask, mask_sb, o, f32, B, H, N, M, dh, {q_sb, q_sn, q_sh},
                              {k_sb, k_sn, k_sh}, {v_sb, v_sn, v_sh}, {o_sb, o_sn, o_sh}, scale,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int headsmajor_attention(const void* q, const void* k, const void* v,
                                    const unsigned char* mask, long long mask_sb, void* o,
                                    int f32, int B, int H, int N, int M, int dh, long long q_sb,
                                    long long q_sn, long long q_sh, long long k_sb,
                                    long long k_sn, long long k_sh, long long v_sb,
                                    long long v_sn, long long v_sh, long long o_sb,
                                    long long o_sn, long long o_sh, float scale, void* stream) {
  return hopper::launch_cross(headsmajor_kernel<attn::bf16, false>,
                              headsmajor_kernel<float, false>, headsmajor_kernel<attn::bf16, true>,
                              headsmajor_kernel<float, true>, q, k, v, mask, mask_sb, o, f32, B,
                              H, N, M, dh, {q_sb, q_sn, q_sh},
                              {k_sb, k_sn, k_sh}, {v_sb, v_sn, v_sh}, {o_sb, o_sn, o_sh}, scale,
                              static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one block (bytes), keys per tile (the unit of the
// extent) and the K/V stages that hold a resident extent at the padded width
// `width` (64, 80 or 128); the wrapper checks the last two against its own.
extern "C" int cross_attention_smem_bytes(int width) {
  return width == 128 ? hopper::Ring<true, true>::smem_bytes
                      : hopper::Ring<true, false>::smem_bytes;
}
extern "C" int cross_attention_key_tile() { return hopper::kKeys; }
extern "C" int cross_attention_key_stages(int width) {
  return width == 128 ? hopper::Ring<true, true>::stages : hopper::Ring<true, false>::stages;
}
