// K5: activation snap + int8 x int8 matmul for one layer of a stacked
// weight at prefill-size M (M > 256), hand-written for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel
// ant_quantization_tpu/kernels/stacked.py:_prefill_i8 (_i8_prefill_kernel),
// which the reference holds bit-identical to its decode kernel (K1, or K3
// with ovp), so this computes exactly what stacked_i8.cu computes:
//
//   int8 values: out[m, n] = f32(sum_k xq[m, k] W[l, n, k]) * scales[l, n]
//   OVP bytes:   per 256-row segment the int32 16 xq@c - 15 xq@clip(c, +-64),
//                to f32; segments added in f32 in order within each K
//                block of `fold` segments, blocks added in order; times
//                scales[l, n]
//
// with xq = snap(x / a_scale[l]; a_q[l]), snapped once per element by the
// pre-kernel of snap_i8.cuh into an int8 (M, K) scratch that every N tile
// then reads. The int32 sums are exact, so their order is free; the f32
// steps of the OVP mode are __fadd_rn / __fmul_rn in the reference's
// order, which nvcc never contracts.
//
// What bounds it: operations. At M = 2048 a 4096 x 4096 site is 6.9e10
// int8 ops against 16.8 MB of weights, far above the card's ops-per-byte
// line, so the product runs on the int8 tensor cores: mma.sync
// m16n8k32 s8 x s8 -> s32 (a __dp4a kernel would be held to the CUDA
// cores' small fraction of 1,979 TOP/s). A block computes a BM x BN
// output tile; K runs in 64-byte steps through a two-stage cp.async ring
// in shared memory (rows padded to 80 bytes, so the ldmatrix reads of 8
// rows x 16 bytes hit 32 distinct banks). Both operands are K-contiguous
// (xq row-major, W N-major), which is the "row.col" layout the
// instruction takes, so ldmatrix without .trans loads every fragment.
// Each warp owns a WM x WN sub-tile of int32 accumulators in registers.
// The OVP mode also takes the second dot against clip(c) (two SIMD byte
// ops on the B fragment in registers) into a second accumulator, and
// keeps the f32 segment and block sums per output, so its warp tile is
// half as wide. The product is in i8_mma.cuh, shared with K9.

#include "i8_mma.cuh"
#include "snap_i8.cuh"

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (M, K) f32; xq scratch (M, K) int8; w (L, N, K) int8; a_q (L, G) f32;
// a_scale (L,) f32; scales (L, N) f32; out (M, N) f32, all on the device.
// K % 64 == 0; OVP (ovp != 0): segments of seg_tiles * 64 rows, blocks of
// `fold` segments, K % (64 * seg_tiles * fold) == 0 (the wrapper checks).
// Returns a cudaError_t.
int stacked_prefill_matmul(const float* x, int8_t* xq, const int8_t* w,
                           const float* a_q, const float* a_scale,
                           const float* scales, float* out, int l, int M,
                           int K, int N, int G, int seg_tiles, int fold,
                           int ovp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_snap(x, xq, a_q, a_scale, l, M, K, G, s);
  if (err != cudaSuccess) return (int)err;
  const int8_t* wl = w + (long)l * N * K;
  const float* sl = scales + (long)l * N;
  launch_i8_mma(xq, wl, sl, out, M, K, N, seg_tiles, fold, ovp != 0, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
