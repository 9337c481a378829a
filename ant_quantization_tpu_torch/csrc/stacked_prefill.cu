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
// int8 ops per dot against 16.8 MB of weights, far above the card's
// ops-per-byte line, so the product runs on the int8 tensor cores
// (wgmma, the only path to their full rate), fed from the int8 scratch
// that the snap pre-kernel wrote, behind a TMA-fed mbarrier ring. Int8
// values: xq as wgmma's A and the weight tile as B, both from shared
// memory (i8_wgmma.cuh, shared with K9). OVP bytes: the weight tile as
// the register-held A, loaded by ldmatrix and clamped in registers for
// the second dot, the codes as B, and the segments' f32 sums kept per
// output (ovp_wgmma.cuh).

#include "i8_wgmma.cuh"
#include "ovp_wgmma.cuh"
#include "snap_i8.cuh"

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (M, K) f32; xq scratch (M, K) int8; w (L, N, K) int8; a_q (L, G) f32;
// a_scale (L,) f32; scales (L, N) f32; out (M, N) f32, all on the device.
// K % 64 == 0; OVP (ovp != 0): segments of seg rows, seg % 64 == 0,
// blocks of `fold` segments, K % (seg * fold) == 0 (the wrapper checks).
// Returns a cudaError_t.
int stacked_prefill_matmul(const float* x, int8_t* xq, const int8_t* w,
                           const float* a_q, const float* a_scale,
                           const float* scales, float* out, int l, int L,
                           int M, int K, int N, int G, int seg, int fold,
                           int ovp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_snap(x, xq, a_q, a_scale, l, M, K, G, s);
  if (err != cudaSuccess) return (int)err;
  const float* sl = scales + (long)l * N;
  if (ovp)
    return (int)ow::launch_ovp_wgmma(xq, w, L, l, sl, out, M, K, N, seg,
                                     fold, s);
  return (int)wg::launch_i8_wgmma(xq, w, L, l, sl, out, M, K, N, s);
}

// The snap pre-kernel alone (K5's first step, timed apart): x (M, K) f32
// -> xq (M, K) int8 with layer l's a_q (L, G) and a_scale (L,).
int snap_i8_matrix(const float* x, int8_t* xq, const float* a_q,
                   const float* a_scale, int l, int M, int K, int G,
                   void* stream) {
  return (int)launch_snap(x, xq, a_q, a_scale, l, M, K, G,
                          (cudaStream_t)stream);
}

}  // extern "C"
