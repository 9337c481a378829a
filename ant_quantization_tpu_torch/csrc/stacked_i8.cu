// K1 and K3: activation snap + int8 x int8 matmul for one layer of a
// stacked weight, hand-written for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel
// ant_quantization_tpu/kernels/stacked.py:stacked_quant_matmul, mode "i8"
// (_i8_kernel and _snap_int8): K1 with ovp=False, K3 with ovp=True
// (_ovp_dual_dot). K1 computes
//
//   out[m, n] = f32(sum_k int8(snap(x[m, k] / a_scale[l]; a_q[l])) * W[l, n, k])
//               * scales[l, n]
//
// bit for bit like the plain PyTorch version (kernels/stacked.py):
//   - x / a_scale[l] is an IEEE f32 division (this file must not be built
//     with --use_fast_math);
//   - the snap compares x >= (aq[i] + aq[i+1]) * 0.5 in f32, ties to the
//     larger entry;
//   - the dot accumulates exactly in int32 (__dp4a), then one f32 multiply.
//
// K3 takes sign-offset OVP weight bytes c (kernels/qmatmul.py), whose
// value is 16 c - 15 clip(c, -64, 64). Its arithmetic is the reference's:
// per 256-row sub-chunk ("segment") the int32 16 x@c - 15 x@clip(c),
// converted to f32; the segments summed in f32 in order within each K
// block of _fit(K, block_k) rows; the blocks summed in order into an f32
// accumulator; one f32 multiply by scales[l, n]. Above 2^24 those f32
// steps round, so their order is the result: the int32 segment values are
// exact (their order is free), and one thread per output runs the f32
// steps in the reference's order, as __fadd_rn / __fmul_rn, which nvcc
// never contracts into an FMA.
//
// What bounds it: at decode (M = 4) the weight stream, K*N bytes per call
// (16.8 MB for a 4096 x 4096 site), against 2*M*K*N int8 operations per
// dot, so it is bound by bytes. K1's design is i8_stream.cuh (shared with
// K9 at M <= 64): one launch, the snap fused into each block, the weight
// stream staged by TMA and split along K until the card is full. K3 runs
// on the same stream (ovp_stream.cuh, shared with K4): both dots on the
// int8 tensor cores from one read of the stream, the weight clamp in
// registers, and K split only between f32 blocks, so that each split forms
// its blocks' f32 sums in the reference's order and the tile's last split
// chains them. The layer index only offsets the TMA coordinates: no
// per-layer copy of the stack exists.

#include "i8_stream.cuh"
#include "ovp_stream.cuh"

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1. x (M, K) f32; w (L, N, K) int8; a_q (L, G) f32; a_scale (L,) f32;
// scales (L, N) f32; out (M, N) f32, all on the device; ws and count: the
// split-K workspace (unused when splits == 1). mt and splits: the
// wrapper's plan. K % 16 == 0 and 16-byte aligned buffers
// (the wrapper checks). Returns a cudaError_t.
int stacked_i8_matmul(const float* x, const int8_t* w, const float* a_q,
                      const float* a_scale, const float* scales, float* out,
                      int* ws, unsigned* count, int l, int L, int M, int K,
                      int N, int G, int mt, int splits, void* stream) {
  return (int)st::launch_i8_stream(x, w, L, l, a_q, a_scale, scales, out, ws,
                                   count, M, K, N, G, mt, splits, false,
                                   (cudaStream_t)stream);
}

// K3: as stacked_i8_matmul on sign-offset OVP weight bytes; seg and fold
// give the f32 partition of K (segments of seg rows, blocks of fold
// segments); ws and count: the split-K workspace. K % (seg * fold) == 0,
// seg a multiple of 128 or all of K (the wrapper checks).
int stacked_i8_ovp_matmul(const float* x, const int8_t* w, const float* a_q,
                          const float* a_scale, const float* scales,
                          float* out, float* ws, unsigned* count, int l,
                          int L, int M, int K, int N, int G, int seg,
                          int fold, int mt, int splits, void* stream) {
  return (int)ovs::launch_ovp_stream<ovs::K3>(
      x, w, L, l, a_scale, nullptr, nullptr, a_q, scales, out, ws, count, M,
      K, N, G, seg, fold, mt, splits, (cudaStream_t)stream);
}

}  // extern "C"
