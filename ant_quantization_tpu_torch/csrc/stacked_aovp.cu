// K4: full-OliVe stacked matmul, OVP-encoded activations x int8 weights
// (OVP-encoded or int8 codebook values), for one layer of a stacked
// weight, hand-written for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel
// ant_quantization_tpu/kernels/stacked.py:stacked_quant_matmul_aovp
// (_aovp_kernel). Bit for bit like the plain PyTorch version
// (kernels/stacked.py:stacked_quant_matmul_aovp_plain):
//   1. xs = x / prescale[l], an IEEE f32 division (this file must not be
//      built with --use_fast_math);
//   2. a snap onto the sorted grid || outlier concat straight to the
//      encoded byte: c = enc[0], then for each of the G-1 midpoints
//      c = enc[i+1] where xs > mid[i], or xs == mid[i] and tie[i] (the
//      reference's select chain, whose tie flags send an exact midpoint
//      to the entry that comes later in the unsorted concat);
//   3. OVP victims on pairs (2k, 2k+1) along K, |c| > 64 marking an
//      outlier: an outlier at the even slot zeroes the odd slot, else an
//      outlier at the odd slot zeroes the even slot (ops/ovp.py);
//   4. cx = c, px = clip(c, -64, 64) as int8. With x = 16 cx - 15 px and
//      w = 16 cw - 15 pw (pw = clip(w, -64, 64)), per K block of `seg`
//      rows the four exact int32 dots d1 = cx@w, d2 = cx@pw, d3 = px@w,
//      d4 = px@pw become part = ((256 d1 - 240 d2) - 240 d3) + 225 d4 in
//      f32 (16 d1 - 15 d3 for int8-value weights), acc += part block by
//      block, then one f32 multiply by scales[l, n].
// The f32 steps round (240 d2 needs more than 24 bits), so their order is
// the result; nvcc would contract a plain a*b - c*d into an FMA, which
// rounds once where the reference rounds twice, so they are written with
// __fmul_rn / __fadd_rn / __fsub_rn.
//
// What bounds it: at decode (M = 4) each call reads K*N weight bytes
// once, against four int8 dots (two when w_ovp = 0) of 2*M*K*N operations
// each: bytes. Design: one launch on K1's staged split-K weight stream,
// the encode fused into each block a stage ahead of the product, the
// dots on the int8 tensor cores (mma.sync) with the weight clamp in
// registers, K split only between f32 blocks, so each split forms its
// blocks' f32 sums in order and the last one chains them (ovp_stream.cuh).

#include "ovp_stream.cuh"

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (M, K) f32; w (L, N, K) int8; prescale (L,) f32; mids and ties
// (L, G-1) f32 / int32; enc (L, G) f32, G <= 32; scales (L, N) f32; out
// (M, N) f32, all on the device; ws and count: the split-K workspace
// (unused when splits == 1). seg rows per f32 block; mt and splits: the
// wrapper's plan. K % 16 == 0, K % seg == 0 with seg a multiple of 128 or
// all of K, 16-byte aligned x and w (the wrapper checks). Returns a
// cudaError_t.
int stacked_aovp_matmul(const float* x, const int8_t* w,
                        const float* prescale, const float* mids,
                        const int* ties, const float* enc,
                        const float* scales, float* out, float* ws,
                        unsigned* count, int l, int L, int M, int K, int N,
                        int G, int seg, int w_ovp, int mt, int splits,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (w_ovp)
    return (int)ovs::launch_ovp_stream<ovs::K4_OVP>(
        x, w, L, l, prescale, mids, ties, enc, scales, out, ws, count, M,
        K, N, G, seg, 1, mt, splits, s);
  return (int)ovs::launch_ovp_stream<ovs::K4_I8>(
      x, w, L, l, prescale, mids, ties, enc, scales, out, ws, count, M, K,
      N, G, seg, 1, mt, splits, s);
}

}  // extern "C"
