// K6: activation snap + packed-4-bit x int8 matmul for one layer of a
// stacked weight ("w4pack" decode), hand-written for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel
// ant_quantization_tpu/kernels/stacked.py:stacked_quant_matmul, mode "p4"
// (_p4_kernel). The weights are 4-bit codes packed two to a byte in
// split-K halves, stored N-major (L, N, K/2): byte i of column n holds
// code(i, n) in the low nibble and code(i + K/2, n) in the high nibble.
// Each nibble decodes to an int8 value, `code - 8` for the affine int
// grids or q16[l][code] through the layer's 16-entry table, and
//
//   out[m, n] = f32(sum_i xq[m, i] dec(lo(i, n)) + xq[m, i + K/2] dec(hi(i, n)))
//               * scales[l, n]
//
// with xq = snap(x / a_scale[l]; a_q[l]) (K1's snap). The sum is exact in
// int32 (|q16| <= 127, K <= 2^17), so the result equals the plain
// version's bit for bit whatever the order.
//
// What bounds it: at decode (M = 4) the weight stream, K*N/2 bytes per
// call, half of K1's. Design: K1's staged split-K weight stream
// (i8_stream.cuh) with a weight-decode policy, in one launch (no snap
// pre-kernel, no (M, K) code scratch): TMA stages of 128 packed bytes by
// 128 columns on the stack's cached 3-D map; the snap fused a stage ahead
// into a shared buffer that holds each stage's two x ranges, [k0, k0 +
// 128) and [K/2 + k0, K/2 + k0 + 128), the B operand of int8 mma.sync
// m16n8k32 for every column of the block; the weight stage read by
// ldmatrix as the A operand and its nibbles decoded in registers (an add
// and an xor per word, or two __byte_perm lookups into the 16-byte table
// held in four registers and a pick by bit 3), so the decode, not the
// dots, takes the integer issue slots; K split until the card is full
// (kernels/stacked.py:k6_plan), the splits' exact int32 partials added by
// the tile's last split in K1's workspace. The layer index only offsets
// the TMA coordinates.

#include "i8_stream.cuh"

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (M, K) f32; w (L, N, K/2) uint8; q16 (L, 16) int32; a_q (L, G) f32;
// a_scale (L,) f32; scales (L, N) f32; out (M, N) f32, all on the device;
// ws and count: the split-K workspace (unused when splits == 1). mt and
// splits: the wrapper's plan. K/2 % 16 == 0, x and w 16-byte aligned (the
// wrapper checks). Returns a cudaError_t.
int stacked_p4_matmul(const float* x, const uint8_t* w, const int* q16,
                      const float* a_q, const float* a_scale,
                      const float* scales, float* out, int* ws,
                      unsigned* count, int l, int L, int M, int K, int N,
                      int G, int affine, int mt, int splits, void* stream) {
  return (int)st::launch_p4_stream(x, w, L, l, q16, a_q, a_scale, scales,
                                   out, ws, count, M, K, N, G, affine != 0,
                                   mt, splits, (cudaStream_t)stream);
}

}  // extern "C"
