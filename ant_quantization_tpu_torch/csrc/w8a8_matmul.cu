// K9: activation snap + int8 x int8 matmul for one standalone weight,
// hand-written for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel
// ant_quantization_tpu/kernels/qmatmul.py:fused_w8a8_matmul (_w8a8_kernel):
//
//   out[m, n] = f32(sum_k int8(snap(x[m, k] * inv; a_q)) * w[n, k]) * out_scale[n]
//
// with inv = 1 / a_scale, one IEEE f32 division, and x * inv an f32
// multiply (K1 divides instead: each mirrors its own reference), `>=`
// against the f32 midpoints (aq[i] + aq[i+1]) * 0.5, int32 accumulation,
// one f32 multiply at the end. Bit for bit like the plain PyTorch version
// (kernels/qmatmul.py): no --use_fast_math, exact integer sums.
//
// What bounds it: at decode-size M the weight stream (K * N bytes against
// 2 * M * K * N int8 operations), at prefill-size M the operations. The
// weight is N-major (N, K), as the port stores every int8 weight. Design:
// the snap pre-kernel of snap_i8.cuh (reciprocal mode) writes the int8
// codes once; M <= 64 then runs K1's product (i8_dot.cuh: a warp per
// output column, 16-byte loads, __dp4a), larger M K5's (i8_wgmma.cuh:
// wgmma on the int8 tensor cores from a TMA-fed mbarrier ring).

#include "i8_dot.cuh"
#include "i8_wgmma.cuh"
#include "snap_i8.cuh"

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (M, K) f32; xq scratch (M, K) int8; w (N, K) int8; a_q (G,) f32
// sorted; a_scale (1,) f32; out_scale (N,) f32; out (M, N) f32, all on the
// device, 16-byte aligned. K % 16 == 0, and K % 64 == 0 when M > 64 (the
// wrapper checks). Returns a cudaError_t.
int w8a8_matmul(const float* x, int8_t* xq, const int8_t* w,
                const float* a_q, const float* a_scale,
                const float* out_scale, float* out, int M, int K, int N,
                int G, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_snap(x, xq, a_q, a_scale, 0, M, K, G, s, true);
  if (err != cudaSuccess) return (int)err;
  if (M > 64)
    return (int)wg::launch_i8_wgmma(xq, w, 1, 0, out_scale, out, M, K, N, s);
  launch_i8_dot(xq, w, out_scale, out, M, K, N, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
