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
// M <= 64 runs K1's staged split-K weight stream with the snap fused into
// each block (i8_stream.cuh, in its reciprocal mode); larger M the snap
// pre-kernel of snap_i8.cuh (reciprocal mode), which writes the int8 codes
// once, then K5's product (i8_wgmma.cuh: wgmma on the int8 tensor cores
// from a TMA-fed mbarrier ring).

#include "i8_stream.cuh"
#include "i8_wgmma.cuh"
#include "snap_i8.cuh"

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (M, K) f32; xq scratch (M, K) int8 (M > 64); w (N, K) int8; a_q (G,)
// f32 sorted; a_scale (1,) f32; out_scale (N,) f32; out (M, N) f32, all on
// the device, 16-byte aligned; ws, count, mt, splits: K1's split-K
// workspace and plan (M <= 64). K % 16 == 0, and K % 64 == 0 when M > 64
// (the wrapper checks). Returns a cudaError_t.
int w8a8_matmul(const float* x, int8_t* xq, const int8_t* w,
                const float* a_q, const float* a_scale,
                const float* out_scale, float* out, int* ws,
                unsigned* count, int M, int K, int N, int G, int mt,
                int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 64)
    return (int)st::launch_i8_stream(x, w, 1, 0, a_q, a_scale, out_scale, out,
                                     ws, count, M, K, N, G, mt, splits, true,
                                     s);
  cudaError_t err = launch_snap(x, xq, a_q, a_scale, 0, M, K, G, s, true);
  if (err != cudaSuccess) return (int)err;
  return (int)wg::launch_i8_wgmma(xq, w, 1, 0, out_scale, out, M, K, N, s);
}

}  // extern "C"
