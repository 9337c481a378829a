// K8: x (M, K) f32 @ packed 4-bit weights decoded through an f32 grid,
// times a per-output-channel scale, hand-written for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel
// ant_quantization_tpu/kernels/qmatmul.py:quantized_matmul_w4
// (_qmm_kernel):
//
//   out[m, n] = (sum_i x[m, i] grid[lo(i, n)] + x[m, i + K/2] grid[hi(i, n)])
//               * scale[n]
//
// over split-K packed bytes, stored N-major (N, K/2): byte i of column n
// holds code(i, n) low and code(i + K/2, n) high. The product is an f32
// dot, as the reference's `dot(preferred_element_type=f32)`: f32 FMAs on
// the CUDA cores, no TF32 and no tensor cores. Its sum order is not the
// reference's or the plain version's, so the three agree within the
// rounding of an f32 dot. The scale multiplies once at the end.
//
// What bounds it: operations. At prefill (M = 2048) a 4096 x 4096 site is
// 6.9e10 f32 FLOP against 8.4 MB of packed weights; f32 outside the tensor
// cores peaks at 67 TFLOP/s. Design: the classic tiled SGEMM. A block
// computes a 128 x 128 output tile with 256 threads, each an 8 x 8
// register tile (rows ty*4.. and 64+ty*4.., columns likewise, so the
// shared reads are float4 broadcasts or contiguous). K runs in steps of
// 16 packed bytes = 32 K values: the x tile (16 low-half and 16
// high-half columns) and the weight tile, decoded on the way in through
// the 16-entry grid held in shared memory, are stored k-major in shared
// memory, then each thread does 64 FMAs per k. The packed bytes are read
// once per M tile (K/2 bytes per column, half of int8).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK2 = 16;  // BK2 packed bytes per step
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    w4_f32_matmul_kernel(const float* __restrict__ x,
                         const uint8_t* __restrict__ packed,
                         const float* __restrict__ scale,
                         const float* __restrict__ grid,
                         float* __restrict__ out, int M, int K, int N) {
  __shared__ float sg[16];
  __shared__ __align__(16) float As[2 * BK2][BM];  // rows: k (lo, then hi)
  __shared__ __align__(16) float Bs[2 * BK2][BN];
  const int tid = threadIdx.x;
  if (tid < 16) sg[tid] = grid[tid];
  const int K2 = K / 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = tid & 15, ty = tid >> 4;
  // loaders: x row m0 + (tid & 127), half (tid >> 7) of the step's K;
  // packed column n0 + (tid & 127), bytes 8 (tid >> 7) .. + 8
  const int lr = tid & 127, lh = tid >> 7;
  const bool a_ok = m0 + lr < M, b_ok = n0 + lr < N;
  const float* xrow = x + (long)(a_ok ? m0 + lr : 0) * K + lh * K2;
  const uint8_t* wrow = packed + (long)(b_ok ? n0 + lr : 0) * K2 + 8 * lh;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  __syncthreads();  // sg

  for (int k0 = 0; k0 < K2; k0 += BK2) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = a_ok ? *reinterpret_cast<const float4*>(xrow + k0 + 4 * q)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      As[lh * BK2 + 4 * q + 0][lr] = v.x;
      As[lh * BK2 + 4 * q + 1][lr] = v.y;
      As[lh * BK2 + 4 * q + 2][lr] = v.z;
      As[lh * BK2 + 4 * q + 3][lr] = v.w;
    }
    const uint2 wv = b_ok ? *reinterpret_cast<const uint2*>(wrow + k0)
                          : make_uint2(0u, 0u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t byte = ((j < 4 ? wv.x : wv.y) >> (8 * (j & 3))) & 0xFFu;
      Bs[8 * lh + j][lr] = sg[byte & 15u];
      Bs[BK2 + 8 * lh + j][lr] = sg[byte >> 4];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < 2 * BK2; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) out[(long)m * N + n] = __fmul_rn(acc[i][j], scale[n]);
    }
  }
}

}  // namespace

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (M, K) f32, 16-byte aligned; packed (N, K/2) uint8, 8-byte aligned;
// scale (N,) f32; grid (16,) f32; out (M, N) f32, all on the device.
// K/2 % 16 == 0 (the wrapper checks). Returns a cudaError_t.
int w4_f32_matmul(const float* x, const uint8_t* packed, const float* scale,
                  const float* grid, float* out, int M, int K, int N,
                  void* stream) {
  const dim3 blocks((N + BN - 1) / BN, (M + BM - 1) / BM);
  w4_f32_matmul_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, packed, scale, grid, out, M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
