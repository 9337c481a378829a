// The decode-size int8 product of K1 (stacked_i8.cu) and K9
// (w8a8_matmul.cu): out[m, n] = f32(sum_k xq[m, k] * w[n, k]) * scales[n]
// for xq (M, K) int8 snapped codes and an N-major (N, K) int8 weight. Each
// warp owns one output column n, whose K weight bytes are one contiguous
// row, read once with 16-byte loads; x codes are re-read from L1/L2. M
// rows are processed MT at a time so each lane keeps MT int32 accumulators
// in registers (__dp4a, exact); a warp shuffle sums the lanes; one f32
// multiply by the column's scale. K % 16 == 0, 16-byte aligned buffers.
#pragma once

#include "snap_i8.cuh"

namespace {

template <int MT>
__global__ void i8_matmul_kernel(const int8_t* __restrict__ xq,
                                 const int8_t* __restrict__ w,
                                 const float* __restrict__ scales,
                                 float* __restrict__ out, int M, int K,
                                 int N) {
  const int n = (int)(((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= N) return;  // whole warps leave together
  const int4* wrow = reinterpret_cast<const int4*>(w + (long)n * K);
  const int k16 = K / 16;
  for (int m0 = 0; m0 < M; m0 += MT) {
    int acc[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[r] = 0;
#pragma unroll 4
    for (int i = lane; i < k16; i += 32) {
      const int4 wv = __ldg(wrow + i);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        if (m0 + r < M) {
          const int4 xv = __ldg(
              reinterpret_cast<const int4*>(xq + (long)(m0 + r) * K) + i);
          acc[r] = dot16(xv, wv, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MT; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    if (lane == 0) {
      const float sc = scales[n];
#pragma unroll
      for (int r = 0; r < MT; ++r)
        if (m0 + r < M) out[(long)(m0 + r) * N + n] = (float)acc[r] * sc;
    }
  }
}

template <int MT>
void launch_matmul(const int8_t* xq, const int8_t* w, const float* scales,
                   float* out, int M, int K, int N, cudaStream_t s) {
  const int threads = 256;  // 8 warps, one output column each
  const int blocks = (N + 7) / 8;
  i8_matmul_kernel<MT><<<blocks, threads, 0, s>>>(xq, w, scales, out, M, K,
                                                  N);
}

// Any M: MT rows at a time, MT the smallest of 1, 2, 4, 8 that covers M
// (8 above 4).
void launch_i8_dot(const int8_t* xq, const int8_t* w, const float* scales,
                   float* out, int M, int K, int N, cudaStream_t s) {
  if (M <= 1)
    launch_matmul<1>(xq, w, scales, out, M, K, N, s);
  else if (M <= 2)
    launch_matmul<2>(xq, w, scales, out, M, K, N, s);
  else if (M <= 4)
    launch_matmul<4>(xq, w, scales, out, M, K, N, s);
  else
    launch_matmul<8>(xq, w, scales, out, M, K, N, s);
}

}  // namespace
