// The activation snap pre-kernel shared by K5 (stacked_prefill.cu) and K9
// above 64 rows (w8a8_matmul.cu):
// x / a_scale[l] (an IEEE f32 division; no --use_fast_math), or for K9
// (`recip`) x * inv with inv = 1 / a_scale[l] divided once, as the
// reference's fused_w8a8_matmul scales; snapped onto the int8-domain
// codebook a_q[l] by `>=` against the f32 midpoints (aq[i] + aq[i+1]) *
// 0.5, ties to the larger entry, written once into an int8 (M, K) scratch
// that the matmul kernel then reads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void snap_i8_kernel(const float* __restrict__ x,
                               int8_t* __restrict__ xq,
                               const float* __restrict__ aq,
                               const float* __restrict__ a_scale, int G,
                               long total, bool recip) {
  const float sc = *a_scale;
  const float inv = 1.0f / sc;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const float xs = recip ? x[i] * inv : x[i] / sc;
    int idx = 0;
    for (int g = 0; g < G - 1; ++g) {
      const float mid = (aq[g] + aq[g + 1]) * 0.5f;
      idx += (xs >= mid) ? 1 : 0;
    }
    xq[i] = (int8_t)__float2int_rn(aq[idx]);
  }
}

// x (M, K) f32 -> xq (M, K) int8 with layer l's a_q (L, G) and a_scale (L,)
cudaError_t launch_snap(const float* x, int8_t* xq, const float* a_q,
                        const float* a_scale, int l, int M, int K, int G,
                        cudaStream_t s, bool recip = false) {
  const long total = (long)M * K;
  const int sthreads = 256;
  long sblocks = (total + sthreads - 1) / sthreads;
  if (sblocks > 4096) sblocks = 4096;
  snap_i8_kernel<<<(int)sblocks, sthreads, 0, s>>>(
      x, xq, a_q + (long)l * G, a_scale + l, G, total, recip);
  return cudaGetLastError();
}

}  // namespace
