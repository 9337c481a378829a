// K1: activation snap + int8 x int8 matmul for one layer of a stacked
// weight, hand-written for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel
// ant_quantization_tpu/kernels/stacked.py:stacked_quant_matmul, mode "i8",
// ovp=False (_i8_kernel and _snap_int8). It computes
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
// What bounds it: at decode (M = 4) the weight stream, K*N bytes per call
// (16.8 MB for a 4096 x 4096 site), against 2*M*K*N int8 operations, so
// it is bound by bytes. Design: a first small kernel snaps x once into an
// int8 (M, K) scratch (M*K bytes, it stays in L2); the matmul kernel then
// gives each warp one output column n, whose K weight bytes are one
// contiguous row of the N-major (L, N, K) stack, read once with 16-byte
// loads; x codes are re-read from L1/L2. M rows are processed MT at a time
// so each lane keeps MT int32 accumulators in registers; a warp shuffle
// sums the lanes. The layer index only offsets the pointer: no per-layer
// copy of the stack exists.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void snap_i8_kernel(const float* __restrict__ x,
                               int8_t* __restrict__ xq,
                               const float* __restrict__ aq,
                               const float* __restrict__ a_scale, int G,
                               long total) {
  const float sc = *a_scale;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const float xs = x[i] / sc;
    int idx = 0;
    for (int g = 0; g < G - 1; ++g) {
      const float mid = (aq[g] + aq[g + 1]) * 0.5f;
      idx += (xs >= mid) ? 1 : 0;
    }
    xq[i] = (int8_t)__float2int_rn(aq[idx]);
  }
}

__device__ __forceinline__ int dot16(const int4& a, const int4& b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  acc = __dp4a(a.w, b.w, acc);
  return acc;
}

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

}  // namespace

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (M, K) f32; xq scratch (M, K) int8; w (L, N, K) int8; a_q (L, G) f32;
// a_scale (L,) f32; scales (L, N) f32; out (M, N) f32, all on the device.
// K % 16 == 0 and 16-byte aligned buffers (the wrapper checks).
// Returns a cudaError_t.
int stacked_i8_matmul(const float* x, int8_t* xq, const int8_t* w,
                      const float* a_q, const float* a_scale,
                      const float* scales, float* out, int l, int M, int K,
                      int N, int G, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long total = (long)M * K;
  const int sthreads = 256;
  long sblocks = (total + sthreads - 1) / sthreads;
  if (sblocks > 1024) sblocks = 1024;
  snap_i8_kernel<<<(int)sblocks, sthreads, 0, s>>>(
      x, xq, a_q + (long)l * G, a_scale + l, G, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int8_t* wl = w + (long)l * N * K;
  const float* sl = scales + (long)l * N;
  if (M <= 1)
    launch_matmul<1>(xq, wl, sl, out, M, K, N, s);
  else if (M <= 2)
    launch_matmul<2>(xq, wl, sl, out, M, K, N, s);
  else if (M <= 4)
    launch_matmul<4>(xq, wl, sl, out, M, K, N, s);
  else
    launch_matmul<8>(xq, wl, sl, out, M, K, N, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
