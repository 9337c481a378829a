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
// steps round, so their order is the result: each lane adds its own
// int32 16*d1 - 15*d2 (exact), a shuffle reduction over the lanes of one
// segment gives the segment's exact int32 (integer sums are order-free),
// and then every lane of the warp does the same f32 additions, in the
// reference's order, on the broadcast segment values. The f32 steps are
// written with __fadd_rn / __fmul_rn, which nvcc never contracts into an
// FMA. Per weight word the clamp is two SIMD byte ops
// (__vmins4/__vmaxs4), so both dots read the weight stream once.
//
// What bounds it: at decode (M = 4) the weight stream, K*N bytes per call
// (16.8 MB for a 4096 x 4096 site), against 2*M*K*N int8 operations per
// dot, so it is bound by bytes. K1's design is i8_stream.cuh (shared with
// K9 at M <= 64): one launch, the snap fused into each block, the weight
// stream staged by TMA and split along K until the card is full. K3's:
// the snap pre-kernel of snap_i8.cuh writes x's codes once into an int8
// (M, K) scratch; the matmul kernel then gives each warp one output column
// n, whose K weight bytes are one contiguous row of the N-major (L, N, K)
// stack, read once with 16-byte loads; x codes are re-read from L1/L2. M
// rows are processed MT at a time so each lane keeps MT int32 accumulators
// in registers. The layer index only offsets the pointer: no per-layer
// copy of the stack exists.

#include "i8_stream.cuh"
#include "snap_i8.cuh"

namespace {

__device__ __forceinline__ int4 ovp_clip16(const int4& w) {
  // clip(c, -64, 64) on each signed byte
  int4 p;
  p.x = __vmaxs4(__vmins4(w.x, 0x40404040), 0xC0C0C0C0);
  p.y = __vmaxs4(__vmins4(w.y, 0x40404040), 0xC0C0C0C0);
  p.z = __vmaxs4(__vmins4(w.z, 0x40404040), 0xC0C0C0C0);
  p.w = __vmaxs4(__vmins4(w.w, 0x40404040), 0xC0C0C0C0);
  return p;
}

// K3. A segment is `seg` rows of K (16..512 with seg/16 dividing 32, or a
// multiple of 512): g = min(seg, 512)/16 lanes share one, a warp pass of
// 512 rows ends 32/g segments, or one segment ends every seg/512 passes.
// `fold` segments make one f32 block.
template <int MT>
__global__ void i8_ovp_matmul_kernel(const int8_t* __restrict__ xq,
                                     const int8_t* __restrict__ w,
                                     const float* __restrict__ scales,
                                     float* __restrict__ out, int M, int K,
                                     int N, int seg, int fold) {
  const int n = (int)(((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= N) return;  // whole warps leave together
  const int4* wrow = reinterpret_cast<const int4*>(w + (long)n * K);
  const int k16 = K / 16;
  const int g = (seg < 512 ? seg : 512) / 16;
  const int per_pass = 32 / g;
  const int reps = seg > 512 ? seg / 512 : 1;
  const int n_seg = K / seg;
  const int n_pass = (k16 + 31) / 32;
  for (int m0 = 0; m0 < M; m0 += MT) {
    int p[MT];
    float part[MT], acc[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      p[r] = 0;
      part[r] = 0.f;
      acc[r] = 0.f;
    }
    int done = 0;  // segments finished so far
    for (int it = 0; it < n_pass; ++it) {
      const int i = it * 32 + lane;
      if (i < k16) {
        const int4 wv = __ldg(wrow + i);
        const int4 pv = ovp_clip16(wv);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          if (m0 + r < M) {
            const int4 xv = __ldg(
                reinterpret_cast<const int4*>(xq + (long)(m0 + r) * K) + i);
            p[r] += 16 * dot16(xv, wv, 0) - 15 * dot16(xv, pv, 0);
          }
        }
      }
      if ((it + 1) % reps) continue;
#pragma unroll
      for (int r = 0; r < MT; ++r)
        for (int off = g / 2; off > 0; off >>= 1)
          p[r] += __shfl_xor_sync(0xffffffffu, p[r], off);
      for (int j = 0; j < per_pass && done < n_seg; ++j, ++done) {
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const int v = __shfl_sync(0xffffffffu, p[r], j * g);
          part[r] = __fadd_rn(part[r], __int2float_rn(v));
        }
        if ((done + 1) % fold == 0) {
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            acc[r] = __fadd_rn(acc[r], part[r]);
            part[r] = 0.f;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < MT; ++r) p[r] = 0;
    }
    if (lane == 0) {
      const float sc = scales[n];
#pragma unroll
      for (int r = 0; r < MT; ++r)
        if (m0 + r < M) out[(long)(m0 + r) * N + n] = __fmul_rn(acc[r], sc);
    }
  }
}

template <int MT>
void launch_ovp_matmul(const int8_t* xq, const int8_t* w, const float* scales,
                       float* out, int M, int K, int N, int seg, int fold,
                       cudaStream_t s) {
  const int threads = 256;  // 8 warps, one output column each
  const int blocks = (N + 7) / 8;
  i8_ovp_matmul_kernel<MT><<<blocks, threads, 0, s>>>(xq, w, scales, out, M,
                                                      K, N, seg, fold);
}

}  // namespace

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
// segments). K % (seg * fold) == 0 and the segment rule above (the
// wrapper checks).
int stacked_i8_ovp_matmul(const float* x, int8_t* xq, const int8_t* w,
                          const float* a_q, const float* a_scale,
                          const float* scales, float* out, int l, int M,
                          int K, int N, int G, int seg, int fold,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_snap(x, xq, a_q, a_scale, l, M, K, G, s);
  if (err != cudaSuccess) return (int)err;
  const int8_t* wl = w + (long)l * N * K;
  const float* sl = scales + (long)l * N;
  if (M <= 1)
    launch_ovp_matmul<1>(xq, wl, sl, out, M, K, N, seg, fold, s);
  else if (M <= 2)
    launch_ovp_matmul<2>(xq, wl, sl, out, M, K, N, seg, fold, s);
  else if (M <= 4)
    launch_ovp_matmul<4>(xq, wl, sl, out, M, K, N, seg, fold, s);
  else
    launch_ovp_matmul<8>(xq, wl, sl, out, M, K, N, seg, fold, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
