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
// the result. Each block's dots are exact int32 (a shuffle reduction of
// integers is order-free); every lane of the warp then does the f32 steps
// in the reference's order on the broadcast block sums. They are written
// with __fmul_rn / __fadd_rn / __fsub_rn because nvcc contracts a plain
// a*b - c*d into an FMA, which would round once where the reference
// rounds twice.
//
// What bounds it: at decode (M = 4) each call reads K*N weight bytes
// once, but does four dots (2 when w_ovp = 0) per weight byte: 8*M*K*N
// int8 operations on __dp4a, with the weight clamp (__vmins4/__vmaxs4)
// per word. At M = 4 the dp4a instruction rate, not the bytes, is expected to
// bind. Design: a first kernel encodes x once into two int8 (M, K) rows
// (cx and px, 2*M*K bytes, they stay in L2), one thread per OVP pair; the
// matmul kernel gives each warp one output column n, whose K weight bytes
// are one contiguous row of the N-major (L, N, K) stack, read once with
// 16-byte loads and clamped in registers; the activation rows are re-read
// from L1/L2. M rows are processed MT at a time, each lane holding 4*MT
// int32 accumulators. The layer index only offsets the pointers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void aovp_encode_kernel(const float* __restrict__ x,
                                   int8_t* __restrict__ cx,
                                   int8_t* __restrict__ px,
                                   const float* __restrict__ prescale,
                                   const float* __restrict__ mids,
                                   const int* __restrict__ ties,
                                   const float* __restrict__ enc, int G,
                                   long pairs) {
  const float sc = *prescale;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < pairs;
       i += (long)gridDim.x * blockDim.x) {
    float c[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float xs = x[2 * i + e] / sc;
      float v = enc[0];
      for (int j = 0; j < G - 1; ++j) {
        const float m = mids[j];
        if (xs > m || (xs == m && ties[j] > 0)) v = enc[j + 1];
      }
      c[e] = v;
    }
    const bool out_even = fabsf(c[0]) > 64.f;
    const bool out_odd = fabsf(c[1]) > 64.f;
    if (out_even)
      c[1] = 0.f;
    else if (out_odd)
      c[0] = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      cx[2 * i + e] = (int8_t)__float2int_rn(c[e]);
      px[2 * i + e] = (int8_t)__float2int_rn(fminf(fmaxf(c[e], -64.f), 64.f));
    }
  }
}

__device__ __forceinline__ int dot16(const int4& a, const int4& b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  acc = __dp4a(a.w, b.w, acc);
  return acc;
}

__device__ __forceinline__ int4 ovp_clip16(const int4& w) {
  // clip(c, -64, 64) on each signed byte
  int4 p;
  p.x = __vmaxs4(__vmins4(w.x, 0x40404040), 0xC0C0C0C0);
  p.y = __vmaxs4(__vmins4(w.y, 0x40404040), 0xC0C0C0C0);
  p.z = __vmaxs4(__vmins4(w.z, 0x40404040), 0xC0C0C0C0);
  p.w = __vmaxs4(__vmins4(w.w, 0x40404040), 0xC0C0C0C0);
  return p;
}

// A block is `seg` rows of K (16..512 with seg/16 dividing 32, or a
// multiple of 512): g = min(seg, 512)/16 lanes share one, a warp pass of
// 512 rows ends 32/g blocks, or one block ends every seg/512 passes.
template <int MT, bool W_OVP>
__global__ void aovp_matmul_kernel(const int8_t* __restrict__ cx,
                                   const int8_t* __restrict__ px,
                                   const int8_t* __restrict__ w,
                                   const float* __restrict__ scales,
                                   float* __restrict__ out, int M, int K,
                                   int N, int seg) {
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
    // d[r][0..3] = cx@w, cx@pw, px@w, px@pw (W_OVP) or cx@w, px@w
    int d[MT][4];
    float acc[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      acc[r] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) d[r][q] = 0;
    }
    int done = 0;  // blocks finished so far
    for (int it = 0; it < n_pass; ++it) {
      const int i = it * 32 + lane;
      if (i < k16) {
        const int4 wv = __ldg(wrow + i);
        const int4 pv = ovp_clip16(wv);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          if (m0 + r < M) {
            const long row = (long)(m0 + r) * K;
            const int4 cv = __ldg(reinterpret_cast<const int4*>(cx + row) + i);
            const int4 qv = __ldg(reinterpret_cast<const int4*>(px + row) + i);
            if (W_OVP) {
              d[r][0] = dot16(cv, wv, d[r][0]);
              d[r][1] = dot16(cv, pv, d[r][1]);
              d[r][2] = dot16(qv, wv, d[r][2]);
              d[r][3] = dot16(qv, pv, d[r][3]);
            } else {
              d[r][0] = dot16(cv, wv, d[r][0]);
              d[r][1] = dot16(qv, wv, d[r][1]);
            }
          }
        }
      }
      if ((it + 1) % reps) continue;
      constexpr int nd = W_OVP ? 4 : 2;
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int q = 0; q < nd; ++q)
          for (int off = g / 2; off > 0; off >>= 1)
            d[r][q] += __shfl_xor_sync(0xffffffffu, d[r][q], off);
      for (int j = 0; j < per_pass && done < n_seg; ++j, ++done) {
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          float f[nd];
#pragma unroll
          for (int q = 0; q < nd; ++q)
            f[q] = __int2float_rn(__shfl_sync(0xffffffffu, d[r][q], j * g));
          float part;
          if (W_OVP) {
            part = __fsub_rn(__fmul_rn(256.f, f[0]), __fmul_rn(240.f, f[1]));
            part = __fsub_rn(part, __fmul_rn(240.f, f[2]));
            part = __fadd_rn(part, __fmul_rn(225.f, f[3]));
          } else {
            part = __fsub_rn(__fmul_rn(16.f, f[0]), __fmul_rn(15.f, f[1]));
          }
          acc[r] = __fadd_rn(acc[r], part);
        }
      }
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[r][q] = 0;
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
void launch_matmul(const int8_t* cx, const int8_t* px, const int8_t* w,
                   const float* scales, float* out, int M, int K, int N,
                   int seg, bool w_ovp, cudaStream_t s) {
  const int threads = 256;  // 8 warps, one output column each
  const int blocks = (N + 7) / 8;
  if (w_ovp)
    aovp_matmul_kernel<MT, true><<<blocks, threads, 0, s>>>(
        cx, px, w, scales, out, M, K, N, seg);
  else
    aovp_matmul_kernel<MT, false><<<blocks, threads, 0, s>>>(
        cx, px, w, scales, out, M, K, N, seg);
}

}  // namespace

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (M, K) f32; cx, px scratch (M, K) int8; w (L, N, K) int8; prescale
// (L,) f32; mids and ties (L, G-1) f32 / int32; enc (L, G) f32; scales
// (L, N) f32; out (M, N) f32, all on the device. K % 16 == 0, K % seg ==
// 0 with seg as above, 16-byte aligned buffers (the wrapper checks).
// Returns a cudaError_t.
int stacked_aovp_matmul(const float* x, int8_t* cx, int8_t* px,
                        const int8_t* w, const float* prescale,
                        const float* mids, const int* ties, const float* enc,
                        const float* scales, float* out, int l, int M, int K,
                        int N, int G, int seg, int w_ovp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long pairs = (long)M * K / 2;
  const int ethreads = 256;
  long eblocks = (pairs + ethreads - 1) / ethreads;
  if (eblocks > 1024) eblocks = 1024;
  aovp_encode_kernel<<<(int)eblocks, ethreads, 0, s>>>(
      x, cx, px, prescale + l, mids + (long)l * (G - 1),
      ties + (long)l * (G - 1), enc + (long)l * G, G, pairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int8_t* wl = w + (long)l * N * K;
  const float* sl = scales + (long)l * N;
  const bool wo = w_ovp != 0;
  if (M <= 1)
    launch_matmul<1>(cx, px, wl, sl, out, M, K, N, seg, wo, s);
  else if (M <= 2)
    launch_matmul<2>(cx, px, wl, sl, out, M, K, N, seg, wo, s);
  else if (M <= 4)
    launch_matmul<4>(cx, px, wl, sl, out, M, K, N, seg, wo, s);
  else
    launch_matmul<8>(cx, px, wl, sl, out, M, K, N, seg, wo, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
