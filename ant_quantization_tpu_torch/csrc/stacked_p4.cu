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
// with xq = snap(x / a_scale[l]; a_q[l]) (the pre-kernel of snap_i8.cuh,
// K1's). The sum is exact in int32 (|q16| <= 127, K <= 2^17), so the
// result equals the plain version's bit for bit whatever the order.
//
// What bounds it: at decode (M = 4) the weight stream, K*N/2 bytes per
// call, half of K1's. Design as K1: one warp per output column streams
// the column's K/2 packed bytes once with 16-byte loads. In registers
// each 32-bit word gives two words of 4 int8 values: the nibbles are
// masked out with one AND (and a shift for the high ones), then decoded
// by one SIMD byte subtract (affine) or by two __byte_perm lookups into
// the 16-byte table held in four registers, merged by a byte compare.
// The low word pairs with xq[m, i..i+3], the high word with
// xq[m, K/2+i..K/2+i+3], both through __dp4a. The layer index only
// offsets the pointer.

#include "snap_i8.cuh"

namespace {

// 4 nibbles (one per byte, 0..15) -> their 4 int8 table values
__device__ __forceinline__ uint32_t lut16(uint32_t nib, uint32_t t0,
                                          uint32_t t1, uint32_t t2,
                                          uint32_t t3) {
  const uint32_t s = nib | (nib >> 4);           // n0|n1<<4 .. n2|n3<<4
  const uint32_t sel = ((s & 0xFFu) | ((s >> 8) & 0xFF00u)) & 0x7777u;
  const uint32_t lo = __byte_perm(t0, t1, sel);  // entries 0..7
  const uint32_t hi = __byte_perm(t2, t3, sel);  // entries 8..15
  const uint32_t take_hi = __vcmpgeu4(nib, 0x08080808u);
  return (hi & take_hi) | (lo & ~take_hi);
}

template <bool AFFINE>
__device__ __forceinline__ void decode16(const int4& w, uint32_t t0,
                                         uint32_t t1, uint32_t t2,
                                         uint32_t t3, int4& lo, int4& hi) {
  const uint32_t ws[4] = {(uint32_t)w.x, (uint32_t)w.y, (uint32_t)w.z,
                          (uint32_t)w.w};
  uint32_t l[4], h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t nl = ws[j] & 0x0F0F0F0Fu;
    const uint32_t nh = (ws[j] >> 4) & 0x0F0F0F0Fu;
    if (AFFINE) {
      l[j] = __vsub4(nl, 0x08080808u);
      h[j] = __vsub4(nh, 0x08080808u);
    } else {
      l[j] = lut16(nl, t0, t1, t2, t3);
      h[j] = lut16(nh, t0, t1, t2, t3);
    }
  }
  lo = make_int4((int)l[0], (int)l[1], (int)l[2], (int)l[3]);
  hi = make_int4((int)h[0], (int)h[1], (int)h[2], (int)h[3]);
}

template <int MT, bool AFFINE>
__global__ void p4_matmul_kernel(const int8_t* __restrict__ xq,
                                 const uint8_t* __restrict__ w,
                                 const int* __restrict__ q16,
                                 const float* __restrict__ scales,
                                 float* __restrict__ out, int M, int K,
                                 int N) {
  const int n = (int)(((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= N) return;  // whole warps leave together
  uint32_t t[4] = {0u, 0u, 0u, 0u};
  if (!AFFINE) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      t[i >> 2] |= ((uint32_t)q16[i] & 0xFFu) << (8 * (i & 3));
  }
  const int K2 = K / 2;
  const int4* wrow = reinterpret_cast<const int4*>(w + (long)n * K2);
  const int k16 = K2 / 16;
  for (int m0 = 0; m0 < M; m0 += MT) {
    int acc[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[r] = 0;
#pragma unroll 4
    for (int i = lane; i < k16; i += 32) {
      int4 lo, hi;
      decode16<AFFINE>(__ldg(wrow + i), t[0], t[1], t[2], t[3], lo, hi);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        if (m0 + r < M) {
          const int8_t* xr = xq + (long)(m0 + r) * K;
          const int4 xl = __ldg(reinterpret_cast<const int4*>(xr) + i);
          const int4 xh = __ldg(reinterpret_cast<const int4*>(xr + K2) + i);
          acc[r] = dot16(xh, hi, dot16(xl, lo, acc[r]));
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
void launch_matmul(const int8_t* xq, const uint8_t* w, const int* q16,
                   const float* scales, float* out, int M, int K, int N,
                   bool affine, cudaStream_t s) {
  const int threads = 256;  // 8 warps, one output column each
  const int blocks = (N + 7) / 8;
  if (affine)
    p4_matmul_kernel<MT, true><<<blocks, threads, 0, s>>>(xq, w, q16, scales,
                                                          out, M, K, N);
  else
    p4_matmul_kernel<MT, false><<<blocks, threads, 0, s>>>(
        xq, w, q16, scales, out, M, K, N);
}

}  // namespace

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (M, K) f32; xq scratch (M, K) int8; w (L, N, K/2) uint8; q16 (L, 16)
// int32; a_q (L, G) f32; a_scale (L,) f32; scales (L, N) f32; out (M, N)
// f32, all on the device. K/2 % 16 == 0 and w 16-byte aligned (the
// wrapper checks). Returns a cudaError_t.
int stacked_p4_matmul(const float* x, int8_t* xq, const uint8_t* w,
                      const int* q16, const float* a_q, const float* a_scale,
                      const float* scales, float* out, int l, int M, int K,
                      int N, int G, int affine, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_snap(x, xq, a_q, a_scale, l, M, K, G, s);
  if (err != cudaSuccess) return (int)err;
  const uint8_t* wl = w + (long)l * N * (K / 2);
  const int* ql = q16 + (long)l * 16;
  const float* sl = scales + (long)l * N;
  if (M <= 1)
    launch_matmul<1>(xq, wl, ql, sl, out, M, K, N, affine != 0, s);
  else if (M <= 2)
    launch_matmul<2>(xq, wl, ql, sl, out, M, K, N, affine != 0, s);
  else if (M <= 4)
    launch_matmul<4>(xq, wl, ql, sl, out, M, K, N, affine != 0, s);
  else
    launch_matmul<8>(xq, wl, ql, sl, out, M, K, N, affine != 0, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
