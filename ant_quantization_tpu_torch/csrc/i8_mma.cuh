// The OVP mode of K5's prefill-size int8 product (stacked_prefill.cu) on
// the int8 tensor cores, mma.sync m16n8k32: xq (M, K) int8 snapped codes
// against an N-major (N, K) layer of sign-offset OVP bytes, K3's dual dot
// and its f32 order (see stacked_prefill.cu, which describes the design).
// The int8-value product runs on wgmma instead (i8_wgmma.cuh); this one
// stays on mma.sync because its second dot needs clip(c) of the B tile,
// which wgmma can only read from shared memory. K % 64 == 0, 16-byte
// aligned buffers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;         // K bytes per pipeline step
constexpr int LDS = BK + 16;   // padded shared row, bytes
constexpr int THREADS = 256;   // 8 warps

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ovp_clip4(uint32_t w) {
  // clip(c, -64, 64) on each signed byte
  return (uint32_t)__vmaxs4(__vmins4((int)w, 0x40404040), 0xC0C0C0C0);
}

// xq (M, K) int8, w (N, K) OVP bytes (layer l's slice), scales (N,) f32,
// out (M, N) f32. A segment is seg_tiles K steps, a block `fold` segments.
template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(THREADS)
    prefill_ovp_kernel(const int8_t* __restrict__ xq,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scales,
                      float* __restrict__ out, int M, int K, int N,
                      int seg_tiles, int fold) {
  constexpr int WARPS_N = BN / WN;
  static_assert((BM / WM) * WARPS_N == THREADS / 32, "8 warps");
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
  __shared__ __align__(128) int8_t As[2][BM][LDS];
  __shared__ __align__(128) int8_t Bs[2][BN][LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    for (int c = tid; c < BM * 4; c += THREADS) {
      const int r = c >> 2, q = c & 3, gm = m0 + r;
      const bool ok = gm < M;
      cp_async16(&As[stage][r][q * 16],
                 xq + (long)(ok ? gm : 0) * K + k0 + q * 16, ok);
    }
    for (int c = tid; c < BN * 4; c += THREADS) {
      const int r = c >> 2, q = c & 3, gn = n0 + r;
      const bool ok = gn < N;
      cp_async16(&Bs[stage][r][q * 16],
                 w + (long)(ok ? gn : 0) * K + k0 + q * 16, ok);
    }
  };

  int acc[MT][NT][4], acc2[MT][NT][4];   // the dots against c, clip(c)
  float part[MT][NT][4], facc[MT][NT][4];  // segment and block f32 sums
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        acc2[i][j][e] = 0;
        part[i][j][e] = 0.f;
        facc[i][j][e] = 0.f;
      }

  // ldmatrix row addresses: A x4 = rows (lane & 7) + 8 ((lane >> 3) & 1),
  // bytes 16 (lane >> 4); B x4 over two n8 tiles = rows (lane & 7) +
  // 8 (lane >> 4), bytes 16 ((lane >> 3) & 1)
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 16 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 16 * ((lane >> 3) & 1);

  const int nk = K / BK;
  int segs = 0;  // segments finished
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_tile((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], &As[st][wm * WM + i * 16 + a_row][ks * 32 + a_col]);
      uint32_t b[NT][2];
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4(r, &Bs[st][wn * WN + p * 16 + b_row][ks * 32 + b_col]);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
          mma_s8(acc2[i][j], a[i], ovp_clip4(b[j][0]), ovp_clip4(b[j][1]));
        }
    }
    __syncthreads();  // the next step's loads overwrite this stage
    if ((kt + 1) % seg_tiles == 0) {
      ++segs;
      const bool block_end = segs % fold == 0;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = 16 * acc[i][j][e] - 15 * acc2[i][j][e];
            part[i][j][e] = __fadd_rn(part[i][j][e], __int2float_rn(p));
            acc[i][j][e] = 0;
            acc2[i][j][e] = 0;
            if (block_end) {
              facc[i][j][e] = __fadd_rn(facc[i][j][e], part[i][j][e]);
              part[i][j][e] = 0.f;
            }
          }
    }
  }

  // c0, c1: row g, columns 2 t, 2 t + 1; c2, c3: row g + 8
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * WM + i * 16 + g + 8 * (e >> 1);
        const int n = n0 + wn * WN + j * 8 + 2 * t4 + (e & 1);
        if (m < M && n < N)
          out[(long)m * N + n] = __fmul_rn(facc[i][j][e], scales[n]);
      }
}

void launch_i8_mma_ovp(const int8_t* xq, const int8_t* w,
                       const float* scales, float* out, int M, int K, int N,
                       int seg_tiles, int fold, cudaStream_t s) {
  constexpr int BM = 128, BN = 64;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  prefill_ovp_kernel<BM, BN, 32, 32><<<grid, THREADS, 0, s>>>(
      xq, w, scales, out, M, K, N, seg_tiles, fold);
}

}  // namespace
