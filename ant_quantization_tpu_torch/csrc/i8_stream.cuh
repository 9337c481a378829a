// The decode-size snap + int8 product of K1 (stacked_i8.cu) and of K9 at
// M <= 64 (w8a8_matmul.cu), for one layer of an N-major (L, N, K) int8
// weight stack:
//
//   out[m, n] = f32(sum_k int8(snap(x[m, k] / a_scale[l]; a_q[l])) W[l, n, k])
//               * scales[l, n]
//
// (K9, `recip`: x[m, k] * (1 / a_scale), its reference's order), bit for
// bit like the plain versions: an IEEE f32 division (no --use_fast_math),
// `>=` against the f32 midpoints (aq[i] + aq[i+1]) * 0.5 with ties to the
// larger entry, an exact int32 sum, one f32 multiply.
//
// What bounds it: at decode (M = 4) the weight stream, K N bytes against
// 2 M K N int8 operations. Design, a staged split-K weight stream in one
// launch (no snap pre-kernel, no int8 scratch in device memory):
//   - a block owns CN = 128 output columns, one K range (a split) and MT
//     rows of x. Thread 0 first starts a ring of STAGES 16 KB weight
//     stages (128 bytes of K by 128 columns, one 128-byte-swizzled TMA
//     box on the stack's cached 3-D map), so the weight stream never
//     waits on the snap;
//   - the snap runs a stage ahead of the product, into two alternating
//     shared buffers of MT x 128 codes: each stage's x is loaded 16 bytes
//     at a time one stage earlier still, and compared with thresholds on
//     x itself (the least f32 x whose quotient by a_scale reaches each
//     midpoint, found once per block by the same division, which is
//     monotone in x for a_scale > 0), so no element is divided. Every
//     column reads the codes from shared memory, a broadcast;
//   - each thread owns one column and four of the eight 16-byte chunks
//     of each stage (__dp4a, MT int32 sums); the column's two halves meet
//     in shared memory;
//   - K is split until the grid holds one wave of about two blocks per
//     SM (kernels/stacked.py:k1_plan). The partial sums are int32 and
//     exact, so their order is free: each split stores its own in a
//     workspace, and the last split of a tile (a counter, left zero for
//     the next call) adds them and does the one f32 multiply. Without a
//     split the block writes directly.
// Needs K % 16 == 0 and 16-byte aligned x and weight stack.
#pragma once

#include "i8_wgmma.cuh"

namespace {
namespace st {

constexpr int THREADS = 256;
constexpr int CN = 128;                  // output columns per block
constexpr int BK = 128;                  // K bytes per stage
constexpr int STAGE_BYTES = CN * BK;     // one TMA box
constexpr int STAGES = 4;                // stages in flight
constexpr int TPC = THREADS / CN;        // threads per column
constexpr int MAX_G = 16;                // codebook entries

__device__ __forceinline__ int dot16(const int4& a, const int4& b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  acc = __dp4a(a.w, b.w, acc);
  return acc;
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
    i8_stream_kernel(const __grid_constant__ CUtensorMap tm_w,
                     const float* __restrict__ x,
                     const float* __restrict__ aq,
                     const float* __restrict__ a_scale,
                     const float* __restrict__ scales,
                     float* __restrict__ out, int* __restrict__ ws,
                     unsigned* __restrict__ count, int M, int K, int N, int G,
                     int layer, int steps, int splits, bool recip) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring =
      (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = (uint64_t*)(ring + STAGES * STAGE_BYTES);
  float* smid = (float*)(full + STAGES);   // G - 1 midpoints or thresholds
  float* sval = smid + MAX_G;              // the G entries
  int* red = (int*)(sval + MAX_G);         // (TPC - 1, MT, CN)
  int8_t* xs = (int8_t*)(red + (TPC - 1) * MT * CN);  // 2 x (MT, BK)
  __shared__ bool last;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * CN;
  const int split = blockIdx.z;
  const int s0 = (int)((long)split * steps / splits);
  const int ns = (int)((long)(split + 1) * steps / splits) - s0;
  const int kb = s0 * BK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) wg::mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < STAGES && j < ns; ++j) {
      wg::mbar_expect_tx(&full[j], STAGE_BYTES);
      wg::tma_load_3d(ring + j * STAGE_BYTES, &tm_w, &full[j], kb + j * BK,
                      n0, layer);
    }
  }
  // stage 0's x, loaded while the thresholds are found
  constexpr int ROW4 = BK / 4, X4 = MT * ROW4;   // float4 of one stage
  constexpr int XR = (X4 + THREADS - 1) / THREADS;
  float4 xr[XR];
  auto load_x = [&](int j) {
#pragma unroll
    for (int u = 0; u < XR; ++u) {
      const int i = tid + u * THREADS;
      const int r = i / ROW4, k = kb + j * BK + 4 * (i % ROW4);
      xr[u] = (i < X4 && m0 + r < M && k < K)
                  ? __ldg(reinterpret_cast<const float4*>(
                        x + (long)(m0 + r) * K + k))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load_x(0);

  // the snap's midpoints as thresholds on x itself: thr[g] is the least
  // f32 x with f32(x / a_scale) >= mid[g] (x * inv for K9). Division (and
  // the product) is monotone in x for a_scale > 0, so x >= thr[g] decides
  // exactly what the division would, without one per element.
  const float* aql = aq + (long)layer * G;
  const float sc = a_scale[layer];
  const float inv = 1.0f / sc;
  const bool by_thr = sc > 0.f && inv < __int_as_float(0x7f800000);
  if (tid < G) {
    sval[tid] = aql[tid];
    if (tid < G - 1) {
      const float m = (aql[tid] + aql[tid + 1]) * 0.5f;
      smid[tid] = m;
      if (by_thr) {
        const float ninf = __int_as_float(0xff800000);
        const float pinf = __int_as_float(0x7f800000);
        float t = recip ? m / inv : m * sc;
        if ((recip ? t * inv : t / sc) >= m) {
          for (float p = nextafterf(t, ninf);
               (recip ? p * inv : p / sc) >= m; p = nextafterf(p, ninf))
            t = p;
        } else {
          do t = nextafterf(t, pinf);
          while (!((recip ? t * inv : t / sc) >= m));
        }
        smid[tid] = t;
      }
    }
  }
  __syncthreads();

  // x for the stages, snapped into two alternating shared buffers of
  // MT x BK codes: stage j + 1's while stage j is multiplied, its 16-byte
  // loads issued one stage earlier still (in registers)
  float mid[MAX_G - 1];
#pragma unroll
  for (int g = 0; g < MAX_G - 1; ++g)
    mid[g] = g < G - 1 ? smid[g] : __int_as_float(0x7f800000);  // +inf
  auto snap_x = [&](int j) {
    int8_t* dst = xs + (j & 1) * MT * BK;
#pragma unroll
    for (int u = 0; u < XR; ++u) {
      const int i = tid + u * THREADS;
      if (i >= X4) break;
      const float e[4] = {xr[u].x, xr[u].y, xr[u].z, xr[u].w};
      uint32_t word = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float t = by_thr ? e[q] : (recip ? e[q] * inv : e[q] / sc);
        int idx = 0;
#pragma unroll
        for (int g = 0; g < MAX_G - 1; ++g) idx += (t >= mid[g]) ? 1 : 0;
        idx = min(idx, G - 1);  // +inf passes the +inf padding too
        word |= ((uint32_t)__float2int_rn(sval[idx]) & 0xFFu) << (8 * q);
      }
      // rows past M and K past its end load zeros, whose code is not 0
      const int r = i / ROW4, k = kb + j * BK + 4 * (i % ROW4);
      *reinterpret_cast<uint32_t*>(dst + 4 * i) =
          (m0 + r < M && k < K) ? word : 0u;
    }
  };
  snap_x(0);
  if (ns > 1) load_x(1);
  __syncthreads();

  // thread: column c, chunks h + 2 q (q < 4) of every stage's eight; a
  // warp shares h, so its x reads are broadcasts, and eight neighbouring
  // columns of one chunk fall in eight different 16-byte bank groups (the
  // swizzle)
  const int c = tid % CN, h = tid / CN;
  int acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0;
  for (int j = 0; j < ns; ++j) {
    if (j + 1 < ns) snap_x(j + 1);
    if (j + 2 < ns) load_x(j + 2);
    const int slot = j % STAGES;
    wg::mbar_wait(&full[slot], (j / STAGES) & 1);
    const uint8_t* wrow = ring + slot * STAGE_BYTES + c * BK;
    const int8_t* xj = xs + (j & 1) * MT * BK;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ch = h + TPC * q;
      const int4 wv =
          *reinterpret_cast<const int4*>(wrow + ((ch ^ (c & 7)) << 4));
#pragma unroll
      for (int r = 0; r < MT; ++r)
        acc[r] = dot16(
            *reinterpret_cast<const int4*>(xj + r * BK + 16 * ch), wv,
            acc[r]);
    }
    __syncthreads();  // every thread is done with this slot and buffer
    if (tid == 0 && j + STAGES < ns) {
      wg::mbar_expect_tx(&full[slot], STAGE_BYTES);
      wg::tma_load_3d(ring + slot * STAGE_BYTES, &tm_w, &full[slot],
                      kb + (j + STAGES) * BK, n0, layer);
    }
  }
  if (h > 0) {
#pragma unroll
    for (int r = 0; r < MT; ++r) red[((h - 1) * MT + r) * CN + c] = acc[r];
  }
  __syncthreads();
  const int n = n0 + c;
  const bool own = h == 0 && n < N;        // the column's finishing thread
  if (own) {
#pragma unroll
    for (int r = 0; r < MT; ++r)
      for (int g = 0; g < TPC - 1; ++g) acc[r] += red[(g * MT + r) * CN + c];
  }
  const float* sl = scales + (long)layer * N;
  if (splits == 1) {
    if (own) {
#pragma unroll
      for (int r = 0; r < MT; ++r)
        if (m0 + r < M)
          out[(long)(m0 + r) * N + n] =
              __fmul_rn(__int2float_rn(acc[r]), sl[n]);
    }
    return;
  }
  // split K: each split stores its exact int32 partials in its own slice
  // of the workspace (splits, M, N); the last split of this tile (a
  // counter, reset for the next call) adds them and does the one multiply
  const long MN = (long)M * N;
  if (own) {
#pragma unroll
    for (int r = 0; r < MT; ++r)
      if (m0 + r < M) ws[split * MN + (long)(m0 + r) * N + n] = acc[r];
    __threadfence();
  }
  __syncthreads();
  const unsigned tile = blockIdx.x * gridDim.y + blockIdx.y;
  if (tid == 0) {
    last = atomicAdd(&count[tile], 1u) == (unsigned)(splits - 1);
    if (last) count[tile] = 0u;
  }
  __syncthreads();
  if (!last || !own) return;
  __threadfence();
#pragma unroll
  for (int r = 0; r < MT; ++r)
    if (m0 + r < M) {
      int v = 0;
      for (int p = 0; p < splits; ++p)
        v += __ldcg(&ws[p * MN + (long)(m0 + r) * N + n]);
      out[(long)(m0 + r) * N + n] = __fmul_rn(__int2float_rn(v), sl[n]);
    }
}

// Shared memory of one block for MT rows.
inline int smem_bytes(int mt) {
  return 1024 + STAGES * STAGE_BYTES + STAGES * 8 + 2 * MAX_G * 4 +
         (TPC - 1) * mt * CN * 4 + 2 * mt * BK;
}

template <int MT>
cudaError_t launch_mt(const CUtensorMap* tm, const float* x, const float* aq,
                      const float* a_scale, const float* scales, float* out,
                      int* ws, unsigned* count, int M, int K, int N, int G,
                      int layer, int steps, int splits, bool recip,
                      cudaStream_t s) {
  const int smem = smem_bytes(MT);
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        i8_stream_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err == cudaSuccess)  // all of L1 as shared memory: two blocks fit
      err = cudaFuncSetAttribute(i8_stream_kernel<MT>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 100);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const dim3 grid((M + MT - 1) / MT, (N + CN - 1) / CN, splits);
  i8_stream_kernel<MT><<<grid, THREADS, smem, s>>>(
      *tm, x, aq, a_scale, scales, out, ws, count, M, K, N, G, layer, steps,
      splits, recip);
  return cudaGetLastError();
}

// x (M, K) f32; w (L, N, K) int8, the whole stack; a_q (L, G) f32 sorted;
// a_scale (L,) f32; scales (L, N) f32; out (M, N) f32. mt (1, 2, 4, 8 or
// 16 rows per block) and splits come from the wrapper's plan
// (kernels/stacked.py:k1_plan); with splits > 1, ws holds splits * M * N
// int32 and count one zero per (M tile, N tile), which the kernel leaves
// zero. K % 16 == 0, 16-byte aligned x and stack.
inline cudaError_t launch_i8_stream(const float* x, const int8_t* w, int L,
                                    int layer, const float* a_q,
                                    const float* a_scale, const float* scales,
                                    float* out, int* ws, unsigned* count,
                                    int M, int K, int N, int G, int mt,
                                    int splits, bool recip, cudaStream_t s) {
  const int steps = (K + BK - 1) / BK;
  if (K % 16 || ((uintptr_t)w | (uintptr_t)x) % 16 || G < 1 || G > MAX_G ||
      splits < 1 || splits > steps ||
      (splits > 1 && (ws == nullptr || count == nullptr)))
    return cudaErrorInvalidValue;
  const CUtensorMap* tm = wg::stack_map(w, L, N, K, CN);
  if (tm == nullptr) return cudaErrorInvalidValue;
#define K1_MT_CASE(T)                                                     \
  case T:                                                                 \
    return launch_mt<T>(tm, x, a_q, a_scale, scales, out, ws, count, M, K, \
                        N, G, layer, steps, splits, recip, s);
  switch (mt) {
    K1_MT_CASE(1)
    K1_MT_CASE(2)
    K1_MT_CASE(4)
    K1_MT_CASE(8)
    K1_MT_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef K1_MT_CASE
}

}  // namespace st
}  // namespace
