// The decode-size OVP products K3 (stacked_i8.cu) and K4 (stacked_aovp.cu)
// on K1's staged split-K weight stream (i8_stream.cuh), for one layer of
// an N-major (L, N, K) stack of int8 weight bytes w, pw = clip(w, +-64):
//
//   K3: x codes xq = snap(x / a_scale[l]; a_q[l]) (K1's snap); per segment
//       of `seg` rows the exact int32 16 xq@w - 15 xq@pw;
//   K4: x / prescale[l] snapped onto the 32-entry grid || outlier concat
//       (31 midpoints with tie flags, the reference's select chain: the
//       last true `xs > mid[i] or (xs == mid[i] and tie[i])` wins) straight
//       to its sign-offset byte c, the OVP victims of each K-pair (2k,
//       2k+1) zeroed (|c| > 64 marks an outlier), cx = c, px = clip(c,
//       +-64); per segment the exact int32 dots d1 = cx@w, d2 = cx@pw,
//       d3 = px@w, d4 = px@pw (int8-value weights: d1, d3), and the f32
//       part ((256 d1 - 240 d2) - 240 d3) + 225 d4 (16 d1 - 15 d3);
//
// then the segments' f32 values summed in order within each block of
// `fold` segments (K4: fold 1), the blocks in order, and one f32 multiply
// by scales[l, n]: bit for bit like the plain versions
// (kernels/stacked.py). Past 2^24 those f32 steps round, so they run in
// the reference's order, in one thread per output, written with __fadd_rn
// / __fmul_rn / __fsub_rn (nvcc never contracts them into an FMA); the
// int32 dots are exact, and their order is free.
//
// What bounds it: at decode (M = 4) the weight stream, K N bytes, against
// 2 (K3) or 4 (K4) int8 dots of 2 M K N operations. On __dp4a those dots,
// with the encode, kept the SMs' issue slots busier than the stream
// (PERF.md section 6), so they run on the int8 tensor cores. Design, one
// launch per call (no encode pre-kernel, no (M, K) scratch in device
// memory):
//   - K1's stream: a block owns CN = 128 output columns, one K range (a
//     split) and MT rows of x; thread 0 keeps a ring of STAGES 16 KB TMA
//     stages (128 bytes of K by 128 columns, 128-byte swizzle) on the
//     stack's cached 3-D map; K is split until the grid holds one wave of
//     about two blocks per SM (kernels/stacked.py:k34_plan);
//   - the snap or encode runs a stage ahead of the product into two
//     alternating shared buffers of x codes (K4: MT rows of cx, then MT
//     of px), every thread taking K-pairs whose x it loaded a stage
//     earlier still. It compares x itself with per-block thresholds:
//     thr[i] is the least f32 x whose quotient by the scale satisfies
//     midpoint i's predicate, found once by the same IEEE division
//     (monotone in x for a scale > 0), so `x >= thr[i]` decides each step
//     exactly as the division would. When the thresholds are
//     non-decreasing the steps that hold form a prefix, and the chain's
//     last true step is their count minus one: K3 counts its 15 in
//     registers as K1 does, K4 finds its 31 by a binary search in shared
//     memory; otherwise (a repeated midpoint whose tie flags differ) the
//     block runs the chain itself. K4's victims are decided in registers:
//     a thread holds whole pairs;
//   - the product: warp w takes columns 16 w .. 16 w + 15 of every stage,
//     mma.sync m16n8k32 s8 with the weight stage as A (ldmatrix from the
//     swizzled stage, clamped in registers for pw) and the code rows as
//     B's eight (or sixteen) columns, so one mma gives one weight form's
//     dots with every row and plane;
//   - a segment's int32 dots are whole in the warp's registers at its end
//     (a split is whole f32 blocks: K is split only between them, into at
//     most as many splits as blocks), so its f32 value is formed there and
//     added into its block's sum in order; a block's sum goes into the
//     chain (without a split) or the workspace, and the tile's last split
//     (a counter at the head of K1's workspace, left zero for the next
//     call) chains the blocks' sums in order, in one thread per output.
// Needs K % 16 == 0, seg a multiple of 128 or all of K, K % (seg fold) ==
// 0, and 16-byte aligned x and weight stack.
#pragma once

#include "i8_stream.cuh"

namespace {
namespace ovs {

using st::BK;
using st::CN;
using st::STAGE_BYTES;
using st::STAGES;
using st::THREADS;

constexpr int MAX_T = 32;      // table entries: K4's 32-entry concat
constexpr int XROW = BK + 16;  // a code row in shared memory: B's loads
                               // of eight rows fall in distinct banks

enum Mode { K3 = 0, K4_OVP = 1, K4_I8 = 2 };

template <int MODE, int MT>
struct Shape {
  static constexpr bool pw = MODE != K4_I8;               // dots on pw
  static constexpr int planes = MODE == K3 ? 1 : 2;       // xq; cx, px
  static constexpr int log_t = MODE == K3 ? 4 : 5;        // search depth
  static constexpr int nb = (planes * MT + 7) / 8;        // B's n8 tiles
  static constexpr int xbuf = nb * 8 * XROW;              // one buffer
};

using wg::clip64;
using wg::ldmatrix_x4;
using wg::mma_s8;

// The least f32 t with pred(t / sc), pred(v) = v >= m (ge) or v > m, for
// a finite sc > 0: start from m's image and step one ulp at a time. NaN
// when no t satisfies it (x >= NaN never holds, as pred never does).
__device__ float least_x(float m, float sc, bool ge) {
  const float ninf = __int_as_float(0xff800000);
  const float pinf = __int_as_float(0x7f800000);
  const float nan = __int_as_float(0x7fffffff);
  if (m != m) return nan;
  auto pred = [&](float t) {
    const float v = t / sc;
    return ge ? v >= m : v > m;
  };
  float t = m * sc;
  if (pred(t)) {
    for (float p = nextafterf(t, ninf); t > ninf && pred(p);
         p = nextafterf(p, ninf))
      t = p;
  } else {
    do {
      if (t == pinf) return nan;
      t = nextafterf(t, pinf);
    } while (!pred(t));
  }
  return t;
}

// One segment's f32 value from its int32 values
template <int MODE>
__device__ __forceinline__ float seg_value(const int* v) {
  if constexpr (MODE == K3) {
    return __int2float_rn(v[0]);
  } else if constexpr (MODE == K4_I8) {
    return __fsub_rn(__fmul_rn(16.f, __int2float_rn(v[0])),
                     __fmul_rn(15.f, __int2float_rn(v[1])));
  } else {
    float p = __fsub_rn(__fmul_rn(256.f, __int2float_rn(v[0])),
                        __fmul_rn(240.f, __int2float_rn(v[1])));
    p = __fsub_rn(p, __fmul_rn(240.f, __int2float_rn(v[2])));
    return __fadd_rn(p, __fmul_rn(225.f, __int2float_rn(v[3])));
  }
}

template <int MT, int MODE>
__global__ void __launch_bounds__(THREADS)
    ovp_stream_kernel(const __grid_constant__ CUtensorMap tm_w,
                      const float* __restrict__ x,
                      const float* __restrict__ x_scale,
                      const float* __restrict__ mids,
                      const int* __restrict__ ties,
                      const float* __restrict__ vals,
                      const float* __restrict__ scales,
                      float* __restrict__ out, float* __restrict__ ws,
                      unsigned* __restrict__ count, int M, int K, int N,
                      int G, int layer, int steps, int splits, int ss,
                      int fold) {
  using S = Shape<MODE, MT>;
  constexpr int PL = S::planes, NB = S::nb;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring =
      (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = (uint64_t*)(ring + STAGES * STAGE_BYTES);
  float* sthr = (float*)(full + STAGES);  // thresholds, or the midpoints
  int* stie = (int*)(sthr + MAX_T);
  int* sval = stie + MAX_T;               // the code of each entry
  int8_t* xs = (int8_t*)(sval + MAX_T);   // 2 x (8 NB rows of XROW)
  __shared__ bool last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * CN;
  const int split = blockIdx.z;
  // split s: f32 blocks [s U / splits, (s + 1) U / splits) of fold
  // segments of ss stages each
  const int us = ss * fold, U = steps / us;
  const int u0 = (int)((long)split * U / splits);
  const int s0 = u0 * us;
  const int ns = (int)((long)(split + 1) * U / splits) * us - s0;
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
  // stage 0's x, loaded while the thresholds are found: K-pairs, as many
  // to a thread as there are pairs in a stage over the threads
  constexpr int ROW2 = BK / 2, X2 = MT * ROW2;  // pairs of one stage
  constexpr int XR = (X2 + THREADS - 1) / THREADS;
  float2 xr[XR];
  auto load_x = [&](int j) {
#pragma unroll
    for (int u = 0; u < XR; ++u) {
      const int i = tid + u * THREADS;
      const int r = i / ROW2, k = kb + j * BK + 2 * (i % ROW2);
      xr[u] = (i < X2 && m0 + r < M && k < K)
                  ? __ldg(reinterpret_cast<const float2*>(
                        x + (long)(m0 + r) * K + k))
                  : make_float2(0.f, 0.f);
    }
  };
  load_x(0);
  // the code buffers start zero: B's rows past the MT (K4: 2 MT) that the
  // encode writes stay zero
  for (int i = tid; i < 2 * S::xbuf / 16; i += THREADS)
    reinterpret_cast<int4*>(xs)[i] = make_int4(0, 0, 0, 0);

  // the tables: K3's midpoints (aq[i] + aq[i+1]) * 0.5 with ties to the
  // larger entry, K4's given midpoints and tie flags; as thresholds on x
  // when the scale is finite and positive, else kept for the division
  constexpr int SLOTS = (1 << S::log_t) - 1;
  const float* vl = vals + (long)layer * G;
  const float sc = x_scale[layer];
  const bool by_thr = sc > 0.f && sc < __int_as_float(0x7f800000);
  if (tid < SLOTS) {
    float t = __int_as_float(0x7f800000);  // padding: +inf
    int ge = 1;
    if (tid < G - 1) {
      const float m = mids != nullptr ? mids[(long)layer * (G - 1) + tid]
                                      : (vl[tid] + vl[tid + 1]) * 0.5f;
      ge = ties != nullptr ? (ties[(long)layer * (G - 1) + tid] > 0) : 1;
      t = by_thr ? least_x(m, sc, ge) : m;
    }
    sthr[tid] = t;
    stie[tid] = ge;
  }
  if (tid < G) sval[tid] = __float2int_rn(vl[tid]);
  __syncthreads();
  // non-decreasing thresholds: the count (or binary search) gives the
  // chain's answer
  const bool fast = __syncthreads_and(
                        tid >= G - 2 || sthr[tid] <= sthr[tid + 1]) &&
                    by_thr;
  // K3's 15 thresholds stay in registers and are counted, as K1 does; K4's
  // 31 are searched in shared memory
  float thr[MODE == K3 ? SLOTS : 1];
#pragma unroll
  for (int i = 0; i < (MODE == K3 ? SLOTS : 1); ++i) thr[i] = sthr[i];
  auto code = [&](float e) {
    int idx = 0;
    if (fast) {
      if constexpr (MODE == K3) {
#pragma unroll
        for (int i = 0; i < SLOTS; ++i) idx += e >= thr[i] ? 1 : 0;
      } else {
#pragma unroll
        for (int step = 1 << (S::log_t - 1); step > 0; step >>= 1)
          if (e >= sthr[idx + step - 1]) idx += step;
      }
      idx = min(idx, G - 1);  // +inf passes the +inf padding too
    } else {
      const float v = by_thr ? e : e / sc;
      for (int g = 0; g < G - 1; ++g) {
        const float t = sthr[g];
        if (by_thr ? v >= t : (v > t || (v == t && stie[g]))) idx = g + 1;
      }
    }
    return sval[idx];
  };
  auto encode_x = [&](int j) {
    int8_t* dst = xs + (j & 1) * S::xbuf;
#pragma unroll
    for (int u = 0; u < XR; ++u) {
      const int i = tid + u * THREADS;
      if (i >= X2) break;
      int c0 = code(xr[u].x), c1 = code(xr[u].y);
      if constexpr (MODE != K3) {
        // the OVP victim of the pair: an outlier at the even slot zeroes
        // the odd one, else one at the odd slot the even one
        if (abs(c0) > 64)
          c1 = 0;
        else if (abs(c1) > 64)
          c0 = 0;
      }
      // rows past M and K past its end load zeros, whose code is not 0
      const int r = i / ROW2, k = kb + j * BK + 2 * (i % ROW2);
      const bool in = m0 + r < M && k < K;
      const int off = r * XROW + 2 * (i % ROW2);
      *reinterpret_cast<uint16_t*>(dst + off) =
          in ? (uint16_t)((c0 & 0xFF) | (c1 & 0xFF) << 8) : 0;
      if constexpr (PL == 2) {
        const int p0 = max(-64, min(64, c0)), p1 = max(-64, min(64, c1));
        *reinterpret_cast<uint16_t*>(dst + MT * XROW + off) =
            in ? (uint16_t)((p0 & 0xFF) | (p1 & 0xFF) << 8) : 0;
      }
    }
  };
  encode_x(0);
  if (ns > 1) load_x(1);
  __syncthreads();

  // warp w: columns 16 w .. 16 w + 15 (A's rows), read by ldmatrix x4 from
  // rows a_row and bytes 16 a_hi of each 32-byte K step, the stage's
  // 128-byte swizzle undone on 16-byte chunks; B's column n = 8 b + g is
  // code row n (K4: cx of row n, then px of row n - MT), bytes 4 t and
  // 4 t + 16 of the step; the dots' c0, c1 are A row g with B columns
  // 2 t, 2 t + 1, c2, c3 row g + 8
  const int g = lane >> 2, t4 = lane & 3;
  const int a_row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_hi = lane >> 4;
  int cw[NB][4], cp[NB][4];  // the dots with w and with pw
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) cw[b][e] = cp[b][e] = 0;
  // the outputs this thread finishes: B columns 2 t + (e & 1) of tile 0
  // that are code rows of x (plane 0), at columns g + 8 (e >> 1)
  float blk[4] = {0.f, 0.f, 0.f, 0.f}, acc[4] = {0.f, 0.f, 0.f, 0.f};
  const long MN = (long)M * N;
  const int col0 = n0 + 16 * warp + g;
  for (int j = 0; j < ns; ++j) {
    if (j + 1 < ns) encode_x(j + 1);
    if (j + 2 < ns) load_x(j + 2);
    const int slot = j % STAGES;
    wg::mbar_wait(&full[slot], (j / STAGES) & 1);
    const uint8_t* wrow = ring + slot * STAGE_BYTES + a_row * BK;
    const int8_t* xc = xs + (j & 1) * S::xbuf + g * XROW + 4 * t4;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, wrow + (((2 * kk + a_hi) ^ (a_row & 7)) << 4));
      uint32_t p[4];
      if constexpr (S::pw) {
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = clip64(a[i]);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int8_t* xb = xc + b * 8 * XROW + 32 * kk;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xb + 16);
        mma_s8(cw[b], a, b0, b1);
        if constexpr (S::pw) mma_s8(cp[b], p, b0, b1);
      }
    }
    if ((j + 1) % ss == 0) {
      // a segment ends: its int32 dots are whole in this warp's registers
      // (K4's px row n - MT in tile 1, or MT / 2 lanes up, or the odd
      // register at MT = 1); its f32 value goes into the block's sum
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int d[4] = {cw[0][e], cp[0][e], 0, 0};  // d1, d2 of the cx row
        if constexpr (PL == 2) {
          if constexpr (MT == 8) {
            d[2] = cw[1][e];
            d[3] = cp[1][e];
          } else if constexpr (MT == 1) {
            d[2] = cw[0][e | 1];
            d[3] = cp[0][e | 1];
          } else {
            d[2] = __shfl_down_sync(0xffffffffu, cw[0][e], MT / 2);
            d[3] = __shfl_down_sync(0xffffffffu, cp[0][e], MT / 2);
          }
        }
        if constexpr (MODE == K3) d[0] = 16 * d[0] - 15 * d[1];
        if constexpr (MODE == K4_I8) d[1] = d[2];  // d1, d3
        v[e] = seg_value<MODE>(d);                 // K4: d1, d2, d3, d4
      }
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) cw[b][e] = cp[b][e] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) blk[e] = __fadd_rn(blk[e], v[e]);
      if ((j + 1) % us == 0) {
        // a block ends: into the chain, or the workspace for the last split
        const int u = u0 + (j + 1) / us - 1;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 2 * t4 + (e & 1), col = col0 + 8 * (e >> 1);
          if (splits == 1)
            acc[e] = __fadd_rn(acc[e], blk[e]);
          else if (r < MT && m0 + r < M && col < N)
            ws[(long)u * MN + (long)(m0 + r) * N + col] = blk[e];
          blk[e] = 0.f;
        }
      }
    }
    __syncthreads();  // every thread is done with this slot and buffer
    if (tid == 0 && j + STAGES < ns) {
      wg::mbar_expect_tx(&full[slot], STAGE_BYTES);
      wg::tma_load_3d(ring + slot * STAGE_BYTES, &tm_w, &full[slot],
                      kb + (j + STAGES) * BK, n0, layer);
    }
  }
  const float* sl = scales + (long)layer * N;
  if (splits == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 2 * t4 + (e & 1), col = col0 + 8 * (e >> 1);
      if (r < MT && m0 + r < M && col < N)
        out[(long)(m0 + r) * N + col] = __fmul_rn(acc[e], sl[col]);
    }
    return;
  }
  // the tile's last split (a counter, reset for the next call) runs the
  // chain over every block's f32 sum in order, its loads issued B blocks
  // at a time so that their latencies overlap
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned tile = blockIdx.x * gridDim.y + blockIdx.y;
    last = atomicAdd(&count[tile], 1u) == (unsigned)(splits - 1);
    if (last) count[tile] = 0u;
  }
  __syncthreads();
  const int n = n0 + tid % CN;
  if (!last || n >= N) return;
  __threadfence();
  constexpr int B = 16;
  for (int r = tid / CN; r < MT && m0 + r < M; r += THREADS / CN) {
    const float* src = ws + (long)(m0 + r) * N + n;
    float f = 0.f;
    for (int b0 = 0; b0 < U; b0 += B) {
      float v[B];
#pragma unroll
      for (int i = 0; i < B; ++i)
        v[i] = b0 + i < U ? __ldcg(src + (long)(b0 + i) * MN) : 0.f;
#pragma unroll
      for (int i = 0; i < B; ++i)
        if (b0 + i < U) f = __fadd_rn(f, v[i]);
    }
    out[(long)(m0 + r) * N + n] = __fmul_rn(f, sl[n]);
  }
}

// Shared memory of one block for MT rows.
template <int MODE, int MT>
inline int smem_bytes() {
  return 1024 + STAGES * STAGE_BYTES + STAGES * 8 + 3 * MAX_T * 4 +
         2 * Shape<MODE, MT>::xbuf;
}

template <int MT, int MODE>
cudaError_t launch_mt(const CUtensorMap* tm, const float* x,
                      const float* x_scale, const float* mids,
                      const int* ties, const float* vals,
                      const float* scales, float* out, float* ws,
                      unsigned* count, int M, int K, int N, int G, int layer,
                      int steps, int splits, int ss, int fold,
                      cudaStream_t s) {
  const int smem = smem_bytes<MODE, MT>();
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        ovp_stream_kernel<MT, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)  // all of L1 as shared memory: two blocks fit
      err = cudaFuncSetAttribute(ovp_stream_kernel<MT, MODE>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 100);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const dim3 grid((M + MT - 1) / MT, (N + CN - 1) / CN, splits);
  ovp_stream_kernel<MT, MODE><<<grid, THREADS, smem, s>>>(
      *tm, x, x_scale, mids, ties, vals, scales, out, ws, count, M, K, N,
      G, layer, steps, splits, ss, fold);
  return cudaGetLastError();
}

// x (M, K) f32; w (L, N, K) int8, the whole stack; x_scale (L,) f32 (K3's
// a_scale, K4's prescale); K3: mids and ties null, vals = a_q (L, G)
// sorted; K4: mids and ties (L, G - 1) f32 / int32, vals = enc (L, G);
// scales (L, N) f32; out (M, N) f32. seg rows per segment, fold segments
// per f32 block (K4: 1); mt (1, 2, 4 or 8 rows per block) and splits (at
// most the number of f32 blocks) come from the wrapper's plan
// (kernels/stacked.py:k34_plan); with splits > 1, ws holds K / (seg fold)
// * M * N f32 and count one zero per (M tile, N tile), which the kernel
// leaves zero.
template <int MODE>
cudaError_t launch_ovp_stream(const float* x, const int8_t* w, int L,
                              int layer, const float* x_scale,
                              const float* mids, const int* ties,
                              const float* vals, const float* scales,
                              float* out, float* ws, unsigned* count, int M,
                              int K, int N, int G, int seg, int fold, int mt,
                              int splits, cudaStream_t s) {
  const int steps = (K + BK - 1) / BK;
  const int ss = (seg + BK - 1) / BK;  // stages per segment
  if (K % 16 || ((uintptr_t)w | (uintptr_t)x) % 16 || G < 1 ||
      G > (1 << Shape<MODE, 1>::log_t) || seg < 16 || K % (seg * fold) ||
      (seg % BK && seg != K) || fold < 1 || splits < 1 ||
      splits > steps / (ss * fold) ||
      (splits > 1 && (ws == nullptr || count == nullptr)))
    return cudaErrorInvalidValue;
  const CUtensorMap* tm = wg::stack_map(w, L, N, K, CN);
  if (tm == nullptr) return cudaErrorInvalidValue;
#define K34_MT_CASE(T)                                                     \
  case T:                                                                  \
    return launch_mt<T, MODE>(tm, x, x_scale, mids, ties, vals, scales,   \
                              out, ws, count, M, K, N, G, layer, steps,   \
                              splits, ss, fold, s);
  switch (mt) {
    K34_MT_CASE(1)
    K34_MT_CASE(2)
    K34_MT_CASE(4)
    K34_MT_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef K34_MT_CASE
}

}  // namespace ovs
}  // namespace
