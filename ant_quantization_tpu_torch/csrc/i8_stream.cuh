// The decode-size snap + int8 product of K1 (stacked_i8.cu), of K9 at
// M <= 64 (w8a8_matmul.cu) and of K6 (stacked_p4.cu), for one layer of an
// N-major weight stack:
//
//   out[m, n] = f32(sum_k int8(snap(x[m, k] / a_scale[l]; a_q[l])) W[l, n, k])
//               * scales[l, n]
//
// (K9, `recip`: x[m, k] * (1 / a_scale), its reference's order), bit for
// bit like the plain versions: an IEEE f32 division (no --use_fast_math),
// `>=` against the f32 midpoints (aq[i] + aq[i+1]) * 0.5 with ties to the
// larger entry, an exact int32 sum, one f32 multiply. The weight's decode
// is a policy of the stream (WDec): K1 and K9 read (L, N, K) int8 values;
// K6 reads (L, N, K/2) uint8 split-K nibble pairs, byte i of column n
// holding code(i, n) low and code(i + K/2, n) high, each decoded in
// registers to `code - 8` (W4_AFFINE) or q16[l][code] (W4_TABLE). A K6
// stage of 128 packed bytes pairs with two x ranges, [k0, k0 + 128) and
// [K/2 + k0, K/2 + k0 + 128), whose codes the snap writes side by side.
//
// What bounds it: at decode (M = 4) the weight stream, K N bytes (K6:
// K N / 2) against 2 M K N int8 operations. Design, a staged split-K
// weight stream in one launch (no snap pre-kernel, no int8 scratch in
// device memory):
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
//   - K1, K9: each thread owns one column and four of the eight 16-byte
//     chunks of each stage (__dp4a, MT int32 sums); the column's two
//     halves meet in shared memory. K6: its nibble decode already takes
//     the integer issue slots, so its dots run on int8 mma.sync m16n8k32
//     as K3's do (ovp_stream.cuh): warp w's 16 columns as A, read from the
//     stage by ldmatrix and decoded in registers into the A of each x
//     range, the code rows as B; the sums meet per column in shared
//     memory;
//   - K is split until the grid holds one wave of about two blocks per
//     SM (kernels/stacked.py:k1_plan). The partial sums are int32 and
//     exact, so their order is free: each split stores its own in a
//     workspace, and the last split of a tile (a counter, left zero for
//     the next call) adds them and does the one f32 multiply. Without a
//     split the block writes directly.
// Needs K % 16 == 0 (K6: K/2 % 16 == 0) and 16-byte aligned x and weight
// stack.
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

// the weight's decode: int8 values (K1, K9), or packed nibble pairs (K6)
enum WDec { W_I8 = 0, W4_AFFINE = 1, W4_TABLE = 2 };

// x ranges that one stage pairs with: one, or K6's two halves of K
template <int WD>
__host__ __device__ constexpr int ranges() {
  return WD == W_I8 ? 1 : 2;
}

__device__ __forceinline__ int dot16(const int4& a, const int4& b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  acc = __dp4a(a.w, b.w, acc);
  return acc;
}

// K6's x code buffers: rows of XROW bytes, so that the mma's B loads of
// eight rows fall in distinct banks, each x range a whole number of the
// mma's eight-row tiles
constexpr int XROW = BK + 16;

// One of the two alternating shared buffers of x codes: K1 and K9 keep MT
// rows of BK bytes (read 16 bytes at a time, as broadcasts); K6 its two x
// ranges of `rows` rows of XROW bytes each (the mma's B operand).
template <int WD, int MT>
struct Codes {
  static constexpr int rows = WD == W_I8 ? MT : (MT + 7) / 8 * 8;
  static constexpr int pitch = WD == W_I8 ? BK : XROW;
  static constexpr int bytes = ranges<WD>() * rows * pitch;
};

// K6: 4 packed bytes (one ldmatrix register; byte i holds codes lo_i |
// hi_i << 4) -> the int8 values of their low nibbles (lo) and of their
// high nibbles (hi). Affine: code - 8 per byte as (code + 0x78) ^ 0x80,
// which never carries. Table: one nibble unzip (a delta swap, then a byte
// permutation) gives the selector s whose low half holds lo_0..lo_3 and
// whose high half hi_0..hi_3; each half looks its codes up in the 16-byte
// table t with two __byte_perm (entries 0-7 and 8-15, by the codes' low
// three bits), and a byte mask of the codes' bit 3, made by an integer
// multiply, picks between them.
template <int WD>
__device__ __forceinline__ void decode_word(uint32_t w, const uint32_t (&t)[4],
                                            uint32_t& lo, uint32_t& hi) {
  if constexpr (WD == W4_AFFINE) {
    lo = ((w & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
    hi = (((w >> 4) & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
  } else {
    const uint32_t d = (w ^ (w >> 4)) & 0x00F000F0u;
    const uint32_t s7 = __byte_perm(w ^ d ^ (d << 4), 0u, 0x3120u) &
                        0x77777777u;
    const uint32_t ml = ((w >> 3) & 0x01010101u) * 0xFFu;
    const uint32_t mh = ((w >> 7) & 0x01010101u) * 0xFFu;
    lo = (__byte_perm(t[2], t[3], s7) & ml) |
         (__byte_perm(t[0], t[1], s7) & ~ml);
    hi = (__byte_perm(t[2], t[3], s7 >> 16) & mh) |
         (__byte_perm(t[0], t[1], s7 >> 16) & ~mh);
  }
}

// KW: the weight's K bytes per column (K, or K6's K/2); the stages walk
// them, and range h of a stage reads x at h * KW + the stage's offset
template <int MT, int WD>
__global__ void __launch_bounds__(THREADS)
    i8_stream_kernel(const __grid_constant__ CUtensorMap tm_w,
                     const float* __restrict__ x,
                     const float* __restrict__ aq,
                     const float* __restrict__ a_scale,
                     const float* __restrict__ scales,
                     const int* __restrict__ q16,
                     float* __restrict__ out, int* __restrict__ ws,
                     unsigned* __restrict__ count, int M, int K, int KW,
                     int N, int G, int layer, int steps, int splits,
                     bool recip) {
  constexpr int XH = ranges<WD>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring =
      (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = (uint64_t*)(ring + STAGES * STAGE_BYTES);
  float* smid = (float*)(full + STAGES);   // G - 1 midpoints or thresholds
  float* sval = smid + MAX_G;              // the G entries
  int* red = (int*)(sval + MAX_G);         // (MT, CN) int32 sums
  int8_t* xs = (int8_t*)(red + MT * CN);   // 2 x Codes<WD, MT>::bytes
  using CB = Codes<WD, MT>;
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
  // stage 0's x, loaded while the thresholds are found: float4 i of a
  // stage is x row m0 + r of range h (at h KW + the stage's offset), with
  // i / ROW4 = h MT + r
  constexpr int ROW4 = BK / 4, X4 = XH * MT * ROW4;   // float4 of one stage
  constexpr int XR = (X4 + THREADS - 1) / THREADS;
  float4 xr[XR];
  auto load_x = [&](int j) {
#pragma unroll
    for (int u = 0; u < XR; ++u) {
      const int i = tid + u * THREADS;
      const int rr = i / ROW4, r = rr % MT, k = kb + j * BK + 4 * (i % ROW4);
      xr[u] = (i < X4 && m0 + r < M && k < KW)
                  ? __ldg(reinterpret_cast<const float4*>(
                        x + (long)(m0 + r) * K + (rr / MT) * KW + k))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load_x(0);

  // K6's table of the layer's 16 int8 values, as bytes in registers
  uint32_t tab[4] = {0u, 0u, 0u, 0u};
  if constexpr (WD == W4_TABLE) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      tab[i >> 2] |= ((uint32_t)q16[(long)layer * 16 + i] & 0xFFu)
                     << (8 * (i & 3));
  }

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
  // codes (Codes<WD, MT>): stage j + 1's while stage j is multiplied, its
  // 16-byte loads issued one stage earlier still (in registers)
  float mid[MAX_G - 1];
#pragma unroll
  for (int g = 0; g < MAX_G - 1; ++g)
    mid[g] = g < G - 1 ? smid[g] : __int_as_float(0x7f800000);  // +inf

  auto snap_x = [&](int j) {
    int8_t* dst = xs + (j & 1) * CB::bytes;
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
      // (K6: the weight past K/2, zero bytes, decodes to no zero either)
      const int rr = i / ROW4, r = rr % MT, k = kb + j * BK + 4 * (i % ROW4);
      *reinterpret_cast<uint32_t*>(
          dst + ((rr / MT) * CB::rows + r) * CB::pitch + 4 * (i % ROW4)) =
          (m0 + r < M && k < KW) ? word : 0u;
    }
  };
  snap_x(0);
  if (ns > 1) load_x(1);
  __syncthreads();

  // K1, K9: thread column c, chunks h + 2 q (q < 4) of every stage's
  // eight; a warp shares h, so its x reads are broadcasts, and eight
  // neighbouring columns of one chunk fall in eight different 16-byte bank
  // groups (the swizzle). K6: warp w takes columns 16 w .. 16 w + 15 as
  // mma.sync m16n8k32's A, read by ldmatrix x4 from rows a_row and bytes
  // 16 a_hi of each 32-byte k step, the stage's swizzle undone on 16-byte
  // chunks, and decoded in registers into the A of the first x range (low
  // nibbles) and of the second (high ones); B's column n = 8 b + g is code
  // row n of each range, bytes 4 t and 4 t + 16 of the step; the dots' c0,
  // c1 are A row g with B columns 2 t, 2 t + 1, c2, c3 row g + 8.
  const int c = tid % CN, h = tid / CN;
  const int lane = tid & 31, warp = tid >> 5;
  const int a_row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_hi = lane >> 4;
  constexpr int NB = (MT + 7) / 8;        // K6: B's n8 tiles per range
  int acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0;
  int dots[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) dots[b][e] = 0;
  for (int j = 0; j < ns; ++j) {
    if (j + 1 < ns) snap_x(j + 1);
    if (j + 2 < ns) load_x(j + 2);
    const int slot = j % STAGES;
    wg::mbar_wait(&full[slot], (j / STAGES) & 1);
    const int8_t* xj = xs + (j & 1) * CB::bytes;
    if constexpr (WD == W_I8) {
      const uint8_t* wrow = ring + slot * STAGE_BYTES + c * BK;
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
    } else {
      const uint8_t* wrow = ring + slot * STAGE_BYTES + a_row * BK;
      const int8_t* xc = xj + (lane >> 2) * XROW + 4 * (lane & 3);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        uint32_t a[4], lo[4], hi[4];
        wg::ldmatrix_x4(a, wrow + (((2 * kk + a_hi) ^ (a_row & 7)) << 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) decode_word<WD>(a[i], tab, lo[i], hi[i]);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int8_t* xl = xc + b * 8 * XROW + 32 * kk;
          const int8_t* xh = xl + CB::rows * XROW;
          wg::mma_s8(dots[b], lo, *reinterpret_cast<const uint32_t*>(xl),
                     *reinterpret_cast<const uint32_t*>(xl + 16));
          wg::mma_s8(dots[b], hi, *reinterpret_cast<const uint32_t*>(xh),
                     *reinterpret_cast<const uint32_t*>(xh + 16));
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
  // each column's MT sums meet in one thread: K1's other half-column, or
  // K6's dots, whose x rows lie across the warp
  if constexpr (WD == W_I8) {
    if (h > 0) {
#pragma unroll
      for (int r = 0; r < MT; ++r) red[r * CN + c] = acc[r];
    }
  } else {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * b + 2 * (lane & 3) + (e & 1);
        if (r < MT)
          red[r * CN + 16 * warp + (lane >> 2) + 8 * (e >> 1)] = dots[b][e];
      }
  }
  __syncthreads();
  const int n = n0 + c;
  const bool own = h == 0 && n < N;        // the column's finishing thread
  if (own) {
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[r] += red[r * CN + c];
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

// Shared memory of one block for MT rows (kernels/stacked.py: k1_plan,
// k6_plan).
template <int MT, int WD>
constexpr int smem_bytes() {
  return 1024 + STAGES * STAGE_BYTES + STAGES * 8 + 2 * MAX_G * 4 +
         MT * CN * 4 + 2 * Codes<WD, MT>::bytes;
}

template <int MT, int WD>
cudaError_t launch_mt(const CUtensorMap* tm, const float* x, const float* aq,
                      const float* a_scale, const float* scales,
                      const int* q16, float* out, int* ws, unsigned* count,
                      int M, int K, int KW, int N, int G, int layer,
                      int steps, int splits, bool recip, cudaStream_t s) {
  const int smem = smem_bytes<MT, WD>();
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        i8_stream_kernel<MT, WD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err == cudaSuccess)  // all of L1 as shared memory: two blocks fit
      err = cudaFuncSetAttribute(i8_stream_kernel<MT, WD>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 100);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const dim3 grid((M + MT - 1) / MT, (N + CN - 1) / CN, splits);
  i8_stream_kernel<MT, WD><<<grid, THREADS, smem, s>>>(
      *tm, x, aq, a_scale, scales, q16, out, ws, count, M, K, KW, N, G,
      layer, steps, splits, recip);
  return cudaGetLastError();
}

// One launch of the stream with weight decode WD over a stack of KW
// bytes per column (the map's K).
template <int WD>
cudaError_t launch_stream(const float* x, const void* w, int L, int layer,
                          const float* a_q, const float* a_scale,
                          const float* scales, const int* q16, float* out,
                          int* ws, unsigned* count, int M, int K, int KW,
                          int N, int G, int mt, int splits, bool recip,
                          cudaStream_t s) {
  const int steps = (KW + BK - 1) / BK;
  if (KW % 16 || ((uintptr_t)w | (uintptr_t)x) % 16 || G < 1 || G > MAX_G ||
      splits < 1 || splits > steps ||
      (splits > 1 && (ws == nullptr || count == nullptr)) ||
      (WD == W4_TABLE && q16 == nullptr))
    return cudaErrorInvalidValue;
  const CUtensorMap* tm =
      wg::stack_map((const int8_t*)w, L, N, KW, CN);
  if (tm == nullptr) return cudaErrorInvalidValue;
#define STREAM_MT_CASE(T)                                                    \
  case T:                                                                    \
    return launch_mt<T, WD>(tm, x, a_q, a_scale, scales, q16, out, ws,      \
                            count, M, K, KW, N, G, layer, steps, splits,    \
                            recip, s);
  switch (mt) {
    STREAM_MT_CASE(1)
    STREAM_MT_CASE(2)
    STREAM_MT_CASE(4)
    STREAM_MT_CASE(8)
    STREAM_MT_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef STREAM_MT_CASE
}

// K1 and K9: x (M, K) f32; w (L, N, K) int8, the whole stack; a_q (L, G)
// f32 sorted; a_scale (L,) f32; scales (L, N) f32; out (M, N) f32. mt (1,
// 2, 4, 8 or 16 rows per block) and splits come from the wrapper's plan
// (kernels/stacked.py:k1_plan); with splits > 1, ws holds splits * M * N
// int32 and count one zero per (M tile, N tile), which the kernel leaves
// zero. K % 16 == 0, 16-byte aligned x and stack.
inline cudaError_t launch_i8_stream(const float* x, const int8_t* w, int L,
                                    int layer, const float* a_q,
                                    const float* a_scale, const float* scales,
                                    float* out, int* ws, unsigned* count,
                                    int M, int K, int N, int G, int mt,
                                    int splits, bool recip, cudaStream_t s) {
  return launch_stream<W_I8>(x, w, L, layer, a_q, a_scale, scales, nullptr,
                             out, ws, count, M, K, K, N, G, mt, splits, recip,
                             s);
}

// K6: as launch_i8_stream on a (L, N, K/2) uint8 stack of split-K nibble
// pairs, decoded as code - 8 (affine) or through q16 (L, 16) int32, the
// layer's int8 values; mt and splits from kernels/stacked.py:k6_plan.
// K/2 % 16 == 0.
inline cudaError_t launch_p4_stream(const float* x, const uint8_t* w, int L,
                                    int layer, const int* q16,
                                    const float* a_q, const float* a_scale,
                                    const float* scales, float* out, int* ws,
                                    unsigned* count, int M, int K, int N,
                                    int G, bool affine, int mt, int splits,
                                    cudaStream_t s) {
  if (K % 2) return cudaErrorInvalidValue;
  return affine ? launch_stream<W4_AFFINE>(x, w, L, layer, a_q, a_scale,
                                           scales, q16, out, ws, count, M, K,
                                           K / 2, N, G, mt, splits, false, s)
                : launch_stream<W4_TABLE>(x, w, L, layer, a_q, a_scale,
                                          scales, q16, out, ws, count, M, K,
                                          K / 2, N, G, mt, splits, false, s);
}

}  // namespace st
}  // namespace
