// The split pass and the in-order combine of causal attention of up to 16
// queries against one layer's INT8 KV cache (flash decoding): K7 and K2's
// decode regime (int8_kv_attention_split.cu, on a flat (B, H, S, D) layer;
// K2's is layer l of the stacked cache). Per (b, h, t), with q scaled by a
// multiply by f32(1/sqrt(D)):
//
//   s   = (q . k_i8[pos]) * k_scale[pos] + slope * rel,  rel = pos - (pos0[b] + t)
//   s   = f32 min where rel > 0                          (causal mask)
//   p   = exp(s - max)
//   out = (sum_pos p * v_scale[pos] * v_i8[pos]) / sum_pos p,  cast to bf16 or f32
//
// What bounds it: the cache read. Every visible position costs 2 * D
// bytes of codes and two f32 scales against 4 * D flops per query, so
// bytes; one block per (b, h) would leave most of the 132 SMs idle at
// B * H = 128. Design:
//   - pass 1: block (split, h, b) takes the positions [split * span,
//     (split + 1) * span) up to pos0[b] + T - 1, the last one any query of
//     the call sees, for all T queries of head h. It walks them in tiles of
//     KT positions staged in shared memory as int8 (K rows padded to W + 8
//     bytes), with an online softmax, and writes its partial max m, sum of
//     exp l and unnormalized output o per query. A split wholly past the
//     last visible position exits at once; the masked tail of the others is
//     never read (the reference's exp(f32 min - m) is exactly 0 there).
//     Masked scores are -inf here, and a query with no visible position in
//     a split keeps m = -inf, l = 0, o = 0.
//   - pass 2: one block per (h, b) combines the splits in order 0, 1, ...:
//     out = sum_i exp(m_i - M) o_i / sum_i exp(m_i - M) l_i with M the
//     largest m_i, so the result does not depend on the order blocks ran.
// Split 0 holds position 0, which every query sees, so M is finite. The
// caller picks the span (kernels/attention.py: _span) so that B * H *
// splits fills the SMs several times. Summation orders differ from the
// plain version: the result agrees within a tolerance that the callers
// state, not bit for bit.
//
// head_dim D is any of 1 .. 256. The kernels are templates on a width W,
// instantiated for the widths of KV_WIDTHS; a head_dim D takes the
// smallest W >= D. Each width has two variants: EXACT, for D == W and
// 16-byte rows, where D is a compile-time constant (the code of a kernel
// built for that one head_dim), and one that takes D at run time for the
// global strides and masks. q and k are staged zero past D, so the extra
// products add exact zeros to the f32 scores; no column past D is
// written. The cache rows are copied in the widest chunk of 16, 8, 4 or
// 1 bytes that D and the cache's address allow (copy_chunk), walked in
// 16-byte chunks of the width so that no loop divides by D. The block
// is 128 threads at every W: the score pass is one thread per (key, half
// of the W dims) for the 64 keys of a tile, and the PV pass, the partial
// store and the combine give thread t the columns t, t + 128, ... below
// D. Shared memory is dynamic (53 KB at W = 256 and 16 queries, above
// the 48 KB of static shared memory).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The widths the attention kernels are built for (the split pass here
// and the prefill kernel of int8_kv_attention.cu): X(W) for each,
// smallest first. A head_dim D is served at the smallest W >= D;
// kernels/attention.py:KERNEL_WIDTHS lists the same widths.
#define KV_WIDTHS(X) X(16) X(32) X(64) X(80) X(96) X(128) X(256)

// Internal linkage: every library that includes this header holds its own
// copy of the kernels, and no symbol of one may resolve to another's.
namespace {
namespace kvsplit {

constexpr int KT = 64;         // key positions per tile
constexpr int NTHREADS = 128;  // two per key of a tile
constexpr int MAX_T = 16;      // queries per call, at most

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The widest copy, in bytes (16, 8, 4 or 1), that every cache row of D
// bytes at kc and vc allows: a row starts at base + pos * D.
__host__ __device__ __forceinline__ int chunk_bytes(const void* kc,
                                                    const void* vc, int D) {
  const unsigned a = (unsigned)((uintptr_t)kc | (uintptr_t)vc) | (unsigned)D;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 1;
}

// g bytes from src to dst (dst aligned to min(g, 8)), zeros when !valid
// (src is not read then)
__device__ __forceinline__ void copy_piece(int8_t* dst, const int8_t* src,
                                           int g, bool valid) {
  switch (g) {
    case 16: {
      const int4 v = valid ? *reinterpret_cast<const int4*>(src)
                           : make_int4(0, 0, 0, 0);
      int2* d = reinterpret_cast<int2*>(dst);
      d[0] = make_int2(v.x, v.y);
      d[1] = make_int2(v.z, v.w);
      break;
    }
    case 8:
      *reinterpret_cast<int2*>(dst) =
          valid ? *reinterpret_cast<const int2*>(src) : make_int2(0, 0);
      break;
    case 4:
      *reinterpret_cast<int*>(dst) =
          valid ? *reinterpret_cast<const int*>(src) : 0;
      break;
    default:
      *dst = valid ? *src : (int8_t)0;
  }
}

// The 16-byte chunk of a cache row that starts at column c0 < D: 16
// bytes, or the D - c0 left of the row, in copies of g bytes (g divides
// D and 16, so it divides what is left)
__device__ __forceinline__ void copy_chunk(int8_t* dst, const int8_t* src,
                                           int c0, int D, int g,
                                           bool valid) {
  if (g == 16) {
    copy_piece(dst, src, 16, valid);
  } else {
    const int n = min(16, D - c0);
    for (int b = 0; b < n; b += g) copy_piece(dst + b, src + b, g, valid);
  }
}

// Pass 1's shared memory at width W and QT queries.
template <int W, int QT>
struct SplitSmem {
  // the K tile's row stride in bytes. The score thread (key j, half hf)
  // reads the 4-byte words hf, hf + 2, hf + 4, ... of row j: with W + 8
  // bytes (W / 4 + 2 words, 2 mod 4 at every W of KV_WIDTHS) the 32
  // threads of a warp (16 keys, both halves) hit 32 distinct banks
  static constexpr int KSTR = W + 8;
  float q[QT][W];
  float p[QT][KT];
  float kscale[KT];
  float vscale[KT];
  float m[QT];
  float l[QT];
  float corr[QT];
  alignas(16) int8_t k[KT * KSTR];
  alignas(16) int8_t v[KT][W];
};

// q (B, H, T, D) f32, or bf16 when q_bf16 (converted exactly); kc, vc
// (B, H, S, D); ks, vs (B, H, S); part_o (B, H, n_split, T, D); part_m,
// part_l (B, H, n_split, T). QT >= T, W >= D. EXACT: D == W and 16-byte
// rows (the head_dim is the width: D a compile-time constant, the code of
// a kernel built for that head_dim alone); else any D <= W.
template <int W, int QT, bool EXACT>
__global__ void __launch_bounds__(NTHREADS)
split_kernel(const void* __restrict__ q, int q_bf16,
             const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
             const float* __restrict__ ks, const float* __restrict__ vs,
             const int* __restrict__ pos0, const float* __restrict__ slopes,
             float* __restrict__ part_o, float* __restrict__ part_m,
             float* __restrict__ part_l, int H, int T, int S, int d_arg,
             int span, float qscale) {
  static_assert(W % 16 == 0 && NTHREADS == 2 * KT, "");
  const int D = EXACT ? W : d_arg;
  using Sm = SplitSmem<W, QT>;
  constexpr int KSTR = Sm::KSTR;
  constexpr int NW = W / 8;          // 4-byte words of a half row
  constexpr int DC = (W + NTHREADS - 1) / NTHREADS;  // columns per thread
  extern __shared__ __align__(16) uint8_t split_smem[];
  Sm& sm = *reinterpret_cast<Sm*>(split_smem);

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long bh = (long)b * H + h;
  const long row0 = bh * S;  // first position of (b, h)
  const int p0 = pos0[b];
  const int kmax = min(p0 + T - 1, S - 1);  // last position any query sees
  const int s_begin = split * span;
  if (s_begin > kmax) return;  // the combine never reads this split
  const int s_end = min(s_begin + span, kmax + 1);

  for (int i = tid; i < QT * W; i += NTHREADS) {
    const int r = i / W, d = i % W;
    float qv = 0.0f;
    if (r < T && d < D) {
      const long off = (bh * T + r) * D + d;
      qv = q_bf16 ? __bfloat162float(
                        reinterpret_cast<const __nv_bfloat16*>(q)[off])
                  : reinterpret_cast<const float*>(q)[off];
    }
    sm.q[r][d] = qv * qscale;
  }
  // the tiles' columns D .. W - 1 stay zero: no tile load writes them
  if constexpr (!EXACT) {
    for (int i = tid; i < KT * (W - D); i += NTHREADS) {
      const int j = i / (W - D), d = D + i % (W - D);
      sm.k[j * KSTR + d] = 0;
      sm.v[j][d] = 0;
    }
  }
  if (tid < QT) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.0f;
  }
  const float slope = slopes ? slopes[h] : 0.0f;  // null: no ALiBi
  const int g = EXACT ? 16 : chunk_bytes(kc, vc, D);  // bytes per copy

  float acc[QT][DC];
#pragma unroll
  for (int r = 0; r < QT; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.0f;

  for (int k0 = s_begin; k0 < s_end; k0 += KT) {
    __syncthreads();  // the previous tile's readers are done
    // the tile's rows in 16-byte chunks, W / 16 a row (a compile-time
    // count); the chunks at and past D stay zero
    for (int i = tid; i < KT * (W / 16); i += NTHREADS) {
      const int j = i / (W / 16), c0 = 16 * (i % (W / 16)), pos = k0 + j;
      if (c0 >= D) continue;
      const bool ok = pos < s_end;
      const long off = (row0 + pos) * D + c0;
      copy_chunk(sm.k + j * KSTR + c0, kc + off, c0, D, g, ok);
      copy_chunk(&sm.v[j][c0], vc + off, c0, D, g, ok);
    }
    if (tid < KT) {
      const int pos = k0 + tid;
      sm.kscale[tid] = pos < s_end ? ks[row0 + pos] : 0.0f;
      sm.vscale[tid] = pos < s_end ? vs[row0 + pos] : 0.0f;
    }
    __syncthreads();

    {  // scores: thread (key j, half hf) takes the words 2 c + hf
      const int j = tid >> 1, hf = tid & 1, pos = k0 + j;
      int kr[NW];
      const int* krow = reinterpret_cast<const int*>(sm.k + j * KSTR);
#pragma unroll
      for (int c = 0; c < NW; ++c) kr[c] = krow[2 * c + hf];
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        const float* qrow = &sm.q[r][4 * hf];
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < NW; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e)  // little-endian bytes of the word
            dot += qrow[8 * c + e] * (float)(int8_t)(kr[c] >> (8 * e));
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        if (hf == 0) {
          const int rel = pos - (p0 + r);
          const float s = dot * sm.kscale[j] + slope * (float)rel;
          sm.p[r][j] = (pos < s_end && rel <= 0 && r < T) ? s : -INFINITY;
        }
      }
    }
    __syncthreads();

    for (int r = warp; r < QT; r += NTHREADS / 32) {  // one warp per row
      const float s0 = sm.p[r][lane], s1 = sm.p[r][lane + 32];
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      // no visible position yet: every exp below is of -inf, i.e. 0
      const float m_use = (m_new == -INFINITY) ? 0.0f : m_new;
      const float e0 = expf(s0 - m_use), e1 = expf(s1 - m_use);
      const float sum = warp_sum(e0 + e1);
      const float c = expf(m_old - m_use);  // 0 while m_old is -inf
      sm.p[r][lane] = e0 * sm.vscale[lane];
      sm.p[r][lane + 32] = e1 * sm.vscale[lane + 32];
      __syncwarp();
      if (lane == 0) {
        sm.l[r] = sm.l[r] * c + sum;
        sm.m[r] = m_new;
        sm.corr[r] = c;
      }
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < DC; ++c) {  // PV: thread tid owns d = tid + 128 c
      const int d = tid + NTHREADS * c;
      if (d >= D) continue;  // (not break: keeps the loop unrolled)
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        float a = acc[r][c] * sm.corr[r];
#pragma unroll 8
        for (int j = 0; j < KT; ++j) a += sm.p[r][j] * (float)sm.v[j][d];
        acc[r][c] = a;
      }
    }
  }

  const long part = bh * n_split + split;
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int d = tid + NTHREADS * c;
    if (d >= D) continue;
#pragma unroll
    for (int r = 0; r < QT; ++r)
      if (r < T) part_o[(part * T + r) * D + d] = acc[r][c];
  }
  if (tid < T) {
    part_m[part * T + tid] = sm.m[tid];
    part_l[part * T + tid] = sm.l[tid];
  }
}

// One block of NTHREADS threads per (h, b): thread t combines the columns
// d = t, t + 128, ... below D of every query over the splits that pass 1
// wrote, in order.
__global__ void __launch_bounds__(NTHREADS)
combine_kernel(const float* __restrict__ part_o,
               const float* __restrict__ part_m,
               const float* __restrict__ part_l, const int* __restrict__ pos0,
               void* out, int out_bf16, int H, int T, int S, int D, int span,
               int n_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long bh = (long)b * H + h;
  const int kmax = min(pos0[b] + T - 1, S - 1);
  const int n_rel = min(kmax / span + 1, n_split);
  for (int d = threadIdx.x; d < D; d += NTHREADS) {
    for (int t = 0; t < T; ++t) {
      float M = -INFINITY;
      for (int i = 0; i < n_rel; ++i)
        M = fmaxf(M, part_m[(bh * n_split + i) * T + t]);
      float num = 0.0f, den = 0.0f;
      for (int i = 0; i < n_rel; ++i) {
        const long part = bh * n_split + i;
        const float w = expf(part_m[part * T + t] - M);  // 0 where m_i = -inf
        num += w * part_o[(part * T + t) * D + d];
        den += w * part_l[part * T + t];
      }
      const float o = num / den;
      const long off = (bh * T + t) * D + d;
      if (out_bf16)
        reinterpret_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16(o);
      else
        reinterpret_cast<float*>(out)[off] = o;
    }
  }
}

template <int W, int QT, bool EXACT>
cudaError_t launch_pass1(dim3 grid, const void* q, int q_bf16,
                         const int8_t* kc, const int8_t* vc, const float* ks,
                         const float* vs, const int* pos0,
                         const float* slopes, float* part_o, float* part_m,
                         float* part_l, int H, int T, int S, int D, int span,
                         float qscale, cudaStream_t st) {
  constexpr int smem = (int)sizeof(SplitSmem<W, QT>);
  static bool attr_set = false;  // one per instantiation
  if (smem > 48 * 1024 && !attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel<W, QT, EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  split_kernel<W, QT, EXACT><<<grid, NTHREADS, smem, st>>>(
      q, q_bf16, kc, vc, ks, vs, pos0, slopes, part_o, part_m, part_l, H, T,
      S, D, span, qscale);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_w(const void* q, int q_bf16, const int8_t* kc,
                     const int8_t* vc, const float* ks, const float* vs,
                     const int* pos0, const float* slopes, float* part_o,
                     float* part_m, float* part_l, void* out, int out_bf16,
                     int B, int H, int T, int S, int D, int span,
                     float qscale, cudaStream_t st) {
  const int n_split = (S + span - 1) / span;
  const dim3 grid(n_split, H, B);
  const bool exact = D == W && chunk_bytes(kc, vc, D) == 16;
#define KVSPLIT_PASS1_E(QT, E)                                               \
  launch_pass1<W, QT, E>(grid, q, q_bf16, kc, vc, ks, vs, pos0, slopes,      \
                         part_o, part_m, part_l, H, T, S, D, span, qscale, st)
  // the general variant (a head_dim below its width) at 1 and 16 queries
  // only: it serves head_dims no model of the port's families has
  const cudaError_t err =
      exact ? (T == 1   ? KVSPLIT_PASS1_E(1, true)
               : T <= 4 ? KVSPLIT_PASS1_E(4, true)
                        : KVSPLIT_PASS1_E(MAX_T, true))
            : (T == 1 ? KVSPLIT_PASS1_E(1, false)
                      : KVSPLIT_PASS1_E(MAX_T, false));
#undef KVSPLIT_PASS1_E
  if (err != cudaSuccess) return err;
  combine_kernel<<<dim3(H, B), NTHREADS, 0, st>>>(
      part_o, part_m, part_l, pos0, out, out_bf16, H, T, S, D, span, n_split);
  return cudaGetLastError();
}

}  // namespace kvsplit
}  // namespace
