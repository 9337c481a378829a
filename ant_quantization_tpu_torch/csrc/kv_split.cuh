// The split pass and the in-order combine of causal attention of up to 16
// queries against one layer's INT8 KV cache (flash decoding), shared by
// K7 (int8_kv_attention_split.cu, a flat (B, H, S, D) layer) and by K2's
// decode regime (int8_kv_attention.cu, layer l of the stacked cache, the
// same layout once offset). Per (b, h, t), with q scaled by a multiply by
// f32(1/sqrt(D)):
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
//     KT positions staged in shared memory as int8 (K rows padded to D + 8
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
// head_dim D is a template parameter, instantiated for 64 (GPT-2, OPT-125m
// and -1.3b, BLOOM-560m), 80 (BLOOM-3b) and 128; launch() refuses any
// other. The block is 128 threads at every D: the score pass is one
// thread per (key, half of the dims) for the 64 keys of a tile, and the
// PV pass, the partial store and the combine give thread t the columns
// t, t + 128, ... below D.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// q (B, H, T, D) f32, or bf16 when q_bf16 (converted exactly); kc, vc
// (B, H, S, D); ks, vs (B, H, S); part_o (B, H, n_split, T, D); part_m,
// part_l (B, H, n_split, T). QT >= T.
template <int D, int QT>
__global__ void __launch_bounds__(NTHREADS)
split_kernel(const void* __restrict__ q, int q_bf16,
             const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
             const float* __restrict__ ks, const float* __restrict__ vs,
             const int* __restrict__ pos0, const float* __restrict__ slopes,
             float* __restrict__ part_o, float* __restrict__ part_m,
             float* __restrict__ part_l, int H, int T, int S, int span,
             float qscale) {
  static_assert(D % 16 == 0 && NTHREADS == 2 * KT, "");
  // the K tile's shared row stride in bytes. The score thread (key j,
  // half hf) reads the 4-byte words hf, hf + 2, hf + 4, ... of row j: with
  // D + 8 bytes (D / 4 + 2 words, 2 mod 4) the 32 threads of a warp (16
  // keys, both halves) hit 32 distinct banks at D = 64, 80 and 128
  constexpr int KSTR = D + 8;
  constexpr int NW = D / 8;          // 4-byte words of a half row
  constexpr int DC = (D + NTHREADS - 1) / NTHREADS;  // columns per thread
  __shared__ float q_s[QT][D];
  __shared__ __align__(16) int8_t k_s[KT * KSTR];
  __shared__ __align__(16) int8_t v_s[KT][D];
  __shared__ float kscale_s[KT];
  __shared__ float vscale_s[KT];
  __shared__ float p_s[QT][KT];
  __shared__ float m_s[QT];
  __shared__ float l_s[QT];
  __shared__ float corr_s[QT];

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

  for (int i = tid; i < QT * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    float qv = 0.0f;
    if (r < T) {
      const long off = (bh * T + r) * D + d;
      qv = q_bf16 ? __bfloat162float(
                        reinterpret_cast<const __nv_bfloat16*>(q)[off])
                  : reinterpret_cast<const float*>(q)[off];
    }
    q_s[r][d] = qv * qscale;
  }
  if (tid < QT) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  const float slope = slopes ? slopes[h] : 0.0f;  // null: no ALiBi

  float acc[QT][DC];
#pragma unroll
  for (int r = 0; r < QT; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.0f;

  for (int k0 = s_begin; k0 < s_end; k0 += KT) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < KT * (D / 16); i += NTHREADS) {
      const int j = i / (D / 16), c = i % (D / 16), pos = k0 + j;
      int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
      if (pos < s_end) {
        kv = reinterpret_cast<const int4*>(kc + (row0 + pos) * D)[c];
        vv = reinterpret_cast<const int4*>(vc + (row0 + pos) * D)[c];
      }
      int* kd = reinterpret_cast<int*>(k_s + j * KSTR + c * 16);
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      *reinterpret_cast<int4*>(&v_s[j][c * 16]) = vv;
    }
    if (tid < KT) {
      const int pos = k0 + tid;
      kscale_s[tid] = pos < s_end ? ks[row0 + pos] : 0.0f;
      vscale_s[tid] = pos < s_end ? vs[row0 + pos] : 0.0f;
    }
    __syncthreads();

    {  // scores: thread (key j, half hf) takes the words 2 c + hf
      const int j = tid >> 1, hf = tid & 1, pos = k0 + j;
      int kr[NW];
      const int* krow = reinterpret_cast<const int*>(k_s + j * KSTR);
#pragma unroll
      for (int c = 0; c < NW; ++c) kr[c] = krow[2 * c + hf];
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        const float* qrow = &q_s[r][4 * hf];
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
          const float s = dot * kscale_s[j] + slope * (float)rel;
          p_s[r][j] = (pos < s_end && rel <= 0 && r < T) ? s : -INFINITY;
        }
      }
    }
    __syncthreads();

    for (int r = warp; r < QT; r += NTHREADS / 32) {  // one warp per row
      const float s0 = p_s[r][lane], s1 = p_s[r][lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      // no visible position yet: every exp below is of -inf, i.e. 0
      const float m_use = (m_new == -INFINITY) ? 0.0f : m_new;
      const float e0 = expf(s0 - m_use), e1 = expf(s1 - m_use);
      const float sum = warp_sum(e0 + e1);
      const float c = expf(m_old - m_use);  // 0 while m_old is -inf
      p_s[r][lane] = e0 * vscale_s[lane];
      p_s[r][lane + 32] = e1 * vscale_s[lane + 32];
      __syncwarp();
      if (lane == 0) {
        l_s[r] = l_s[r] * c + sum;
        m_s[r] = m_new;
        corr_s[r] = c;
      }
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < DC; ++c) {  // PV: thread tid owns d = tid + 128 c
      const int d = tid + NTHREADS * c;
      if (d >= D) break;
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        float a = acc[r][c] * corr_s[r];
#pragma unroll 8
        for (int j = 0; j < KT; ++j) a += p_s[r][j] * (float)v_s[j][d];
        acc[r][c] = a;
      }
    }
  }

  const long part = bh * n_split + split;
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int d = tid + NTHREADS * c;
    if (d >= D) break;
#pragma unroll
    for (int r = 0; r < QT; ++r)
      if (r < T) part_o[(part * T + r) * D + d] = acc[r][c];
  }
  if (tid < T) {
    part_m[part * T + tid] = m_s[tid];
    part_l[part * T + tid] = l_s[tid];
  }
}

// One block of NTHREADS threads per (h, b): thread t combines the columns
// d = t, t + 128, ... below D of every query over the splits that pass 1
// wrote, in order.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
combine_kernel(const float* __restrict__ part_o,
               const float* __restrict__ part_m,
               const float* __restrict__ part_l, const int* __restrict__ pos0,
               void* out, int out_bf16, int H, int T, int S, int span,
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

template <int D>
cudaError_t launch_d(const void* q, int q_bf16, const int8_t* kc,
                     const int8_t* vc, const float* ks, const float* vs,
                     const int* pos0, const float* slopes, float* part_o,
                     float* part_m, float* part_l, void* out, int out_bf16,
                     int B, int H, int T, int S, int span, float qscale,
                     cudaStream_t st) {
  const int n_split = (S + span - 1) / span;
  const dim3 grid(n_split, H, B);
#define KVSPLIT_PASS1(QT)                                                    \
  split_kernel<D, QT><<<grid, NTHREADS, 0, st>>>(                            \
      q, q_bf16, kc, vc, ks, vs, pos0, slopes, part_o, part_m, part_l, H, T, \
      S, span, qscale)
  if (T == 1)
    KVSPLIT_PASS1(1);
  else if (T <= 4)
    KVSPLIT_PASS1(4);
  else
    KVSPLIT_PASS1(MAX_T);
#undef KVSPLIT_PASS1
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<D><<<dim3(H, B), NTHREADS, 0, st>>>(
      part_o, part_m, part_l, pos0, out, out_bf16, H, T, S, span, n_split);
  return cudaGetLastError();
}

// Both passes on one layer's (B, H, S, D) cache; n_split = ceil(S / span)
// splits of scratch. 1 <= T <= 16, span a multiple of KT, D 64, 80 or 128.
inline cudaError_t launch(const void* q, int q_bf16, const int8_t* kc,
                          const int8_t* vc, const float* ks, const float* vs,
                          const int* pos0, const float* slopes,
                          float* part_o, float* part_m, float* part_l,
                          void* out, int out_bf16, int B, int H, int T,
                          int S, int D, int span, float qscale,
                          cudaStream_t st) {
  if (T < 1 || T > MAX_T || span < KT || span % KT)
    return cudaErrorInvalidValue;
#define KVSPLIT_D(DD)                                                        \
  case DD:                                                                   \
    return launch_d<DD>(q, q_bf16, kc, vc, ks, vs, pos0, slopes, part_o,     \
                        part_m, part_l, out, out_bf16, B, H, T, S, span,     \
                        qscale, st)
  switch (D) {
    KVSPLIT_D(64);
    KVSPLIT_D(80);
    KVSPLIT_D(128);
    default:
      return cudaErrorInvalidValue;
  }
#undef KVSPLIT_D
}

}  // namespace kvsplit
}  // namespace
