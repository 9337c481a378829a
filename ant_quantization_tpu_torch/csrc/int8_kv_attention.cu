// K2: causal attention of q against layer l of the stacked INT8 KV cache,
// hand-written for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel
// ant_quantization_tpu/kernels/attention.py:stacked_int8_kv_attention
// (_stacked_kernel). Per (b, h, t), with q scaled by a multiply by
// f32(1/sqrt(D)):
//
//   s   = (q . k_i8[pos]) * k_scale[pos] + slope * rel,  rel = pos - (pos0[b] + t)
//   s   = f32 min where rel > 0                          (causal mask)
//   p   = exp(s - max)
//   out = (sum_pos p * v_scale[pos] * v_i8[pos]) / sum_pos p,  cast to bf16 or f32
//
// The softmax is online (flash style) over key tiles of KT positions,
// walked from position 0 upward: the first tile always holds position 0,
// which no query masks, so the running max is finite from the first tile
// on and masked scores underflow to p = 0 exactly as in the reference.
// Tiles wholly past the block's last causal position are skipped. The
// division by sum p comes after the PV product, as in the reference.
// Summation orders differ from the plain version, so the result agrees
// within a tolerance (stated by the callers), not bit for bit.
//
// What bounds it: at decode (T = 1) the int8 cache read, 2*D bytes plus
// two f32 scales per visible position, against 4*D flops per position, so
// bytes; at prefill (T = 512) the f32 flops on the CUDA cores. Design:
// one block of D = 128 threads per (query tile of QT, head, batch); the
// K and V tiles are staged in shared memory as int8 (the K rows padded to
// 132 bytes so the score reads are free of bank conflicts). Scores: thread
// (key j, half p) dots its 64-dim half of key j with each query of the
// tile; one shuffle joins the halves. Softmax statistics: one warp per
// query row. PV: thread d owns output column d for all QT queries, in
// registers. One launch serves any T through the grid over query tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;      // head_dim (the wrapper checks)
constexpr int KT = 64;      // key positions per tile
constexpr int KSTR = 132;   // padded shared row stride of the K tile, bytes
constexpr int NTHREADS = D;
constexpr float NEG_BIG = -3.4028234663852886e+38f;  // f32 min

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

template <int QT>
__global__ void __launch_bounds__(NTHREADS)
int8_kv_attention_kernel(const float* __restrict__ q,
                         const int8_t* __restrict__ kc,
                         const int8_t* __restrict__ vc,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ pos0,
                         const float* __restrict__ slopes, void* out,
                         int out_bf16, int B, int H, int T, int S,
                         float qscale) {
  __shared__ float q_s[QT][D];
  __shared__ __align__(16) int8_t k_s[KT * KSTR];
  __shared__ __align__(16) int8_t v_s[KT][D];
  __shared__ float kscale_s[KT];
  __shared__ float vscale_s[KT];
  __shared__ float p_s[QT][KT];
  __shared__ float m_s[QT];
  __shared__ float l_s[QT];
  __shared__ float corr_s[QT];

  const int t0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long bh = (long)b * H + h;
  const long row0 = bh * S;  // first position of (b, h) in the layer

  for (int i = tid; i < QT * D; i += NTHREADS) {
    const int r = i / D, d = i % D, t = t0 + r;
    q_s[r][d] = (t < T) ? q[(bh * T + t) * D + d] * qscale : 0.0f;
  }
  if (tid < QT) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  const int p0 = pos0[b];
  const float slope = slopes[h];
  const int t_last = min(t0 + QT, T) - 1;
  const int kmax = min(p0 + t_last, S - 1);  // last position any query sees

  float acc[QT];
#pragma unroll
  for (int r = 0; r < QT; ++r) acc[r] = 0.0f;

  for (int k0 = 0; k0 <= kmax; k0 += KT) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < KT * (D / 16); i += NTHREADS) {
      const int j = i / (D / 16), c = i % (D / 16), pos = k0 + j;
      int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
      if (pos < S) {
        kv = reinterpret_cast<const int4*>(kc + (row0 + pos) * D)[c];
        vv = reinterpret_cast<const int4*>(vc + (row0 + pos) * D)[c];
      }
      int* kd = reinterpret_cast<int*>(k_s + j * KSTR + c * 16);
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      *reinterpret_cast<int4*>(&v_s[j][c * 16]) = vv;
    }
    if (tid < KT) {
      const int pos = k0 + tid;
      kscale_s[tid] = pos < S ? ks[row0 + pos] : 0.0f;
      vscale_s[tid] = pos < S ? vs[row0 + pos] : 0.0f;
    }
    __syncthreads();

    {  // scores: thread (key j, half hf)
      const int j = tid >> 1, hf = tid & 1, pos = k0 + j;
      int kr[16];
      const int* krow = reinterpret_cast<const int*>(k_s + j * KSTR + hf * 64);
#pragma unroll
      for (int c = 0; c < 16; ++c) kr[c] = krow[c];
      for (int r = 0; r < QT; ++r) {
        const float* qrow = &q_s[r][hf * 64];
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e)  // little-endian bytes of the word
            dot += qrow[4 * c + e] * (float)(int8_t)(kr[c] >> (8 * e));
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        if (hf == 0) {
          const int rel = pos - (p0 + t0 + r);
          const float s = dot * kscale_s[j] + slope * (float)rel;
          p_s[r][j] = (pos < S && rel <= 0) ? s : NEG_BIG;
        }
      }
    }
    __syncthreads();

    for (int r = warp; r < QT; r += NTHREADS / 32) {  // one warp per row
      const float s0 = p_s[r][lane], s1 = p_s[r][lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);
      const float sum = warp_sum(e0 + e1);
      const float c = expf(m_old - m_new);  // 0 on the first tile
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
    for (int r = 0; r < QT; ++r) {  // PV: thread tid owns column d = tid
      float a = acc[r] * corr_s[r];
#pragma unroll 8
      for (int j = 0; j < KT; ++j) a += p_s[r][j] * (float)v_s[j][tid];
      acc[r] = a;
    }
  }

#pragma unroll
  for (int r = 0; r < QT; ++r) {
    const int t = t0 + r;
    if (t < T) {
      const float o = acc[r] / l_s[r];
      const long off = (bh * T + t) * D + tid;
      if (out_bf16)
        reinterpret_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16(o);
      else
        reinterpret_cast<float*>(out)[off] = o;
    }
  }
}

}  // namespace

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q (B, H, T, D) f32; kc, vc (L, B, H, S, D) int8; ks, vs (L, B, H, S) f32;
// pos0 (B,) int32; slopes (H,) f32; out (B, H, T, D) bf16 or f32. All on
// the device, contiguous; D == 128. Returns a cudaError_t.
int stacked_int8_kv_attention(const float* q, const int8_t* kc,
                              const int8_t* vc, const float* ks,
                              const float* vs, const int* pos0,
                              const float* slopes, void* out, int out_bf16,
                              int l, int B, int H, int T, int S,
                              float qscale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long lo = (long)l * B * H * S;
  const int8_t* kl = kc + lo * D;
  const int8_t* vl = vc + lo * D;
  const float* ksl = ks + lo;
  const float* vsl = vs + lo;
  if (T == 1) {
    dim3 grid(1, H, B);
    int8_kv_attention_kernel<1><<<grid, NTHREADS, 0, st>>>(
        q, kl, vl, ksl, vsl, pos0, slopes, out, out_bf16, B, H, T, S,
        qscale);
  } else {
    constexpr int QT = 16;
    dim3 grid((T + QT - 1) / QT, H, B);
    int8_kv_attention_kernel<QT><<<grid, NTHREADS, 0, st>>>(
        q, kl, vl, ksl, vsl, pos0, slopes, out, out_bf16, B, H, T, S,
        qscale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
