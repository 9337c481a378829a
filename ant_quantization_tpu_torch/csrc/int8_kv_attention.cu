// The prefill regime of K2 and K7: causal attention of T > 16 queries
// against one layer of the INT8 KV cache, hand-written for Hopper
// (sm_90a). Per (b, h, t), with q scaled by a multiply by f32(1/sqrt(D)):
//
//   s   = (q . k_i8[pos]) * k_scale[pos] + slope * rel,  rel = pos - (pos0[b] + t)
//   s   = f32 min where rel > 0                          (causal mask)
//   p   = exp(s - max)
//   out = (sum_pos p * v_scale[pos] * v_i8[pos]) / sum_pos p,  cast to bf16 or f32
//
// Replaces the reference's Pallas kernel
// ant_quantization_tpu/kernels/attention.py:stacked_int8_kv_attention
// (_stacked_kernel). The wrapper (kernels/attention.py) makes one launch a
// call, on the layer's view of the stacked cache: T <= 16 goes to the
// split pass of int8_kv_attention_split.cu (kv_split.cuh), which K7 shares
// (the positions split across blocks, the partial softmax states combined
// in split order, so B * H * splits blocks fill the 132 SMs where one
// block per (b, h) would leave them idle; bound: the cache read, 2 * D
// bytes and two f32 scales per visible position against 4 * D flops per
// query); T > 16 to the kernel here.
//
// Prefill (T > 16). Bound: at T = 512 the bytes (the cache and q read
// once, the output written once) over the HBM rate, the products on the
// bf16 tensor cores taking less. Design (FlashAttention-2 on mma.sync
// m16n8k16 bf16, f32 accumulation): a block is 4 warps on 64 queries of
// one (b, h), each warp on 16 rows. The int8 codes are exact in bf16, so
// only the f32 operand needs care: it is split into three bf16 terms, hi
// = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), which hold every
// f32 value exactly, and each product is taken three times with exact
// products and f32 sums. So only the summation order differs from the
// f32 reference. (Two terms keep about 16 of the 24 bits and miss the
// f32 tolerance on large q with spread scales; one keeps 8:
// tests/test_torch_attention_hilo.py.) qs = f32(q) * qscale is split once
// per block into shared memory and read as A fragments with ldmatrix.
// K and V tiles of 64 positions arrive as int8
// through cp.async with their scales beside them, are widened to bf16 in
// shared memory (rows padded to W + 8 bf16, so the ldmatrix reads of 8 rows
// hit distinct banks), and are read with ldmatrix (K) and ldmatrix.trans
// (V, the col-major B operand of the PV product). The score accumulators
// are scaled by k_scale, given the ALiBi term and masked (on the tiles
// that reach the diagonal or the end of the cache only), and fed to an
// online softmax in registers (quad shuffles); p * v_scale is then split
// in three again and reused as the PV product's A fragments. Key tiles run
// from position 0 upward, so the first tile always holds position 0,
// which no query masks: the running max is finite from the first tile on
// and masked scores give p = 0 exactly, as in the reference. Tiles wholly
// past the block's last query position are never read, so the last query
// tiles do the most work: the 1-D grid hands them out first, for every
// head, and the short blocks fill in behind them. The division by
// sum p comes after the PV product, as in the reference. Summation orders
// differ from the plain version, so the result agrees within a tolerance
// (stated by the callers), not bit for bit; it does not depend on how
// blocks are scheduled.
//
// Both regimes (this kernel and the split pass) serve every head_dim D
// from 1 to 256: their kernels are
// built for the widths of KV_WIDTHS (kv_split.cuh), and D runs at the
// smallest width W >= D with zeros past D in q and in the K and V tiles
// (at D == W a variant with D a compile-time constant).
// A cache row of D bytes arrives in copies of 16 bytes where D is a
// multiple of 16 (and of 8 or 4 bytes, or single bytes, where it is not).

#include "kv_split.cuh"  // KV_WIDTHS, chunk_bytes

namespace {

constexpr int QB = 64;        // queries per block, 16 per warp
constexpr int KT = 64;        // key positions per tile
constexpr int NT = 128;       // threads per block
constexpr float NEG_BIG = -3.4028234663852886e+38f;  // f32 min

constexpr int NP = 3;         // bf16 terms of each f32 operand

// Width W, one of KV_WIDTHS (kv_split.cuh), serves head_dims up to W. A
// row of a widened tile is W + 8 bf16 (2 W + 16 bytes: a multiple of 16,
// W / 8 + 1 groups of 16 bytes, an odd count, so the 8 rows of one
// ldmatrix start in 8 distinct 16-byte bank groups at every W).
template <int W>
struct Smem {
  static constexpr int BSTR = W + 8;  // bf16 row stride of the widened tiles
  __nv_bfloat16 q[NP][QB * BSTR]; // qs = f32(q) * qscale, three terms
  int8_t k8[KT * W];              // landing zone, int8, row stride W
  int8_t v8[KT * W];
  __nv_bfloat16 kb[KT * BSTR];    // widened tiles
  __nv_bfloat16 vb[KT * BSTR];
  float ksc[KT];
  float vsc[KT];
};

// G bytes (16, 8 or 4) from gmem to smem, asynchronously; zeros when
// !valid (nothing is read then)
template <int G>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? G : 0;  // 0: fill the G bytes with zeros
  static_assert(G == 16 || G == 8 || G == 4, "");
  if (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  else if (G == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
}

// one element of q (B, H, T, D), f32 or bf16, as f32
__device__ __forceinline__ float q_at(const void* q, int q_bf16, long off) {
  return q_bf16 ? __bfloat162float(
                      reinterpret_cast<const __nv_bfloat16*>(q)[off])
                : reinterpret_cast<const float*>(q)[off];
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) -> three bf16x2 terms, largest first, whose sums are a and b
// exactly (each difference below is exact in f32)
__device__ __forceinline__ void split3(float a, float b, uint32_t* t) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    t[i] = bits(h);
    a -= __low2float(h);
    b -= __high2float(h);
  }
}

// four int8 codes of a little-endian word -> two exact bf16x2
__device__ __forceinline__ uint2 widen4(int w) {
  uint2 r;
  r.x = bits(__floats2bfloat162_rn((float)(int8_t)w, (float)(int8_t)(w >> 8)));
  r.y = bits(__floats2bfloat162_rn((float)(int8_t)(w >> 16),
                                   (float)(int8_t)(w >> 24)));
  return r;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Fragment layouts (m16n8k16, g = lane / 4, t = lane % 4): an A fragment
// holds rows g and g + 8 at columns 2t, 2t + 1 (regs 0, 1) and 2t + 8,
// 2t + 9 (regs 2, 3); a C fragment rows g (c0, c1) and g + 8 (c2, c3) at
// columns 2t, 2t + 1. QK^T takes W / 16 k-steps of 16 dims, PV W / 8
// n-tiles of 8 output dims (W = 16: 1 and 2; 96: 6 and 12; 256: 16 and
// 32). Past the head_dim D < W, q and the K and V tiles are zero, so the
// extra products add exact zeros, and the output columns there are not
// written. EXACT: D == W and 16-byte cache rows, D a compile-time
// constant (as in kv_split.cuh).
template <int W, bool EXACT>
__global__ void __launch_bounds__(NT)
prefill_kernel(const void* __restrict__ q, int q_bf16,
               const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
               const float* __restrict__ ks, const float* __restrict__ vs,
               const int* __restrict__ pos0, const float* __restrict__ slopes,
               void* out, int out_bf16, int B, int H, int T, int S,
               int d_arg, float qscale) {
  static_assert(W % 16 == 0, "");
  const int D = EXACT ? W : d_arg;
  constexpr int BSTR = Smem<W>::BSTR;
  constexpr int NC = W / 16;  // 16-byte chunks of a tile row; k-steps
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem<W>& sm = *reinterpret_cast<Smem<W>*>(smem_raw);
  // blocks run the last query tiles (the most key tiles) of every head
  // first, so the long blocks do not trail at the end of the grid
  const int n_bh = B * H, n_qb = gridDim.x / n_bh;
  const int t0 = (n_qb - 1 - (int)blockIdx.x / n_bh) * QB;
  const int h = blockIdx.x % n_bh % H, b = blockIdx.x % n_bh / H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long bh = (long)b * H + h;
  const long row0 = bh * S;  // first position of (b, h) in the layer
  const int p0 = pos0[b];
  const float slope = slopes ? slopes[h] : 0.0f;  // null: no ALiBi
  const int t_last = min(t0 + QB, T) - 1;
  const int n_tiles = min(p0 + t_last, S - 1) / KT + 1;
  const int r0 = t0 + 16 * warp + g;  // this thread's query rows r0, r0 + 8

  // qs = f32(q) * qscale in three bf16 terms, rows t0 .. t0 + 63, zero
  // past D
  for (int i = tid; i < QB * W / 2; i += NT) {
    const int rr = i / (W / 2), c = 2 * (i % (W / 2)), r = t0 + rr;
    float x0 = 0.0f, x1 = 0.0f;
    if (r < T && c < D) {
      const long off = (bh * T + r) * D + c;
      if (D % 2 == 0) {  // c + 1 < D, and the pair is aligned
        if (q_bf16) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
              reinterpret_cast<const __nv_bfloat16*>(q) + off);
          x0 = __low2float(v);
          x1 = __high2float(v);
        } else {
          const float2 v = *reinterpret_cast<const float2*>(
              reinterpret_cast<const float*>(q) + off);
          x0 = v.x;
          x1 = v.y;
        }
      } else {
        x0 = q_at(q, q_bf16, off);
        if (c + 1 < D) x1 = q_at(q, q_bf16, off + 1);
      }
    }
    uint32_t t3[NP];
    split3(x0 * qscale, x1 * qscale, t3);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      *reinterpret_cast<uint32_t*>(&sm.q[p][rr * BSTR + c]) = t3[p];
  }
  // ldmatrix rows of this warp's A fragments (x4: rows + 0 / + 8, dims
  // + 0 / + 8)
  const int a_off = (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * BSTR +
                    8 * (lane >> 4);

  // the landing zone's columns D .. W - 1 stay zero: no tile load
  // writes them
  if constexpr (!EXACT) {
    for (int i = tid; i < KT * (W - D); i += NT) {
      const int j = i / (W - D), d = D + i % (W - D);
      sm.k8[j * W + d] = 0;
      sm.v8[j * W + d] = 0;
    }
  }
  // each row's D bytes in 16-byte chunks, NC a row (a compile-time
  // count), each one asynchronous copy where D and the cache's address
  // allow 16 bytes, else copies of cb = 8 or 4 bytes (asynchronous) or
  // single bytes (loaded and stored by the thread); the chunks at and
  // past D stay zero
  const int cb = EXACT ? 16 : kvsplit::chunk_bytes(kc, vc, D);
  auto issue = [&](int tile) {  // the int8 codes of one tile
    const int k0 = tile * KT;
    for (int i = tid; i < KT * NC; i += NT) {
      const int j = i / NC, c0 = 16 * (i % NC), pos = k0 + j;
      if (c0 >= D) continue;
      const bool ok = pos < S;
      const long off = (row0 + (ok ? pos : 0)) * D + c0;
      int8_t* kd = &sm.k8[j * W + c0];
      int8_t* vd = &sm.v8[j * W + c0];
      if (cb == 16) {
        cp_async<16>(kd, kc + off, ok);
        cp_async<16>(vd, vc + off, ok);
        continue;
      }
      const int n = min(16, D - c0);
      for (int e = 0; e < n; e += cb) {
        switch (cb) {
          case 8:
            cp_async<8>(kd + e, kc + off + e, ok);
            cp_async<8>(vd + e, vc + off + e, ok);
            break;
          case 4:
            cp_async<4>(kd + e, kc + off + e, ok);
            cp_async<4>(vd + e, vc + off + e, ok);
            break;
          default:
            kd[e] = ok ? kc[off + e] : (int8_t)0;
            vd[e] = ok ? vc[off + e] : (int8_t)0;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  float ksr = 0.0f, vsr = 0.0f;  // the next tile's scales, thread tid < KT
  auto load_scales = [&](int tile) {
    const int pos = tile * KT + tid;
    if (tid < KT && pos < S) {
      ksr = ks[row0 + pos];
      vsr = vs[row0 + pos];
    }
  };

  float o[W / 8][4];
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};

  issue(0);
  load_scales(0);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KT;
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // tile `it` landed; the previous tile's readers done
    for (int i = tid; i < KT * NC; i += NT) {
      const int j = i / NC, c = i % NC;
      const int4 kw = *reinterpret_cast<const int4*>(&sm.k8[j * W + c * 16]);
      const int4 vw = *reinterpret_cast<const int4*>(&sm.v8[j * W + c * 16]);
      uint4* kd = reinterpret_cast<uint4*>(&sm.kb[j * BSTR + c * 16]);
      uint4* vd = reinterpret_cast<uint4*>(&sm.vb[j * BSTR + c * 16]);
      uint2 a = widen4(kw.x), bb = widen4(kw.y), cc = widen4(kw.z),
            dd = widen4(kw.w);
      kd[0] = make_uint4(a.x, a.y, bb.x, bb.y);
      kd[1] = make_uint4(cc.x, cc.y, dd.x, dd.y);
      a = widen4(vw.x), bb = widen4(vw.y), cc = widen4(vw.z), dd = widen4(vw.w);
      vd[0] = make_uint4(a.x, a.y, bb.x, bb.y);
      vd[1] = make_uint4(cc.x, cc.y, dd.x, dd.y);
    }
    if (tid < KT) {
      sm.ksc[tid] = ksr;
      sm.vsc[tid] = vsr;
    }
    __syncthreads();  // widened tile visible; the int8 zone is free again
    if (it + 1 < n_tiles) {
      issue(it + 1);
      load_scales(it + 1);
    }

    // scores: s[j] is the C fragment of keys k0 + 8 j .. + 7
    constexpr int NJ = KT / 8;
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) {  // dims 16 kk .. + 15
      uint32_t a[NP][4];
#pragma unroll
      for (int p = 0; p < NP; ++p) ldsm_x4(a[p], &sm.q[p][a_off + 16 * kk]);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {  // key tiles 2 jp and 2 jp + 1
        uint32_t r[4];
        ldsm_x4(r, &sm.kb[(16 * jp + (lane & 7) + 8 * (lane >> 4)) * BSTR +
                          16 * kk + 8 * ((lane >> 3) & 1)]);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          mma_bf16(s[2 * jp], a[p], r[0], r[1]);
          mma_bf16(s[2 * jp + 1], a[p], r[2], r[3]);
        }
      }
    }
    const bool need_mask = k0 + KT - 1 > p0 + t0 || k0 + KT > S;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = 8 * j + 2 * t4 + (e & 1), key = k0 + jj;
        const int rel = key - (p0 + r0 + 8 * (e >> 1));
        float v = __fadd_rn(__fmul_rn(s[j][e], sm.ksc[jj]),
                            __fmul_rn(slope, (float)rel));
        if (need_mask && (rel > 0 || key >= S)) v = NEG_BIG;
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m_run[hh], quad_max(mx[hh]));
      corr[hh] = expf(m_run[hh] - m_new);  // 0 on the first tile
      m_run[hh] = m_new;
      l_run[hh] *= corr[hh];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_run[e >> 1]);
        l_run[e >> 1] += p;
        s[j][e] = p * sm.vsc[8 * j + 2 * t4 + (e & 1)];
      }
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];

    // PV: k-step kk covers keys 16 kk .. + 15, i.e. score tiles 2 kk, 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      uint32_t pa[NP][4], t3[NP];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // A regs: (row, key) pairs of s
        const float* src = s[2 * kk + (e >> 1)] + 2 * (e & 1);
        split3(src[0], src[1], t3);
#pragma unroll
        for (int p = 0; p < NP; ++p) pa[p][e] = t3[p];
      }
#pragma unroll
      for (int np = 0; np < NC; ++np) {  // output dims 16 np .. + 15
        uint32_t r[4];
        ldsm_x4_t(r, &sm.vb[(16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                BSTR + 16 * np + 8 * (lane >> 4)]);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          mma_bf16(o[2 * np], pa[p], r[0], r[1]);
          mma_bf16(o[2 * np + 1], pa[p], r[2], r[3]);
        }
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    const float l = quad_sum(l_run[hh]);
    if (r >= T) continue;
    const long base = (bh * T + r) * D;
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
      const int col = 8 * n + 2 * t4;  // this thread's columns col, col + 1
      if (col >= D) continue;  // (not break: keeps the loop unrolled)
      const float a = o[n][2 * hh] / l, c = o[n][2 * hh + 1] / l;
      if (D % 2 == 0) {  // col + 1 < D, and the pair is aligned
        if (out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(
              reinterpret_cast<__nv_bfloat16*>(out) + base + col) =
              __floats2bfloat162_rn(a, c);
        else
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + base +
                                     col) = make_float2(a, c);
      } else if (out_bf16) {
        __nv_bfloat16* o16 = reinterpret_cast<__nv_bfloat16*>(out) + base;
        o16[col] = __float2bfloat16(a);
        if (col + 1 < D) o16[col + 1] = __float2bfloat16(c);
      } else {
        float* o32 = reinterpret_cast<float*>(out) + base;
        o32[col] = a;
        if (col + 1 < D) o32[col + 1] = c;
      }
    }
  }
}

template <int W, bool EXACT>
cudaError_t launch_prefill_e(const void* q, int q_bf16, const int8_t* kl,
                             const int8_t* vl, const float* ksl,
                             const float* vsl, const int* pos0,
                             const float* slopes, void* out, int out_bf16,
                             int B, int H, int T, int S, int D, float qscale,
                             cudaStream_t st) {
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_kernel<W, EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem<W>));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int grid = (T + QB - 1) / QB * B * H;
  prefill_kernel<W, EXACT><<<grid, NT, sizeof(Smem<W>), st>>>(
      q, q_bf16, kl, vl, ksl, vsl, pos0, slopes, out, out_bf16, B, H, T, S,
      D, qscale);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_prefill(const void* q, int q_bf16, const int8_t* kl,
                           const int8_t* vl, const float* ksl,
                           const float* vsl, const int* pos0,
                           const float* slopes, void* out, int out_bf16,
                           int B, int H, int T, int S, int D, float qscale,
                           cudaStream_t st) {
  if (D == W && kvsplit::chunk_bytes(kl, vl, D) == 16)
    return launch_prefill_e<W, true>(q, q_bf16, kl, vl, ksl, vsl, pos0,
                                     slopes, out, out_bf16, B, H, T, S, D,
                                     qscale, st);
  return launch_prefill_e<W, false>(q, q_bf16, kl, vl, ksl, vsl, pos0, slopes,
                                    out, out_bf16, B, H, T, S, D, qscale, st);
}

}  // namespace

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K2's and K7's prefill regime on one layer: q (B, H, T, D) f32, or bf16
// when q_bf16 (converted exactly), T > 16; kc, vc (B, H, S, D) int8 (one
// layer of the stacked cache, or K7's layer); ks, vs (B, H, S) f32; pos0
// (B,) int32; slopes (H,) f32 or null (no ALiBi); out (B, H, T, D) bf16
// or f32. All on the device, contiguous; 1 <= D <= 256 (any other:
// cudaErrorInvalidValue). Returns a cudaError_t.
int int8_kv_attention_prefill(const void* q, int q_bf16, const int8_t* kc,
                              const int8_t* vc, const float* ks,
                              const float* vs, const int* pos0,
                              const float* slopes, void* out, int out_bf16,
                              int B, int H, int T, int S, int D, float qscale,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (T <= 16 || D < 1) return (int)cudaErrorInvalidValue;
#define K2_PREFILL_W(WW)                                                      \
  if (D <= WW)                                                                \
    return (int)launch_prefill<WW>(q, q_bf16, kc, vc, ks, vs, pos0, slopes,   \
                                   out, out_bf16, B, H, T, S, D, qscale, st);
  KV_WIDTHS(K2_PREFILL_W)
#undef K2_PREFILL_W
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
