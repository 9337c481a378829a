// K8: x (M, K) @ packed 4-bit weights decoded through a 16-entry grid,
// times a per-output-channel scale, hand-written for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel
// ant_quantization_tpu/kernels/qmatmul.py:quantized_matmul_w4
// (_qmm_kernel):
//
//   out[m, n] = (sum_i x[m, i] grid[lo(i, n)] + x[m, i + K/2] grid[hi(i, n)])
//               * scale[n]
//
// over split-K packed bytes, stored N-major (N, K/2): byte i of column n
// holds code(i, n) low and code(i + K/2, n) high. The reference's product
// is an f32 dot (`preferred_element_type=f32`, no TF32); this kernel holds
// the same hold as before: within 1e-5 of each output's sum of term
// magnitudes |x| @ |W|.
//
// What bounds it: operations. At prefill (M = 2048) a 4096 x 4096 site is
// 6.9e10 FLOP against 8.4 MB of packed weights, far above the card's
// operations-per-byte line, and only the tensor cores come near the card's
// rate (989 TFLOP/s bf16 against 67 f32 outside them). Design: bf16
// wgmma with f32 accumulators on operands that bf16 holds exactly.
//   - B, the weight: each 4-bit code is decoded through a 16-entry bf16
//     table (kernels/qmatmul.py:w4_term_plan decides it on the host once
//     per grid): the grid itself where bf16 holds every entry (flint, pot,
//     float); else its int8 restatement q16 with the unit moved into the
//     epilogue (the int grid); else the grid split into up to three bf16
//     terms (hi, mid, lo: every f32 value exactly).
//   - A, the activation: a bf16 x is one term and goes to the tensor
//     cores as it is; an f32 x is first split into three bf16 terms
//     (hi, mid, lo, exactly) by a pre-pass into a (3, M, K) scratch.
//   - Products: only the (A term, B term) pairs whose bound can exceed
//     1/16 of the hold are issued (term i of a split is at most 2^-8 of
//     the value for i = 1, 2^-17 for i = 2; the pairs with i + j <= 2).
//     The engine's case, a bf16 x against an exact table, is one bf16
//     wgmma per tile; an f32 x against it three; a split table against
//     bf16 x three, against f32 x six. The wrapper lists the pairs,
//     smallest bound first, so that the corrections are summed at their
//     own scale before the leading product's sum takes them in (with
//     the leading product first, an f32 x against a split grid came
//     within 3% of the hold at K = 16384); a pair whose weight term is
//     all zero is skipped on the card, and the pairs run one after
//     another over the whole K range into one f32 accumulator.
//   - Shape: a block computes a 128 x 128 output tile. One producer
//     thread (of a warp of its own) fills a 3-stage ring by TMA: the packed bytes (64 per column
//     per stage, i.e. 64 K values of each half), and the two x tiles
//     they pair with (K offsets k and K/2 + k), 128-byte swizzled. Two
//     consumer warpgroups (64 rows each) decode the stage's nibbles
//     together into a 128-byte-swizzled bf16 B tile (two __byte_perm
//     lookups per four codes for the low bytes, two for the high, into
//     the table held in registers), then each issues wgmma m64n128k16 on
//     its rows. The decoded tiles rotate through three buffers, so the
//     next stage is decoded while the tensor cores work on this one.
//   - Epilogue: one f32 multiply by the unit (1 unless the table is q16)
//     and one by scale[n].

#include <cuda_bf16.h>

#include "i8_wgmma.cuh"

namespace {
namespace k8 {

using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::smem_u32;
using wg::sw128_desc;

constexpr int BM = 128, BN = 128;
constexpr int BKP = 64;                 // packed bytes per column per stage
constexpr int STAGES = 3, NBUF = 3;
// warpgroups 0 and 1 consume, one more warp produces: 288 threads leave
// each up to 224 registers, so the 64 f32 sums of a consumer never move
// (they did under 384 threads' cap of 168, and ptxas then serialized the
// wgmma groups)
constexpr int THREADS = 288;
constexpr int A_HALF = BM * BKP * 2;    // 128 rows x 64 bf16: 16 KB
constexpr int A_BYTES = 2 * A_HALF;     // the low-half and high-half K tiles
constexpr int B_HALF = BN * BKP * 2;
constexpr int B_BYTES = 2 * B_HALF;
constexpr int P_BYTES = BN * BKP;       // packed bytes: 8 KB
constexpr int MAX_PAIRS = 8;
constexpr int SMEM = STAGES * A_BYTES + NBUF * B_BYTES + STAGES * P_BYTES +
                     1024 + 2 * STAGES * 8 + 3 * 16 * 4;

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// d (64 f32 per thread) += A (64 x 16 bf16) . B (128 x 16 bf16)^T, both
// K-major in shared memory behind descriptors
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_acc(float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// 4 codes (one per byte, 0..15) -> their 4 bf16 table values as two
// words (value 0 in the low half of w0). lo/hi hold the table's low and
// high bytes, 16 each, in four registers.
__device__ __forceinline__ void decode4(uint32_t nib, const uint32_t (&lo)[4],
                                        const uint32_t (&hi)[4], uint32_t& w0,
                                        uint32_t& w1) {
  const uint32_t s = nib | (nib >> 4);           // n0|n1<<4 .. n2|n3<<4
  const uint32_t sel = ((s & 0xFFu) | ((s >> 8) & 0xFF00u)) & 0x7777u;
  const uint32_t up = __vcmpgeu4(nib, 0x08080808u);  // entries 8..15
  const uint32_t lb = (__byte_perm(lo[2], lo[3], sel) & up) |
                      (__byte_perm(lo[0], lo[1], sel) & ~up);
  const uint32_t hb = (__byte_perm(hi[2], hi[3], sel) & up) |
                      (__byte_perm(hi[0], hi[1], sel) & ~up);
  w0 = __byte_perm(lb, hb, 0x5140);
  w1 = __byte_perm(lb, hb, 0x7362);
}

struct Pairs {
  int n;
  int a[MAX_PAIRS], b[MAX_PAIRS];  // x term, weight term
};

__global__ void __launch_bounds__(THREADS, 1)
    w4_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_p,
                   const float* __restrict__ terms,
                   const float* __restrict__ unit,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int M, int N, int K2, const Pairs pairs) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* sa = base;                       // STAGES x (lo, hi) x (BM, BKP)
  uint8_t* sb = sa + STAGES * A_BYTES;      // NBUF x (lo, hi) x (BN, BKP)
  uint8_t* sp = sb + NBUF * B_BYTES;        // STAGES x (BN, BKP) bytes
  uint64_t* full = (uint64_t*)(sp + STAGES * P_BYTES);
  uint64_t* empty = full + STAGES;
  float* sterm = (float*)(empty + STAGES);   // (3, 16) weight terms
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 48) sterm[tid] = terms[tid];
  __syncthreads();
  // the listed pairs whose weight term is not all zero, in order
  int act[MAX_PAIRS];
  int n_act = 0;
  for (int p = 0; p < pairs.n; ++p) {
    bool any = false;
    for (int e = 0; e < 16; ++e) any |= sterm[16 * pairs.b[p] + e] != 0.f;
    if (any) act[n_act++] = p;
  }
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K2 + BKP - 1) / BKP;
  const int total = n_act * nk;

  if (wgi == 2) {  // producer: one thread keeps the ring full
    if (tid == 256) {
      for (int it = 0; it < total; ++it) {
        const int s = it % STAGES;
        const int a = pairs.a[act[it / nk]], k = (it % nk) * BKP;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], A_BYTES + P_BYTES);
        tma_load_4d(sa + s * A_BYTES, &tm_x, &full[s], k, 0, m0, a);
        tma_load_4d(sa + s * A_BYTES + A_HALF, &tm_x, &full[s], k, 1, m0, a);
        wg::tma_load_2d(sp + s * P_BYTES, &tm_p, &full[s], k, n0);
      }
    }
    return;
  }
  // consumers: warpgroup wgi owns rows m0 + 64 wgi .. + 63
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int cur = -1;
  uint32_t tlo[4], thi[4];
  for (int it = 0; it < total; ++it) {
    const int s = it % STAGES, buf = it % NBUF;
    const int bt = pairs.b[act[it / nk]];
    if (bt != cur) {  // the term's bf16 table: low bytes, high bytes
#pragma unroll
      for (int i = 0; i < 4; ++i) tlo[i] = thi[i] = 0u;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const uint32_t b = (uint32_t)__bfloat16_as_ushort(
            __float2bfloat16_rn(sterm[16 * bt + e]));
        tlo[e >> 2] |= (b & 0xFFu) << (8 * (e & 3));
        thi[e >> 2] |= (b >> 8) << (8 * (e & 3));
      }
      cur = bt;
    }
    mbar_wait(&full[s], (it / STAGES) & 1);
    // decode: 128 columns x 4 chunks of 16 packed bytes, two per thread;
    // eight neighbouring threads read 128 contiguous bytes and write
    // 16-byte chunks of two rows that the swizzle keeps apart
    uint8_t* bdst = sb + buf * B_BYTES;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int task = tid + 256 * r;
      const int n = task >> 2, c = task & 3;
      const uint4 pw =
          *reinterpret_cast<const uint4*>(sp + s * P_BYTES + n * BKP + 16 * c);
      const uint32_t ws[4] = {pw.x, pw.y, pw.z, pw.w};
      uint8_t* row = bdst + n * 128;
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // packed words 2q, 2q + 1: chunk 2c + q
        uint4 lo, hi;
        decode4(ws[2 * q] & 0x0F0F0F0Fu, tlo, thi, lo.x, lo.y);
        decode4(ws[2 * q + 1] & 0x0F0F0F0Fu, tlo, thi, lo.z, lo.w);
        decode4((ws[2 * q] >> 4) & 0x0F0F0F0Fu, tlo, thi, hi.x, hi.y);
        decode4((ws[2 * q + 1] >> 4) & 0x0F0F0F0Fu, tlo, thi, hi.z, hi.w);
        const int chunk = (2 * c + q) ^ (n & 7);
        *reinterpret_cast<uint4*>(row + 16 * chunk) = lo;
        *reinterpret_cast<uint4*>(row + B_HALF + 16 * chunk) = hi;
      }
    }
    // the generic-proxy writes above, visible to wgmma's reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const uint8_t* a = sa + s * A_BYTES + wgi * 64 * 128;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kk = 0; kk < BKP / 16; ++kk)
        wgmma_bf16(acc, sw128_desc(a + h * A_HALF + 32 * kk),
                   sw128_desc(bdst + h * B_HALF + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the previous stage's group has retired: hand its stage back
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    if (it > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  // accumulator layout: warp w of the group holds rows 16 w + g and
  // 16 w + g + 8; element 4 i + e is column 8 i + 2 t + (e & 1), row
  // + 8 (e >> 1), with g = lane / 4, t = lane % 4
  const float u = *unit;
  const int lane = tid & 31, w = (tid & 127) >> 5;
  const int row = m0 + 64 * wgi + 16 * w + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = n0 + 8 * i + 2 * (lane & 3);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + 8 * (e >> 1), cc = col + (e & 1);
      if (r < M && cc < N)
        out[(long)r * N + cc] =
            __fmul_rn(__fmul_rn(acc[4 * i + e], u), scale[cc]);
    }
  }
}

// f32 x -> its three bf16 terms: hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid); both differences are exact in f32, and the
// three terms sum to x exactly
__global__ void split3_kernel(const float* __restrict__ x,
                              __nv_bfloat16* __restrict__ xs, long total) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const float f = x[i];
    const __nv_bfloat16 h = __float2bfloat16_rn(f);
    const float r1 = f - __bfloat162float(h);
    const __nv_bfloat16 m = __float2bfloat16_rn(r1);
    const float r2 = r1 - __bfloat162float(m);
    xs[i] = h;
    xs[total + i] = m;
    xs[2 * total + i] = __float2bfloat16_rn(r2);
  }
}

inline bool encode(CUtensorMap* map, CUtensorMapDataType dt, const void* ptr,
                   int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box,
                   CUtensorMapSwizzle swizzle) {
  wg::EncodeTiledFn fn = wg::encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, dt, (cuuint32_t)rank, const_cast<void*>(ptr), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace k8
}  // namespace

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (M, K): bf16 (x_f32 == 0) or f32 (x_f32 != 0, then split into xs,
// a (3, M, K) bf16 scratch); packed (N, K/2) uint8; scale (N,) f32; terms
// (3, 16) f32, each value exact in bf16; unit (1,) f32; out (M, N) f32,
// all on the device, 16-byte aligned. K/2 % 16 == 0. pair_a / pair_b: the
// (x term, weight term) pairs to issue, n_pairs <= 8 (the wrapper lists
// them). Returns a cudaError_t.
int w4_bf16_matmul(const void* x, void* xs, const uint8_t* packed,
                   const float* scale, const float* terms, const float* unit,
                   float* out, int M, int K, int N, int x_f32,
                   const int* pair_a, const int* pair_b, int n_pairs,
                   void* stream) {
  using namespace k8;
  cudaStream_t s = (cudaStream_t)stream;
  const int K2 = K / 2;
  if (K2 % 16 || n_pairs < 1 || n_pairs > MAX_PAIRS ||
      ((uintptr_t)x | (uintptr_t)packed | (uintptr_t)xs) % 16)
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        w4_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const void* xa = x;
  int n_terms = 1;
  if (x_f32) {
    const long total = (long)M * K;
    long blocks = (total + 255) / 256;
    if (blocks > 8192) blocks = 8192;
    split3_kernel<<<(int)blocks, 256, 0, s>>>(
        (const float*)x, (__nv_bfloat16*)xs, total);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    xa = xs;
    n_terms = 3;
  }
  Pairs pairs;
  pairs.n = n_pairs;
  for (int p = 0; p < MAX_PAIRS; ++p) {
    pairs.a[p] = p < n_pairs ? pair_a[p] : 0;
    pairs.b[p] = p < n_pairs ? pair_b[p] : 0;
    if (p < n_pairs && (pairs.a[p] < 0 || pairs.a[p] >= n_terms ||
                        pairs.b[p] < 0 || pairs.b[p] > 2))
      return (int)cudaErrorInvalidValue;
  }
  // x as (terms, M, 2 halves, K/2) bf16: a box is 64 K values of one half
  // of 128 rows, so each half's tail is filled with zeros on its own
  CUtensorMap tm_x, tm_p;
  const cuuint64_t xd[4] = {(cuuint64_t)K2, 2, (cuuint64_t)M,
                            (cuuint64_t)n_terms};
  const cuuint64_t xst[3] = {(cuuint64_t)K2 * 2, (cuuint64_t)K * 2,
                             (cuuint64_t)M * K * 2};
  const cuuint32_t xb[4] = {BKP, 1, BM, 1};
  if (!encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xa, 4, xd, xst, xb,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const cuuint64_t pd[2] = {(cuuint64_t)K2, (cuuint64_t)N};
  const cuuint64_t pst[1] = {(cuuint64_t)K2};
  const cuuint32_t pb[2] = {BKP, BN};
  if (!encode(&tm_p, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, 2, pd, pst, pb,
              CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  w4_bf16_kernel<<<grid, THREADS, SMEM, s>>>(tm_x, tm_p, terms, unit, scale,
                                             out, M, N, K2, pairs);
  return (int)cudaGetLastError();
}

}  // extern "C"
