// The prefill-size int8 product of K5 (stacked_prefill.cu, int8-value
// weights) and K9 (w8a8_matmul.cu) on Hopper's warpgroup tensor cores
// (its mbarrier, TMA, tensor-map and fragment pieces also serve K1's
// weight stream, i8_stream.cuh, K3, K4 and K6 on it, K5's OVP product,
// ovp_wgmma.cuh, and K8, qmatmul_w4.cu):
// xq (M, K) int8 snapped codes against layer `layer` of an N-major
// (L, N, K) int8 weight stack, int32 accumulation, then one f32 multiply
// by scales[n]:
//
//   out[m, n] = f32(sum_k xq[m, k] W[layer, n, k]) * scales[n]
//
// What bounds it: operations (at M = 2048 a 4096 x 4096 site is 6.9e10
// int8 ops against 16.8 MB of weight). Only wgmma reaches the card's int8
// rate (1,979 TOP/s dense); mma.sync, Hopper's legacy path, does not.
// Design:
//   - wgmma.mma_async m64n128k32 s8 . s8 -> s32 reads both operands
//     K-major from shared memory, which is the layout of xq (M, K) and of
//     the N-major weight (N, K) alike, so neither is transposed;
//   - a block computes a BM = 128 by BN = 256 output tile: two
//     consumer warpgroups of 64 rows each, every k step one wgmma per 128
//     columns (its 64 x BN int32 accumulators in registers);
//   - K runs through a ring of STAGES shared-memory stages of 128 bytes of
//     K each, filled by TMA (cp.async.bulk.tensor) with the 128-byte
//     swizzle that the wgmma descriptors name, and guarded by mbarriers: a
//     "full" barrier per stage that the TMA transaction count completes,
//     an "empty" one that every consumer thread arrives on once its wgmma
//     on the stage has retired (wgmma.wait_group 1 keeps one group in
//     flight while the next is issued);
//   - one thread of a third warpgroup is the producer; the tensor maps
//     are 2-D over xq and 3-D over the whole (L, N, K) stack, the layer a
//     coordinate, so a stack's map is encoded once and cached; TMA fills
//     the M, N and K tails with zeros;
//   - blocks walk M fastest, so the blocks in flight share weight tiles
//     and each weight byte comes from HBM about once.
// The int32 sums are exact, so their order is free and the f32 epilogue
// (__int2float_rn, __fmul_rn) is the plain version's: bit for bit.
// Needs K % 16 == 0 and 16-byte aligned buffers (TMA); sm_90a.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage: every library that includes this header holds its own
// copy of the kernels, and no symbol of one may resolve to another's.
namespace {
namespace wg {

constexpr int BM = 128;        // rows per block: two consumer warpgroups
constexpr int BK = 128;        // K bytes per stage: one swizzle row
constexpr int THREADS = 384;   // warpgroups 0, 1 consume; 2 produces

constexpr int BN = 256;        // columns per block: two wgmma of 128
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// the stages, 1024 bytes to align them, the barriers
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// ldmatrix x4: lanes 8 q .. 8 q + 7 give the row addresses of 8 x 16-byte
// matrix q, which lands in r[q] (lane L: bytes 4 (L % 4) .. + 3 of row
// L / 4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(smem)));
}

// c += A (16 x 32 s8, row) . B (8 x 32 s8, col), int32: mma.sync m16n8k32
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// clip(c, -64, 64) on each signed byte (the OVP weight's second form)
__device__ __forceinline__ uint32_t clip64(uint32_t w) {
  return (uint32_t)__vmaxs4(__vmins4((int)w, 0x40404040), 0xC0C0C0C0);
}

// A K-major operand of 8-row groups of 128-byte rows, 128-byte swizzle:
// start address, leading offset (unused here), stride 1024 bytes between
// 8-row groups, layout type 1 (SWIZZLE_128B). A k step of 32 bytes inside
// the swizzle row moves the start address by 32.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 int32 per thread) += A (64 x 32 bytes) . B (128 x 32 bytes)^T, both
// K-major in shared memory behind descriptors; s8 x s8 -> s32
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_acc(int (&acc)[BN / 128][64]) {
#pragma unroll
  for (int nb = 0; nb < BN / 128; ++nb)
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(acc[nb][i])::"memory");
}

__global__ void __launch_bounds__(THREADS, 1)
    i8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b,
                    const float* __restrict__ scales, float* __restrict__ out,
                    int M, int N, int K, int layer) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* sa = base;                     // STAGES x (BM, BK)
  uint8_t* sb = base + STAGES * A_BYTES;  // STAGES x (BN, BK)
  uint64_t* full = (uint64_t*)(sb + STAGES * B_BYTES);
  uint64_t* empty = full + STAGES;
  const int wgi = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  if (wgi == 2) {  // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(sa + s * A_BYTES, &tm_a, &full[s], kt * BK, m0);
        tma_load_3d(sb + s * B_BYTES, &tm_b, &full[s], kt * BK, n0, layer);
      }
    }
  } else {  // consumers: warpgroup wgi owns rows m0 + 64 wgi .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    int acc[BN / 128][64];
#pragma unroll
    for (int nb = 0; nb < BN / 128; ++nb)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[nb][i] = 0;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint8_t* a = sa + s * A_BYTES + wgi * 64 * BK;
      const uint8_t* b = sb + s * B_BYTES;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
        for (int nb = 0; nb < BN / 128; ++nb)
          wgmma_m64n128k32(acc[nb], sw128_desc(a + 32 * kk),
                           sw128_desc(b + nb * 128 * BK + 32 * kk));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(acc);
      // the previous stage's group has retired: hand its stage back
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);

    // accumulator layout: warp w of the group holds rows 16 w + g and
    // 16 w + g + 8; element 4 i + e is column 8 i + 2 t + (e & 1), row
    // + 8 (e >> 1), with g = lane / 4, t = lane % 4
    const int lane = threadIdx.x & 31, w = (threadIdx.x & 127) >> 5;
    const int row = m0 + 64 * wgi + 16 * w + (lane >> 2);
#pragma unroll
    for (int nb = 0; nb < BN / 128; ++nb)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = n0 + 128 * nb + 8 * i + 2 * (lane & 3);
        if (col >= N) continue;
        const bool two = col + 1 < N;
        const float s0 = scales[col], s1 = two ? scales[col + 1] : 0.0f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row + 8 * hh;
          if (r >= M) continue;
          const float v0 =
              __fmul_rn(__int2float_rn(acc[nb][4 * i + 2 * hh]), s0);
          const float v1 =
              __fmul_rn(__int2float_rn(acc[nb][4 * i + 2 * hh + 1]), s1);
          float* dst = out + (long)r * N + col;
          if (two && N % 2 == 0) {  // 8-byte aligned
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (two) dst[1] = v1;
          }
        }
      }
  }
}

// ---- host side ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda
inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiledFn)p;
  }
  return fn;
}

// an int8 tensor of `rank` dims (innermost first) with byte strides, a box
// of 128 bytes of K by box rows (by 1 layer), 128-byte swizzle, zero fill
inline bool encode(CUtensorMap* map, const void* ptr, int rank,
                   const cuuint64_t* dims, const cuuint64_t* strides,
                   const cuuint32_t* box) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, (cuuint32_t)rank,
            const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 3-D map of a weight stack (boxes of 128 bytes of K by `rows`
// columns), encoded once per stack and box and kept.
struct StackMap {
  const void* ptr;
  int L, N, K, rows;
  CUtensorMap map;
};

inline const CUtensorMap* stack_map(const int8_t* w, int L, int N, int K,
                                    int rows = BN) {
  static StackMap cache[32];
  static int n_used = 0, next = 0;
  for (int i = 0; i < n_used; ++i) {
    const StackMap& e = cache[i];
    if (e.ptr == w && e.L == L && e.N == N && e.K == K && e.rows == rows)
      return &e.map;
  }
  StackMap& e = cache[next];
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)K, (cuuint64_t)N * K};
  const cuuint32_t box[3] = {BK, (cuuint32_t)rows, 1};
  if (!encode(&e.map, w, 3, dims, strides, box)) return nullptr;
  e.ptr = w;
  e.L = L;
  e.N = N;
  e.K = K;
  e.rows = rows;
  next = (next + 1) % 32;
  if (n_used < 32) ++n_used;
  return &e.map;
}

// xq (M, K) int8; w (L, N, K) int8, the whole stack; scales (N,) f32 of
// layer `layer`; out (M, N) f32. K % 16 == 0, 16-byte aligned buffers.
inline cudaError_t launch_i8_wgmma(const int8_t* xq, const int8_t* w, int L,
                                   int layer, const float* scales, float* out,
                                   int M, int K, int N, cudaStream_t s) {
  if (K % 16 || ((uintptr_t)xq | (uintptr_t)w) % 16)
    return cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        i8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  CUtensorMap tm_a;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {BK, BM};
  if (!encode(&tm_a, xq, 2, dims, strides, box)) return cudaErrorInvalidValue;
  const CUtensorMap* tm_b = stack_map(w, L, N, K);
  if (tm_b == nullptr) return cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  i8_wgmma_kernel<<<grid, THREADS, SMEM, s>>>(tm_a, *tm_b, scales, out, M, N,
                                              K, layer);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace
