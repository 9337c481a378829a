// The OVP mode of K5's prefill-size int8 product (stacked_prefill.cu) on
// Hopper's warpgroup tensor cores: xq (M, K) int8 snapped codes against
// layer `layer` of an N-major (L, N, K) stack of sign-offset OVP bytes c,
// whose value is 16 c - 15 clip(c, +-64), in K3's f32 order:
//
//   per segment of `seg` rows the exact int32 p = 16 xq@c - 15 xq@clip(c),
//   __int2float_rn(p) added with __fadd_rn in order within each f32 block
//   of `fold` segments, the blocks added in order, one __fmul_rn by
//   scales[n].
//
// Past 2^24 that f32 order is the result, so it is kept exactly; the int32
// dots are exact, and their order is free.
//
// What bounds it: operations, two int8 dots of 2 M K N each (at M = 2048
// a 4096 x 4096 site is 1.4e11 int8 ops against 16.8 MB of weight). Only
// wgmma reaches the card's int8 rate. wgmma reads B only from shared
// memory, but A may come from registers, so the roles are swapped against
// the int8-value product (i8_wgmma.cuh), as K3 does at decode
// (ovp_stream.cuh):
//   - the weight tile is wgmma's register-held A: each consumer warpgroup
//     owns 64 weight columns, and per 32-byte k step every warp loads its
//     16 columns with one ldmatrix x4 from the 128-byte-swizzled TMA stage
//     (the register fragment of an m64k32 s8 A tile is, per warp, that of
//     mma.sync m16n8k32's A), then clamps the same registers with clip64
//     for the second dot: no second shared tile, no third warpgroup;
//   - the x codes are B: XM = 128 rows of the (M, K) code scratch per
//     block, K-major in shared memory behind a 128-byte-swizzle descriptor
//     (i8_wgmma.cuh:sw128_desc), read by both dots, m64n128k32 s8;
//   - a block is two consumer warpgroups (128 weight columns) and one
//     producer thread that keeps a ring of STAGES stages (128 bytes of K
//     of 128 weight columns and of 128 x rows) full by TMA on the cached
//     3-D map of the whole stack and a 2-D map of the codes, guarded by
//     full and empty mbarriers; TMA fills the M, N and K tails with zeros;
//   - two k steps' four wgmma form one commit group, their A fragments
//     loaded only while none of the warpgroup's wgmma is in flight (a
//     fragment written while one is in flight makes ptxas serialise every
//     wgmma: C7513); so a pair retires (wait_group 0) before the next
//     loads, and the other warpgroup's pair fills the tensor cores
//     meanwhile; a stage goes back to the producer once its last pair has
//     retired;
//   - a segment ends every seg / 32 k steps (two stages at the engine's
//     seg 256, one at seg 128, a pair at seg 64, K = 64): the warpgroup
//     retires both dots (wait_group 0), forms 16 d1 - 15 d2 in int32, and
//     adds its f32 value into the block's sum; the next segment's first
//     wgmma pair overwrites the accumulators (scale-d 0), so nothing is
//     zeroed. The two warpgroups run unsynchronised but read the same
//     stages, so their drains mostly fall together (holding one back by a
//     stage gained a few per cent at block_k 1024, lost at 256: not kept);
//   - registers: the two 64 x 128 int32 dots are 128 a thread, the
//     running f32 sum 64 more and a pair's A fragments 16: the running
//     sum is the total when a block is one segment (fold 1); else the
//     block's sum and the total of the finished blocks lives in shared
//     memory (one f32 per output, touched at block ends only); ptxas -v
//     reports no spills. The alternative, a third warpgroup writing
//     clip(c) into a second shared stage for a shared-memory A, was not
//     built: it adds a stage's clip traffic to shared memory that both
//     dots already read twice, while the register form, once its
//     fragments were loaded only between groups, ran every check
//     bit-equal at 43% of the operation bound;
//   - the epilogue writes the transposed accumulator: D row i is weight
//     column n0 + 64 wg + i, D column j is x row m0 + j.
// Needs K % 64 == 0, seg % 64 == 0, K % (seg fold) == 0 and 16-byte
// aligned buffers (TMA); sm_90a.
#pragma once

#include "i8_wgmma.cuh"

// Internal linkage: every library that includes this header holds its own
// copy of the kernel, and no symbol of one may resolve to another's.
namespace {
namespace ow {

using wg::BK;                  // K bytes per stage: one swizzle row
constexpr int WN = 128;        // weight columns per block: two of 64
constexpr int XM = 128;        // x rows per block: the wgmma's N
constexpr int THREADS = 384;   // warpgroups 0, 1 consume; 2 produces
constexpr int STAGES = 4;
constexpr int W_BYTES = WN * BK;
constexpr int X_BYTES = XM * BK;
constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
constexpr int NACC = XM / 2;   // int32 of one m64n128 dot per thread
// the stages, 1024 bytes to align them, the barriers, the f32 totals of
// the finished blocks (two warpgroups of 128 threads x NACC)
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8 +
                     2 * 128 * NACC * 4;

using wg::clip64;
using wg::ldmatrix_x4;

// d (64 int32 per thread) = (scale_d ? d : 0) + A (64 x 32 bytes, in
// registers) . B (128 x 32 bytes, K-major in shared memory behind a
// descriptor)^T; s8 x s8 -> s32
__device__ __forceinline__ void wgmma_rs(int (&d)[NACC],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// keep registers in place across the asynchronous wgmma: the compiler
// must neither read nor reuse them until the group that uses them retires
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void wait_group0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// A consumer thread's place in the segments and f32 blocks.
struct Seg {
  int steps;    // k steps per segment
  int left;     // k steps to the segment's end
  int fold;     // segments per f32 block
  int segs;     // segments of the current block done
  int scale_d;  // 0: the next wgmma pair starts a segment
  int a_row;    // this lane's ldmatrix row of the weight stage
  int a_hi;     // and its 16-byte half of a k step
  int tid;      // the consumer thread, 0..255
};

// Two 32-byte k steps kk, kk + 1 of a stage (weights at wst, this lane's
// row; codes at xst): their A fragments (c and clip(c)) loaded while no
// wgmma of this warpgroup is in flight, then both dots of both steps as
// one commit group; at a segment's end its drain. ptxas serialises every
// wgmma when a fragment register is written while an earlier wgmma is in
// flight, so a pair waits for the previous one to retire (wait_group 0)
// before it loads; the other warpgroup's pair keeps the tensor cores busy
// meanwhile.
__device__ __forceinline__ void k_pair(const uint8_t* wst, const uint8_t* xst,
                                       int kk, uint32_t (&a0)[4],
                                       uint32_t (&p0)[4], uint32_t (&a1)[4],
                                       uint32_t (&p1)[4], int (&d1)[NACC],
                                       int (&d2)[NACC], float (&run)[NACC],
                                       float* tot, Seg& sg) {
  wait_group0();
  fence_regs(a0);
  fence_regs(p0);
  fence_regs(a1);
  fence_regs(p1);
  ldmatrix_x4(a0, wst + (((2 * kk + sg.a_hi) ^ (sg.a_row & 7)) << 4));
  ldmatrix_x4(a1, wst + (((2 * kk + 2 + sg.a_hi) ^ (sg.a_row & 7)) << 4));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p0[i] = clip64(a0[i]);
    p1[i] = clip64(a1[i]);
  }
  fence_regs(d1);
  fence_regs(d2);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const uint64_t db0 = wg::sw128_desc(xst + 32 * kk);
  const uint64_t db1 = wg::sw128_desc(xst + 32 * kk + 32);
  wgmma_rs(d1, a0, db0, sg.scale_d);
  wgmma_rs(d2, p0, db0, sg.scale_d);
  wgmma_rs(d1, a1, db1, 1);
  wgmma_rs(d2, p1, db1, 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  fence_regs(d1);
  fence_regs(d2);
  sg.scale_d = 1;
  sg.left -= 2;
  if (sg.left > 0) return;
  // a segment ends: both dots retire, its exact int32 value goes to f32
  // and into the block's sum in order; the next pair overwrites the dots
  wait_group0();
  fence_regs(d1);
  fence_regs(d2);
#pragma unroll
  for (int i = 0; i < NACC; ++i)
    run[i] = __fadd_rn(run[i], __int2float_rn(16 * d1[i] - 15 * d2[i]));
  sg.left = sg.steps;
  sg.scale_d = 0;
  if (sg.fold > 1 && ++sg.segs == sg.fold) {
    // a block ends: into the total of the finished blocks
    sg.segs = 0;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      float* t = tot + i * 256 + sg.tid;
      *t = __fadd_rn(*t, run[i]);
      run[i] = 0.f;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    ovp_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const float* __restrict__ scales,
                     float* __restrict__ out, int M, int N, int K, int layer,
                     int seg_steps, int fold) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* sw = base;                      // STAGES x (WN, BK) weights
  uint8_t* sx = base + STAGES * W_BYTES;   // STAGES x (XM, BK) codes
  uint64_t* full = (uint64_t*)(sx + STAGES * X_BYTES);
  uint64_t* empty = full + STAGES;
  float* tot = (float*)(empty + STAGES);   // (NACC, 256) block totals
  const int wgi = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int m0 = blockIdx.x * XM, n0 = blockIdx.y * WN;
  const int nk = (K + BK - 1) / BK;       // stages
  const int n32 = K / 32;                 // k steps

  if (wgi == 2) {  // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        wg::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        wg::mbar_expect_tx(&full[s], STAGE_BYTES);
        wg::tma_load_3d(sw + s * W_BYTES, &tm_w, &full[s], kt * BK, n0,
                        layer);
        wg::tma_load_2d(sx + s * X_BYTES, &tm_x, &full[s], kt * BK, m0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, w = (tid & 127) >> 5;
  // this warp's 16 weight columns, read by ldmatrix x4 from rows a_row and
  // bytes 16 a_hi of each 32-byte k step, the swizzle undone on 16-byte
  // chunks
  const int a_row = 64 * wgi + 16 * w + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_hi = lane >> 4;
  int d1[NACC], d2[NACC];       // the dots with c and with clip(c)
  float run[NACC];              // the running f32 sum
  uint32_t a0[4], p0[4], a1[4], p1[4];  // A fragments, double buffered
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    d1[i] = d2[i] = 0;
    run[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) a0[i] = p0[i] = a1[i] = p1[i] = 0u;
  if (fold > 1) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) tot[i * 256 + tid] = 0.f;
  }
  Seg seg = {seg_steps, seg_steps, fold, 0, 0, a_row, a_hi, tid};

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    wg::mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* wst = sw + s * W_BYTES + a_row * BK;
    const uint8_t* xst = sx + s * X_BYTES;
    const int kn = min(4, n32 - 4 * kt);  // k steps in this stage: 2 or 4
    k_pair(wst, xst, 0, a0, p0, a1, p1, d1, d2, run, tot, seg);
    // the previous stage's last pair retired before this one loaded: hand
    // that stage back
    if (kt > 0) wg::mbar_arrive(&empty[(kt - 1) % STAGES]);
    if (kn == 4) k_pair(wst, xst, 2, a0, p0, a1, p1, d1, d2, run, tot, seg);
  }
  wait_group0();
  fence_regs(d1);
  fence_regs(d2);

  // D row 16 w + g (+ 8) of this warpgroup is weight column n, its
  // columns 8 i + 2 t (+ 1) are x rows m; g = lane / 4, t = lane % 4
  const int g = lane >> 2, t4 = lane & 3;
  const float* sl = scales;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = n0 + 64 * wgi + 16 * w + g + 8 * hh;
    if (n >= N) continue;
    const float sc = sl[n];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * i + 2 * hh + e;
        const int m = m0 + 8 * i + 2 * t4 + e;
        if (m >= M) continue;
        const float v = fold > 1 ? tot[idx * 256 + tid] : run[idx];
        out[(long)m * N + n] = __fmul_rn(v, sc);
      }
  }
}

// xq (M, K) int8; w (L, N, K) int8 OVP bytes, the whole stack; scales (N,)
// f32 of layer `layer`; out (M, N) f32. Segments of seg rows, f32 blocks of
// `fold` segments. K % 64 == 0, seg % 64 == 0, K % (seg fold) == 0,
// 16-byte aligned buffers.
inline cudaError_t launch_ovp_wgmma(const int8_t* xq, const int8_t* w,
                                    int L, int layer, const float* scales,
                                    float* out, int M, int K, int N, int seg,
                                    int fold, cudaStream_t s) {
  if (K % 64 || seg < 64 || seg % 64 || fold < 1 || K % (seg * fold) ||
      ((uintptr_t)xq | (uintptr_t)w) % 16)
    return cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        ovp_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  CUtensorMap tm_x;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {BK, XM};
  if (!wg::encode(&tm_x, xq, 2, dims, strides, box))
    return cudaErrorInvalidValue;
  const CUtensorMap* tm_w = wg::stack_map(w, L, N, K, WN);
  if (tm_w == nullptr) return cudaErrorInvalidValue;
  const dim3 grid((M + XM - 1) / XM, (N + WN - 1) / WN);
  ovp_wgmma_kernel<<<grid, THREADS, SMEM, s>>>(tm_x, *tm_w, scales, out, M,
                                               N, K, layer, seg / 32, fold);
  return cudaGetLastError();
}

}  // namespace ow
}  // namespace
