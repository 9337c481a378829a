// The KV append: one layer's new keys and values quantized to INT8 (or
// cast, for a raw cache) and written at each sequence's own position of
// the cache, in one launch, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference writes the cache with XLA
// updates (ant_quantization_tpu/kernels/kv_cache.py: _put_codes,
// _put_scales). It was added because the port's per-sequence writes,
// four indexed copies per sequence and layer behind an eager quantize,
// were bound by the host's launches.
//
// What bounds it: bytes, about 1.6 MB a decode layer at 64 sequences of
// 32 heads of 128 (bf16 in, int8 codes and f32 scales out), under 1 us at
// 3.35 TB/s; its cost is the one launch. Design: one warp per (which, b,
// t, h) row, which = k or v. Each lane widens its share of the row's D
// values to f32 exactly; a __shfl_xor reduction gives the row's absmax;
//   scale = amax > 0 ? amax / 127 : 1,   code = clamp(rint(x / scale))
// with IEEE division (no --use_fast_math) and round half to even, as the
// plain version (torch division and torch.round) computes them. Codes go
// to [b, h, pos[b] + t, :], lane 0 writes the scale. A row is read
// through its strides (BLOOM's fused qkv hands over split views, no
// copy), with 16-byte loads where D and the alignment allow and one
// element a lane otherwise. Each sequence owns its rows, so no two warps
// write the same byte; nothing is allocated, no shared memory, no
// synchronisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace kva {

constexpr int WARP = 32;
constexpr int WARPS = 8;      // warps a block
constexpr int MAX_D = 256;    // 8 values a lane

enum Out { OUT_I8 = 0, OUT_BF16 = 1, OUT_F32 = 2 };

struct Rows {
  const void* src[2];         // k, v: (B, T, H, D) through their strides
  long long stride[2][4];     // elements, per (b, t, h, d)
  void* dst[2];               // the layer's (B, H, S, D) codes or values
  float* scale[2];            // the layer's (B, H, S) scales (int8 cache)
  const int* pos;             // (B,) first write position of each sequence
  int B, T, H, S, D;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename O>
__device__ __forceinline__ O narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ int8_t narrow<int8_t>(float x) {
  return (int8_t)(int)x;      // x is a whole number in [-127, 127]
}

// N elements of O from o to p, in the widest words their bytes allow
// (p is aligned to that width: the launcher checks the base pointers)
template <typename O, int N>
__device__ __forceinline__ void store(O* p, const O* o) {
  constexpr int BYTES = N * (int)sizeof(O);
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(o)[i];
  } else if constexpr (BYTES % 8 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 8; ++i)
      reinterpret_cast<uint2*>(p)[i] = reinterpret_cast<const uint2*>(o)[i];
  } else if constexpr (BYTES % 4 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i)
      reinterpret_cast<uint32_t*>(p)[i] =
          reinterpret_cast<const uint32_t*>(o)[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = o[i];
  }
}

// One warp a row. VEC elements a lane per chunk: 16 bytes of input (the
// vector path, unit d stride) or 1 (the lane-strided path); lane l's
// chunk j holds d = (j * 32 + l) * VEC .. + VEC - 1, D % VEC == 0.
template <typename I, typename O, int VEC>
__global__ void __launch_bounds__(WARP * WARPS)
    append_kernel(Rows r) {
  constexpr int CH = MAX_D / (WARP * VEC);
  const int lane = threadIdx.x % WARP;
  const long long bth = (long long)r.B * r.T * r.H;
  const long long w = (long long)blockIdx.x * WARPS + threadIdx.x / WARP;
  if (w >= 2 * bth) return;                     // the whole warp
  const int which = w >= bth;
  const long long row = w - which * bth;
  const int h = (int)(row % r.H);
  const int t = (int)(row / r.H % r.T);
  const int b = (int)(row / ((long long)r.H * r.T));
  const int pos = r.pos[b] + t;
  // the wrapper refuses a write past the end on the host; never write
  // outside the cache all the same
  if (pos < 0 || pos >= r.S) return;            // the whole warp
  const long long* sd = r.stride[which];
  const I* src = static_cast<const I*>(r.src[which]) + b * sd[0] +
                 t * sd[1] + h * sd[2];
  const int D = r.D;

  float x[CH * VEC];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int d0 = (j * WARP + lane) * VEC;
    if (d0 < D) {
      if constexpr (VEC == 1) {
        x[j] = widen(src[d0 * sd[3]]);
      } else {
        static_assert(VEC * sizeof(I) == 16, "16-byte loads");
        const uint4 u = *reinterpret_cast<const uint4*>(src + d0);
        const I* e = reinterpret_cast<const I*>(&u);
#pragma unroll
        for (int i = 0; i < VEC; ++i) x[j * VEC + i] = widen(e[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[j * VEC + i] = 0.f;
    }
  }

  const long long at = ((long long)b * r.H + h) * r.S + pos;
  O* dst = static_cast<O*>(r.dst[which]) + at * D;
  float scale = 1.f;
  if constexpr (sizeof(O) == 1) {
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < CH * VEC; ++i) amax = fmaxf(amax, fabsf(x[i]));
#pragma unroll
    for (int o = WARP / 2; o; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
    if (lane == 0) r.scale[which][at] = scale;
  }
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int d0 = (j * WARP + lane) * VEC;
    if (d0 >= D) continue;
    alignas(16) O o[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float y = x[j * VEC + i];
      if constexpr (sizeof(O) == 1)
        y = fminf(fmaxf(rintf(__fdiv_rn(y, scale)), -127.f), 127.f);
      o[i] = narrow<O>(y);
    }
    store<O, VEC>(dst + d0, o);
  }
}

template <typename I, typename O>
cudaError_t launch_out(const Rows& r, bool vec, cudaStream_t st) {
  const long long warps = 2LL * r.B * r.T * r.H;
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  if (vec)
    append_kernel<I, O, 16 / sizeof(I)><<<blocks, WARP * WARPS, 0, st>>>(r);
  else
    append_kernel<I, O, 1><<<blocks, WARP * WARPS, 0, st>>>(r);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p % (uintptr_t)bytes) == 0;
}

template <typename I>
cudaError_t launch_in(const Rows& r, int out_kind, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(I);
  const int out_size = out_kind == OUT_I8 ? 1 : out_kind == OUT_BF16 ? 2 : 4;
  const int out_word = VEC * out_size < 16 ? VEC * out_size : 16;
  // 16-byte loads need every row start 16-byte aligned and a unit d
  // stride; the stores need the cache's base at their word width
  bool vec = r.D % VEC == 0;
  for (int i = 0; i < 2; ++i) {
    const long long* s = r.stride[i];
    vec = vec && s[3] == 1 && s[0] % VEC == 0 && s[1] % VEC == 0 &&
          s[2] % VEC == 0 && aligned(r.src[i], 16) &&
          aligned(r.dst[i], out_word);
  }
  switch (out_kind) {
    case OUT_I8: return launch_out<I, int8_t>(r, vec, st);
    case OUT_BF16: return launch_out<I, __nv_bfloat16>(r, vec, st);
    case OUT_F32: return launch_out<I, float>(r, vec, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace kva
}  // namespace

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// k, v (B, T, H, D) bf16 (in_bf16) or f32, on the device, read through
// their element strides (ks*: k's, vs*: v's, per b, t, h, d); kc, vc one
// layer's (B, H, S, D) cache, contiguous: int8 codes (out_kind 0), raw
// bf16 (1) or f32 (2) values; ksc, vsc the layer's (B, H, S) f32 scales,
// written only for codes (null otherwise); pos (B,) int32 on the device,
// each sequence's first write position, pos[b] + T <= S (positions past
// the end are not written). 1 <= D <= 256, B, T, H >= 1 (else
// cudaErrorInvalidValue). Launches on stream, does not synchronise;
// returns a cudaError_t.
int kv_append(const void* k, const void* v, int in_bf16, long long ksb,
              long long kst, long long ksh, long long ksd, long long vsb,
              long long vst, long long vsh, long long vsd, void* kc,
              void* vc, float* ksc, float* vsc, int out_kind,
              const int* pos, int B, int T, int H, int S, int D,
              void* stream) {
  if (D < 1 || D > kva::MAX_D || B < 1 || T < 1 || H < 1 || S < 1 ||
      out_kind < 0 || out_kind > 2 ||
      (out_kind == kva::OUT_I8 && (!ksc || !vsc)))
    return (int)cudaErrorInvalidValue;
  kva::Rows r = {{k, v},
                 {{ksb, kst, ksh, ksd}, {vsb, vst, vsh, vsd}},
                 {kc, vc},
                 {ksc, vsc},
                 pos, B, T, H, S, D};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(in_bf16 ? kva::launch_in<__nv_bfloat16>(r, out_kind, st)
                       : kva::launch_in<float>(r, out_kind, st));
}

}  // extern "C"
