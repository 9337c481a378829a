// K7 and K2's decode regime: causal attention of up to 16 queries against
// one layer's INT8 KV cache, hand-written for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel
// ant_quantization_tpu/kernels/attention.py:int8_kv_attention (_kernel),
// which the reference engine takes for T <= 16 queries on a flat cache when
// one head's cache no longer fits its tile budget: the long-context decode.
// K2's wrapper (kernels/attention.py:stacked_int8_kv_attention) launches
// it too, on layer l of the stacked cache, for T <= 16.
//
// What bounds it: the cache read (4 MB per head at 16,384 positions).
// Design: the positions split across blocks, a partial online softmax per
// block, and a second kernel that combines the splits in a fixed order;
// both passes are in kv_split.cuh. Both wrappers send more than 16
// queries to the prefill kernel of int8_kv_attention.cu.

#include "kv_split.cuh"

namespace {
namespace kvsplit {

// Both passes on one layer's (B, H, S, D) cache; n_split = ceil(S / span)
// splits of scratch. 1 <= T <= 16, span a multiple of KT, 1 <= D <= 256
// (the largest of KV_WIDTHS).
cudaError_t launch(const void* q, int q_bf16, const int8_t* kc,
                   const int8_t* vc, const float* ks, const float* vs,
                   const int* pos0, const float* slopes, float* part_o,
                   float* part_m, float* part_l, void* out, int out_bf16,
                   int B, int H, int T, int S, int D, int span, float qscale,
                   cudaStream_t st) {
  if (T < 1 || T > MAX_T || span < KT || span % KT || D < 1)
    return cudaErrorInvalidValue;
#define KVSPLIT_W(WW)                                                        \
  if (D <= WW)                                                               \
    return launch_w<WW>(q, q_bf16, kc, vc, ks, vs, pos0, slopes, part_o,     \
                        part_m, part_l, out, out_bf16, B, H, T, S, D, span,  \
                        qscale, st);
  KV_WIDTHS(KVSPLIT_W)
#undef KVSPLIT_W
  return cudaErrorInvalidValue;
}

}  // namespace kvsplit
}  // namespace

extern "C" {

const char* aq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q (B, H, T, D) f32, or bf16 when q_bf16, 1 <= T <= 16; kc, vc (B, H, S,
// D) int8; ks, vs (B, H, S) f32; pos0 (B,) int32; slopes (H,) f32 or null
// (no ALiBi); scratch part_o (B, H, n_split, T, D) f32 and part_m,
// part_l (B, H, n_split, T) f32 with n_split = ceil(S / span); out (B, H,
// T, D) bf16 or f32. All on the device, contiguous; 1 <= D <= 256 (any
// other: cudaErrorInvalidValue); span a multiple of 64. Returns a
// cudaError_t.
int int8_kv_attention_split(const void* q, int q_bf16, const int8_t* kc,
                            const int8_t* vc, const float* ks,
                            const float* vs, const int* pos0,
                            const float* slopes, float* part_o,
                            float* part_m, float* part_l, void* out,
                            int out_bf16, int B, int H, int T, int S, int D,
                            int span, float qscale, void* stream) {
  return (int)kvsplit::launch(q, q_bf16, kc, vc, ks, vs, pos0, slopes,
                              part_o, part_m, part_l, out, out_bf16, B, H, T,
                              S, D, span, qscale, (cudaStream_t)stream);
}

}  // extern "C"
