// The IPA attention core of the fused-layer kernel's float32 path
// (ipa_fused_layer.cu, its only user) on the CUDA cores: for RB query rows
// of one (design, head), the augmented logits, the bias, the float32
// softmax, the attention weights written in the compute dtype, and the two
// weighted sums.  The caller owns the shared-memory operands and the
// epilogue.  The attention-core kernel (ipa_attention.cu) runs on the
// tensor cores instead (ipa_attention_tc.cuh), float32 as 3xTF32, which is
// where the fused layer's float32 path is to move next.
//
//   qa    FA x L   augmented q, [feature][row], values in the compute dtype
//   ka    FA x L   augmented k, [feature][key], values in the compute dtype
//   va    L x FV   [v_s | v_p], [key][feature], values in the compute dtype
//   arow  RB x L   this warp's scratch for its rows' rounded weights
//
// Each lane holds keys lane + 32 k of every row, so one shared-memory read
// of a key or value operand feeds RB rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace ipa {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the value a cast to the compute dtype leaves
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

constexpr int MAX_L = 128;
constexpr int MAX_FV = 64;  // ds + 3 p: two value columns per lane
constexpr int RB = 4;       // query rows per warp at a time

// Rows i0 .. i0 + RB - 1 (those < L) of one (design, head): writes their
// attention weights to attn_h (L x L, row-major) and leaves in o[r][0..1]
// the weighted sums of value columns lane and lane + 32 (0 past FV).
template <typename T, typename TB>
__device__ __forceinline__ void attention_rows(
    const float* __restrict__ qa, const float* __restrict__ ka, int FA,
    const float* __restrict__ va, int FV, const TB* __restrict__ bias_h,
    T* __restrict__ attn_h, int L, float scale_total, int i0, int lane,
    float* __restrict__ arow, float (&o)[RB][2]) {
  float s[RB][MAX_L / 32];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int k = 0; k < MAX_L / 32; ++k) s[r][k] = 0.f;
  for (int f = 0; f < FA; ++f) {
    float q[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) q[r] = qa[(size_t)f * L + min(i0 + r, L - 1)];
#pragma unroll
    for (int k = 0; k < MAX_L / 32; ++k) {
      const int j = lane + 32 * k;
      const float kv = j < L ? ka[(size_t)f * L + j] : 0.f;
#pragma unroll
      for (int r = 0; r < RB; ++r) s[r][k] = fmaf(q[r], kv, s[r][k]);
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int i = i0 + r;
    if (i >= L) break;  // warp-uniform
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < MAX_L / 32; ++k) {
      const int j = lane + 32 * k;
      s[r][k] = j < L ? (s[r][k] + to_f<TB>(bias_h[(size_t)i * L + j])) * scale_total
                      : -INFINITY;
      m = fmaxf(m, s[r][k]);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_L / 32; ++k) {
      s[r][k] = lane + 32 * k < L ? expf(s[r][k] - m) : 0.f;
      sum += s[r][k];
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
    for (int k = 0; k < MAX_L / 32; ++k) {
      const int j = lane + 32 * k;
      if (j < L) {
        const T a = from_f<T>(s[r][k] / sum);
        attn_h[(size_t)i * L + j] = a;
        arow[r * L + j] = to_f<T>(a);
      }
    }
  }
  __syncwarp();
  // weighted sums: lane owns value columns lane and lane + 32
#pragma unroll
  for (int r = 0; r < RB; ++r) o[r][0] = o[r][1] = 0.f;
  const int c0 = lane, c1 = lane + 32;
  for (int j = 0; j < L; ++j) {
    const float v0 = c0 < FV ? va[(size_t)j * FV + c0] : 0.f;
    const float v1 = c1 < FV ? va[(size_t)j * FV + c1] : 0.f;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float a = arow[r * L + j];
      o[r][0] = fmaf(a, v0, o[r][0]);
      o[r][1] = fmaf(a, v1, o[r][1]);
    }
  }
}

}  // namespace ipa
