// IPA attention core for Hopper (sm_90a), float32 and bfloat16.
//
// Replaces the TPU kernel diffab_pytorch_tpu/ops/ipa_pallas.py _kernel
// (launched by _pallas_raw through fused_ipa_attention_raw and
// fused_ipa_attention).  It takes the augmented operands that the caller
// assembles outside the kernel, as the JAX wrapper does, and computes for
// every (design, head) g of b designs that share bp = b / n_designs
// per-target bias blocks:
//
//   logit[i, j] = (sum_f q_aug[g, f, i] k_aug[g, f, j] + bias[g / n, i, j])
//                 * scale_total                            (f32 accumulation)
//   attn = softmax_j(logit) in float32, written in T
//   out_s[g, c, i] = sum_j v_s[g, c, j] attn[i, j]          (T operands)
//   out_p[g, c, i] = sum_j v_p[g, c, j] attn[i, j]
//
// Padded keys carry -1e9 / scale_total in a key row of the augmented
// operands, so they get exactly 0 weight without a mask input.
//
// What bounds it on this card: at the training shape (b = bp = 32, L = 128,
// h = 8, F = 64, ds = 32, 3P = 24, bf16) one call is ~1.0 GFLOP against
// ~32.5 MB of compulsory traffic, and at the sampling shape (b = 128,
// bp = 1) ~4 GFLOP against ~97 MB: bytes-bound at both (~10 and ~29 us at
// the HBM rate).  This first design reads every operand of one (design,
// head) into shared memory once, so each input byte crosses device memory
// once, and keeps the logits of a warp's RB rows in registers; the products
// run on the CUDA cores (ipa::attention_rows, shared with the fused-layer
// kernel).  The outputs are staged in shared memory and written coalesced.
// Tensor-core tiles and more than one block per SM are later work.
//
// Limits: L <= 128, ds + 3 P <= 64, and the block's shared memory
// (smem_floats) within the 227 KB a block may use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ipa_attention_core.cuh"

namespace {

using ipa::from_f;
using ipa::MAX_FV;
using ipa::MAX_L;
using ipa::RB;
using ipa::to_f;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

// qa, ka (F x L), va (L x FV), the output tile (FV x (L + 1)), and the
// warps' rows (WARPS x RB x L)
__host__ __device__ inline size_t smem_floats(int L, int F, int FV) {
  return (size_t)F * L * 2 + (size_t)L * FV + (size_t)FV * (L + 1) +
         (size_t)WARPS * RB * L;
}

template <typename T, typename TB>
__global__ void __launch_bounds__(THREADS)
ipa_attention_kernel(const T* __restrict__ q_aug,  // (b, h, F, L)
                     const T* __restrict__ k_aug,  // (b, h, F, L)
                     const T* __restrict__ v_s,    // (b, h, ds, L)
                     const T* __restrict__ v_p,    // (b, h, 3P, L)
                     const TB* __restrict__ bias,  // (bp, h, L, L)
                     T* __restrict__ out_s,        // (b, h, ds, L)
                     T* __restrict__ out_p,        // (b, h, 3P, L)
                     T* __restrict__ attn,         // (b, h, L, L)
                     int L, int h, int F, int ds, int p3, int n_designs,
                     float scale_total) {
  const int hh = blockIdx.x, design = blockIdx.y, target = design / n_designs;
  const int FV = ds + p3, LO = L + 1;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t g = (size_t)design * h + hh;

  extern __shared__ float smem[];
  float* qa = smem;
  float* ka = qa + (size_t)F * L;
  float* va = ka + (size_t)F * L;
  float* ot = va + (size_t)L * FV;
  float* rows = ot + (size_t)FV * LO;

  const T* q_g = q_aug + g * F * L;
  const T* k_g = k_aug + g * F * L;
  for (int e = tid; e < F * L; e += THREADS) {
    qa[e] = to_f<T>(q_g[e]);
    ka[e] = to_f<T>(k_g[e]);
  }
  const T* vs_g = v_s + g * ds * L;
  for (int e = tid; e < ds * L; e += THREADS) va[(e % L) * FV + e / L] = to_f<T>(vs_g[e]);
  const T* vp_g = v_p + g * p3 * L;
  for (int e = tid; e < p3 * L; e += THREADS)
    va[(e % L) * FV + ds + e / L] = to_f<T>(vp_g[e]);
  __syncthreads();

  float* arow = rows + (size_t)warp * RB * L;
  const TB* bias_h = bias + ((size_t)target * h + hh) * L * L;
  T* attn_h = attn + g * L * L;
  for (int i0 = warp * RB; i0 < L; i0 += WARPS * RB) {
    float o[RB][2];
    ipa::attention_rows<T, TB>(qa, ka, F, va, FV, bias_h, attn_h, L, scale_total, i0,
                               lane, arow, o);
    const int c0 = lane, c1 = lane + 32;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = i0 + r;
      if (i >= L) break;  // warp-uniform
      if (c0 < FV) ot[(size_t)c0 * LO + i] = o[r][0];
      if (c1 < FV) ot[(size_t)c1 * LO + i] = o[r][1];
    }
    __syncwarp();  // arow is rewritten by the next rows
  }
  __syncthreads();

  T* os_g = out_s + g * ds * L;
  for (int e = tid; e < ds * L; e += THREADS)
    os_g[e] = from_f<T>(ot[(size_t)(e / L) * LO + e % L]);
  T* op_g = out_p + g * p3 * L;
  for (int e = tid; e < p3 * L; e += THREADS)
    op_g[e] = from_f<T>(ot[(size_t)(ds + e / L) * LO + e % L]);
}

template <typename T, typename TB>
int run(const void* q_aug, const void* k_aug, const void* v_s, const void* v_p,
        const void* bias, void* out_s, void* out_p, void* attn, int b, int bp, int L,
        int h, int F, int ds, int p3, float scale_total, cudaStream_t stream) {
  const size_t smem = smem_floats(L, F, ds + p3) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ipa_attention_kernel<T, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  ipa_attention_kernel<T, TB><<<dim3(h, b), THREADS, smem, stream>>>(
      static_cast<const T*>(q_aug), static_cast<const T*>(k_aug),
      static_cast<const T*>(v_s), static_cast<const T*>(v_p),
      static_cast<const TB*>(bias), static_cast<T*>(out_s), static_cast<T*>(out_p),
      static_cast<T*>(attn), L, h, F, ds, p3, b / bp, scale_total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype / bias_dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t
// (0 on success); cudaErrorInvalidValue for shapes the kernel does not take.
int ipa_attention_forward(int dtype, int bias_dtype, const void* q_aug, const void* k_aug,
                          const void* v_s, const void* v_p, const void* bias, void* out_s,
                          void* out_p, void* attn, int b, int bp, int L, int h, int F,
                          int ds, int p3, float scale_total, void* stream) {
  if (L < 1 || L > MAX_L || bp < 1 || b % bp != 0 || h < 1 || F < 1 || ds < 0 || p3 < 0 ||
      ds + p3 < 1 || ds + p3 > MAX_FV)
    return cudaErrorInvalidValue;
  if (smem_floats(L, F, ds + p3) * sizeof(float) > 232448) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && bias_dtype == 0)
    return run<float, float>(q_aug, k_aug, v_s, v_p, bias, out_s, out_p, attn, b, bp, L, h,
                             F, ds, p3, scale_total, s);
  if (dtype == 1 && bias_dtype == 1)
    return run<__nv_bfloat16, __nv_bfloat16>(q_aug, k_aug, v_s, v_p, bias, out_s, out_p,
                                             attn, b, bp, L, h, F, ds, p3, scale_total, s);
  if (dtype == 1 && bias_dtype == 0)
    return run<__nv_bfloat16, float>(q_aug, k_aug, v_s, v_p, bias, out_s, out_p, attn, b,
                                     bp, L, h, F, ds, p3, scale_total, s);
  return cudaErrorInvalidValue;
}

const char* ipa_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
