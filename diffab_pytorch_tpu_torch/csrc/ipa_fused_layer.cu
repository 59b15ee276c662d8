// Fused IPA layer forward for Hopper (sm_90a), float32 and bfloat16.
//
// Replaces the TPU kernel diffab_pytorch_tpu/ops/ipa_pallas.py
// _layer_kernel_batched / _layer_kernel (launched by _pallas_layer through
// fused_ipa_layer).  One call computes one whole IPA layer for b designs
// that share bp = b / n_designs per-target pair-bias blocks:
//
//   proj  = x @ [wq | wk | wv]                       (f32 accumulation)
//   q, k  = frames p @ R + t with g folded into the point columns and t
//   q_aug = [q_s | 2 q_p | -|q_p|^2 | -1 | 1]        (rounded to T)
//   k_aug = [k_s |   k_p |  1 | |k_p|^2 | key mask]  (rounded to T)
//   logit = (q_aug . k_aug + bias) * scale_total; attn = softmax (f32)
//   attn is written in T; out_s = attn v_s, out_p = attn v_p (T operands)
//   loc = (out_p - t) @ R^T, nrm = sqrt(|loc|^2 + 1e-8)
//   acc = [out_s | loc | nrm] (rounded to T) @ [W_s; W_p; W_n]
//
// The rounding points are the Pallas kernel's: the augmented operands, the
// attention weights and the output-projection operands are cast to the
// compute dtype T, everything else stays in float.
//
// One design in two product routes, by dtype, both on the tensor cores with
// mma.sync, both reading the head-major weights of ops/ipa_fused_layer.py
// pack_layer_weights (w_qkv (h, d, 3 FVP): per head and input row
// [q | k | v], each [scalar (ds) | points (3, P) | 0 pad]; w_out (h FH, dP):
// per head the rows [W_s (ds) | W_p (3, P) | W_n (P) | 0 pad], columns
// padded to dP = d rounded up to 8):
//   1. layer_heads_kernel, one block of 8 warps per (head, design): the
//      head's Q/K/V projection from x and the head's weight columns in
//      K-slices by cp.async, kept on chip; frames, g folding and point
//      norms into the augmented operand tiles; each warp's 16 x L logits
//      and float32 softmax in registers (keys >= L exactly 0); attn
//      written in T; the weighted sums from register fragments; inverse
//      frames and norms into head-major features feat (b L, h FH) in T.
//   2. out_proj_kernel: acc = feat @ w_out, a cp.async double-buffered
//      tensor-core GEMM.
//   bfloat16 (ipa_fused_layer_bf16.cuh): mma.sync m16n8k16, bf16 operands
//     and f32 accumulation, which gives exactly the rounding points above.
//   float32 (ipa_fused_layer_f32.cuh): 3xTF32 on mma.sync m16n8k8, every
//     product (projection, logits, weighted sums, output GEMM) as three
//     tf32 products of split operands, float32-exact to the 1e-4 checks;
//     its attention phases are the warp core of ipa_attention_tc.cuh.
//
// What bounds it on this card: at the main sampling shapes (b=128, L=128,
// d=128, h=8, ds=32, pq=pv=8) the layer is ~11.6 GFLOP.  In bf16 that is
// ~43 MB of compulsory traffic, about 12 us at the H100's bf16
// tensor-core peak and 13 us at its HBM rate: balanced, so only tensor
// cores and on-chip reuse reach the bound.  In float32 it is ~86 MB
// (26 us) against ~71 us of operations at the 3xTF32 rate (a third of
// the TF32 peak): bound by operations.  Both routes reuse on chip the
// same way: the projection never leaves the block, the logits and
// weights stay in registers, and only attn (compulsory) and the per-head
// features (read back by the output GEMM) are written.  Both are bound
// by latency inside each block, not by the tensor cores or the bytes:
// each block runs its phases (loads, projection, frames, logits, softmax,
// attn store, weighted sums, epilogue) one after another with barriers
// between them, with 16 warps per SM to hide the waits; the float32 route
// issues six times the mma.sync instructions of bf16 for the same tiles
// (k8 against k16, three products) and splits each operand it loads.
// mma.sync rather than wgmma, and the feature round trip (a cluster
// reduction of the output projection would remove it), are the other
// things both leave on the table.
//
// Limits: L <= 128, ds + 3 P <= 64; for these every d and h fit the
// shared memory a block may use (227 KB): at most ~167 KB for bf16 and
// ~120 KB for float32 (layer_dims of each header).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ipa_attention_tc.cuh"
#include "ipa_fused_layer_bf16.cuh"
#include "ipa_fused_layer_f32.cuh"

#include <initializer_list>

namespace {

int run_f32(const void* x, const void* rot, const void* trans, const void* mask,
            const void* w_qkv, const void* w_out, const float* g, const void* bias,
            void* feat, void* acc, void* attn, int b, int bp, int L, int d, int h, int ds,
            int p, float scale_total, float nk_scale, cudaStream_t stream) {
  const tf32x3::Dims D = tf32x3::layer_dims(L, d, h, ds, p);
  cudaError_t err = cudaFuncSetAttribute(tf32x3::layer_heads_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, D.total);
  if (err != cudaSuccess) return err;
  const int x_vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  tf32x3::layer_heads_kernel<<<dim3(h, b), tf32x3::THREADS, D.total, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(rot),
      static_cast<const float*>(trans), static_cast<const float*>(mask),
      static_cast<const float*>(w_qkv), g, static_cast<const float*>(bias),
      static_cast<float*>(feat), static_cast<float*>(attn), D, b / bp, scale_total, nk_scale,
      x_vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int M = b * L, NP = ptx::round_up(d, 8);
  tf32x3::out_proj_kernel<<<dim3((NP + tf32x3::GN - 1) / tf32x3::GN,
                                 (M + tf32x3::GM - 1) / tf32x3::GM),
                            tf32x3::G_THREADS, 0, stream>>>(
      static_cast<const float*>(feat), static_cast<const float*>(w_out),
      static_cast<float*>(acc), M, d, NP, h * D.FH);
  return cudaGetLastError();
}

template <typename TB>
int run_bf16(const void* x, const void* rot, const void* trans, const void* mask,
             const void* w_qkv, const void* w_out, const float* g, const void* bias,
             void* feat, void* acc, void* attn, int b, int bp, int L, int d, int h, int ds,
             int p, float scale_total, float nk_scale, cudaStream_t stream) {
  using ptx::bf16;
  const tc::Dims D = tc::layer_dims(L, d, h, ds, p);
  cudaError_t err = cudaFuncSetAttribute(tc::layer_heads_kernel<TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, D.total);
  if (err != cudaSuccess) return err;
  const int x_vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  tc::layer_heads_kernel<TB><<<dim3(h, b), tc::THREADS, D.total, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(rot),
      static_cast<const bf16*>(trans), static_cast<const bf16*>(mask),
      static_cast<const bf16*>(w_qkv), g, static_cast<const TB*>(bias),
      static_cast<bf16*>(feat), static_cast<bf16*>(attn), D, b / bp, scale_total, nk_scale,
      x_vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int M = b * L, NP = ptx::round_up(d, 8);
  tc::out_proj_kernel<<<dim3((NP + tc::GN - 1) / tc::GN, (M + tc::GM - 1) / tc::GM),
                        tc::G_THREADS, 0, stream>>>(
      static_cast<const bf16*>(feat), static_cast<const bf16*>(w_out),
      static_cast<bf16*>(acc), M, d, NP, h * D.FH);
  return cudaGetLastError();
}

bool shape_ok(int b, int bp, int L, int d, int h, int ds, int p) {
  return L >= 1 && L <= ipa_tc::MAX_L && bp >= 1 && b % bp == 0 && d >= 1 && h >= 1 &&
         ds >= 1 && p >= 1 && ds + 3 * p <= ipa_tc::MAX_FV;
}

}  // namespace

extern "C" {

// The layer on the head-major weights.  dtype / bias_dtype: 0 = float32,
// 1 = bfloat16 (float32 takes a float32 bias only).  feat is (b L, h FH)
// scratch in the compute dtype.  Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for shapes the kernel does not take.
int ipa_fused_layer_forward(int dtype, int bias_dtype, const void* x, const void* rot,
                            const void* trans, const void* mask, const void* w_qkv,
                            const void* w_out, const float* g, const void* bias, void* feat,
                            void* acc, void* attn, int b, int bp, int L, int d, int h, int ds,
                            int p, float scale_total, float nk_scale, void* stream) {
  if (!shape_ok(b, bp, L, d, h, ds, p)) return cudaErrorInvalidValue;
  for (const void* t : {w_qkv, w_out, static_cast<const void*>(feat)})
    if (reinterpret_cast<uintptr_t>(t) % 16) return cudaErrorMisalignedAddress;  // cp.async
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && bias_dtype == 0) {
    if (tf32x3::layer_dims(L, d, h, ds, p).total > 232448) return cudaErrorInvalidValue;
    return run_f32(x, rot, trans, mask, w_qkv, w_out, g, bias, feat, acc, attn, b, bp, L, d,
                   h, ds, p, scale_total, nk_scale, s);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  if (tc::layer_dims(L, d, h, ds, p).total > 232448) return cudaErrorInvalidValue;
  if (bias_dtype == 1)
    return run_bf16<__nv_bfloat16>(x, rot, trans, mask, w_qkv, w_out, g, bias, feat, acc,
                                   attn, b, bp, L, d, h, ds, p, scale_total, nk_scale, s);
  if (bias_dtype == 0)
    return run_bf16<float>(x, rot, trans, mask, w_qkv, w_out, g, bias, feat, acc, attn, b, bp,
                           L, d, h, ds, p, scale_total, nk_scale, s);
  return cudaErrorInvalidValue;
}

const char* ipa_fused_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
