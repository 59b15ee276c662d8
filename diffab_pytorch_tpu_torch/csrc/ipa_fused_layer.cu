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
// Two designs, split by dtype:
//   bfloat16 (ipa_fused_layer_bf16.cuh): two launches, every product on the
//     tensor cores (mma.sync bf16 -> f32), which gives exactly the rounding
//     points above; the projections stay on chip and only the bf16 per-head
//     features cross device memory between the launches.
//   float32: three launches on the CUDA cores (the tensor cores would round
//     to TF32, which the float32 checks do not accept):
//     1. the Q/K/V projections of all b*L residue rows, f32 out;
//     2. attention_kernel: one block per (head, design) — frames, augmented
//        operands, logits, softmax, the attn write, weighted sums, inverse
//        frames and norms, per-head features (logits through weighted sums
//        are ipa::attention_rows, ipa_attention_core.cuh);
//     3. the three output projections as one [W_s; W_p; W_n] product.
//
// What bounds it on this card: at the main sampling shapes (b=128, L=128,
// d=128, h=8, ds=32, pq=pv=8) the layer is ~11.6 GFLOP and ~43 MB of
// compulsory traffic, about 12 us at the H100's bf16 tensor-core peak and
// 13 us at its HBM rate — balanced, so only tensor cores and on-chip reuse
// reach the bound.  The bf16 design does both: one block per (head,
// design) computes its projection from x and the head's weight columns
// (read from L2 by the h blocks of a design), keeps the 16 x L logits of
// each warp in registers, feeds the rounded weights to the second product
// from registers, and writes only attn (compulsory) and the bf16 features
// (16.8 MB at b=128, read back by the output GEMM).  It is bound by
// latency inside each block, not by the tensor cores or the bytes (the
// header says where the cycles go); mma.sync rather than wgmma, and the
// feature round trip (a cluster reduction of the output projection would
// remove it) are the other things it leaves on the table.  The float32
// path keeps the first design: the attention core on the CUDA cores and the
// projections staged through device memory.
//
// Limits: L <= 128, ds + 3 P <= 64 (both paths); for these every d and h
// fit the shared memory a block may use (227 KB): at most ~167 KB for the
// bf16 path (layer_dims) and ~190 KB for the float32 attention kernel
// (attention_smem_floats).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ipa_attention_core.cuh"
#include "ipa_fused_layer_bf16.cuh"

#include <cmath>
#include <initializer_list>

namespace {

using ipa::from_f;
using ipa::MAX_FV;
using ipa::MAX_L;
using ipa::RB;
using ipa::round_t;
using ipa::to_f;

// ---------------------------------------------------------------------------
// C[M, N] = A[M, K] @ B[K, N], row-major, f32 accumulation.  64x64 tiles,
// 16-deep K slices in shared memory, 256 threads with a 4x4 register tile
// each (rows ty + 16 i, columns tx + 16 j: conflict-free shared reads).
// ---------------------------------------------------------------------------
constexpr int GBM = 64, GBN = 64, GBK = 16, GEMM_THREADS = 256;

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
            TOut* __restrict__ C, int M, int N, int K) {
  __shared__ float As[GBK][GBM + 4];
  __shared__ float Bs[GBK][GBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * GBM, col0 = blockIdx.x * GBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GBK) {
    for (int e = tid; e < GBM * GBK; e += GEMM_THREADS) {
      const int r = e / GBK, kk = e % GBK, gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? to_f<TIn>(A[(size_t)gr * K + gk]) : 0.f;
    }
    for (int e = tid; e < GBK * GBN; e += GEMM_THREADS) {
      const int kk = e / GBN, c = e % GBN, gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < N) ? to_f<TIn>(B[(size_t)gk * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) C[(size_t)r * N + c] = from_f<TOut>(acc[i][j]);
    }
  }
}

// C = A @ B on the caller's stream (the float32 path: float32-exact products)
template <typename T, typename TOut>
cudaError_t launch_gemm(const T* A, const T* B, TOut* C, int M, int N, int K,
                        cudaStream_t stream) {
  gemm_kernel<T, TOut><<<dim3((N + GBN - 1) / GBN, (M + GBM - 1) / GBM), GEMM_THREADS, 0,
                         stream>>>(A, B, C, M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Attention for one (head, design): everything between the projections and
// the output projection.  Shared memory (floats):
//   raw   L x FV      one of the q/k/v column groups of this head, f32
//   qa    FA x L      augmented q, [feature][row], T-rounded
//   ka    FA x L      augmented k, [feature][key], T-rounded
//   va    L x FV      [v_s | v_p], [key][feature], T-rounded
//   rs    L x 9       rotations R[i][c] at 3 i + c
//   ts    L x 3       translations (T values)
//   nks   L           key-mask term
//   rows  warps x RB x (L + FV)  per-warp attention rows and weighted sums
//                     (the per-point |p|^2 partials while projecting)
// Each warp takes RB query rows at a time, so every key operand read from
// shared memory feeds RB rows.
// ---------------------------------------------------------------------------
constexpr int ATT_THREADS = 512;
constexpr int ATT_WARPS = ATT_THREADS / 32;

__host__ __device__ inline size_t attention_smem_floats(int L, int ds, int p) {
  const int FV = ds + 3 * p, FA = FV + 3;
  return (size_t)L * FV * 2 + (size_t)FA * L * 2 + (size_t)L * 13 +
         (size_t)ATT_WARPS * RB * (L + FV);
}

template <typename T, typename TB>
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const float* __restrict__ proj,  // (b, L, 3 Fq)
                 const T* __restrict__ rot,       // (b, L, 3, 3)
                 const T* __restrict__ trans,     // (b, L, 3)
                 const T* __restrict__ mask,      // (b, L)
                 const float* __restrict__ g,     // (h,)
                 const TB* __restrict__ bias,     // (bp, h, L, L)
                 T* __restrict__ feat,            // (b, L, h (ds + 4 p))
                 T* __restrict__ attn,            // (b, h, L, L)
                 int L, int h, int ds, int p, int n_designs,
                 float scale_total, float nk_scale) {
  const int hh = blockIdx.x, design = blockIdx.y, target = design / n_designs;
  const int FV = ds + 3 * p, FA = FV + 3;
  const int Fq = h * FV, FEAT = h * (ds + 4 * p);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  extern __shared__ float smem[];
  float* raw = smem;
  float* qa = raw + (size_t)L * FV;
  float* ka = qa + (size_t)FA * L;
  float* va = ka + (size_t)FA * L;
  float* rs = va + (size_t)L * FV;
  float* ts = rs + (size_t)L * 9;
  float* nks = ts + (size_t)L * 3;
  float* rows = nks + L;

  const size_t row_base = (size_t)design * L;
  for (int e = tid; e < L * 9; e += ATT_THREADS) rs[e] = to_f<T>(rot[row_base * 9 + e]);
  for (int e = tid; e < L * 3; e += ATT_THREADS) ts[e] = to_f<T>(trans[row_base * 3 + e]);
  for (int l = tid; l < L; l += ATT_THREADS)
    nks[l] = round_t<T>((to_f<T>(mask[row_base + l]) - 1.f) * nk_scale);
  const float g_t = round_t<T>(g[hh]);

  // ---- q, k, v of this head for all L rows --------------------------------
  float* sq_part = rows;  // L x p partial |point|^2, free until the rows phase
  for (int part = 0; part < 3; ++part) {
    __syncthreads();  // raw is free again (and rs/ts/nks are loaded)
    for (int e = tid; e < L * FV; e += ATT_THREADS) {
      const int l = e / FV, c = e % FV;
      const int col = c < ds ? hh * ds + c : h * ds + hh * 3 * p + (c - ds);
      raw[e] = proj[(row_base + l) * (3 * Fq) + part * Fq + col];
    }
    __syncthreads();
    // scalar columns, rounded to T
    for (int e = tid; e < L * ds; e += ATT_THREADS) {
      const int l = e / ds, c = e % ds;
      const float v = round_t<T>(raw[(size_t)l * FV + c]);
      if (part == 0) qa[(size_t)c * L + l] = v;
      else if (part == 1) ka[(size_t)c * L + l] = v;
      else va[(size_t)l * FV + c] = v;
    }
    // point columns through the frames, p @ R + t (g folded in for q/k)
    for (int e = tid; e < L * p; e += ATT_THREADS) {
      const int l = e / p, pp = e % p;
      const float* P = raw + (size_t)l * FV + ds;
      const float* R = rs + l * 9;
      float sq = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float t = part < 2 ? round_t<T>(ts[l * 3 + c] * g_t) : ts[l * 3 + c];
        const float v = P[pp] * R[c] + P[p + pp] * R[3 + c] + P[2 * p + pp] * R[6 + c] + t;
        sq += v * v;
        const int f = ds + c * p + pp;
        if (part == 0) qa[(size_t)f * L + l] = round_t<T>(2.f * v);
        else if (part == 1) ka[(size_t)f * L + l] = round_t<T>(v);
        else va[(size_t)l * FV + f] = round_t<T>(v);
      }
      sq_part[e] = sq;
    }
    if (part == 2) continue;
    __syncthreads();
    for (int l = tid; l < L; l += ATT_THREADS) {
      float sq = 0.f;
      for (int pp = 0; pp < p; ++pp) sq += sq_part[l * p + pp];
      if (part == 0) {
        qa[(size_t)FV * L + l] = round_t<T>(-sq);
        qa[(size_t)(FV + 1) * L + l] = -1.f;
        qa[(size_t)(FV + 2) * L + l] = 1.f;
      } else {
        ka[(size_t)FV * L + l] = 1.f;
        ka[(size_t)(FV + 1) * L + l] = round_t<T>(sq);
        ka[(size_t)(FV + 2) * L + l] = nks[l];
      }
    }
  }
  __syncthreads();

  // ---- RB query rows per warp at a time -------------------------------------
  float* arow = rows + (size_t)warp * RB * (L + FV);  // RB x L
  float* orow = arow + RB * L;                         // RB x FV
  const TB* bias_h = bias + ((size_t)target * h + hh) * L * L;
  T* attn_h = attn + ((size_t)design * h + hh) * L * L;
  for (int i0 = warp * RB; i0 < L; i0 += ATT_WARPS * RB) {
    float o[RB][2];
    ipa::attention_rows<T, TB>(qa, ka, FA, va, FV, bias_h, attn_h, L, scale_total, i0,
                               lane, arow, o);
    const int c0 = lane, c1 = lane + 32;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (c0 < FV) orow[r * FV + c0] = o[r][0];
      if (c1 < FV) orow[r * FV + c1] = o[r][1];
    }
    __syncwarp();
    for (int r = 0; r < RB; ++r) {
      const int i = i0 + r;
      if (i >= L) break;
      const float* orr = orow + r * FV;
      T* frow = feat + (row_base + i) * FEAT;
      for (int e = lane; e < ds; e += 32) frow[hh * ds + e] = from_f<T>(orr[e]);
      const float* R = rs + i * 9;
      for (int pp = lane; pp < p; pp += 32) {
        float dd[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) dd[k] = orr[ds + k * p + pp] - ts[i * 3 + k];
        float nrm = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float loc = dd[0] * R[3 * c] + dd[1] * R[3 * c + 1] + dd[2] * R[3 * c + 2];
          nrm += loc * loc;
          frow[h * ds + hh * 3 * p + c * p + pp] = from_f<T>(loc);
        }
        frow[h * ds + h * 3 * p + hh * p + pp] = from_f<T>(sqrtf(nrm + 1e-8f));
      }
    }
    __syncwarp();
  }
}

int run_f32(const void* x, const void* rot, const void* trans, const void* mask,
            const void* w_qkv, const void* w_out, const float* g, const void* bias,
            float* proj, void* feat, void* acc, void* attn, int b, int bp, int L, int d,
            int h, int ds, int p, float scale_total, float nk_scale, cudaStream_t stream) {
  using T = float;
  using TB = float;
  const int M = b * L, Fq = h * (ds + 3 * p), FEAT = h * (ds + 4 * p);
  cudaError_t err = launch_gemm<T, float>(static_cast<const T*>(x),
                                          static_cast<const T*>(w_qkv), proj, M,
                                          3 * Fq, d, stream);
  if (err != cudaSuccess) return err;

  const size_t smem = attention_smem_floats(L, ds, p) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(attention_kernel<T, TB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  attention_kernel<T, TB><<<dim3(h, b), ATT_THREADS, smem, stream>>>(
      proj, static_cast<const T*>(rot), static_cast<const T*>(trans),
      static_cast<const T*>(mask), g, static_cast<const TB*>(bias),
      static_cast<T*>(feat), static_cast<T*>(attn), L, h, ds, p, b / bp,
      scale_total, nk_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  return launch_gemm<T, T>(static_cast<const T*>(feat), static_cast<const T*>(w_out),
                           static_cast<T*>(acc), M, d, FEAT, stream);
}

template <typename TB>
int run_bf16(const void* x, const void* rot, const void* trans, const void* mask,
             const void* w_qkv_heads, const void* w_out_heads, const float* g,
             const void* bias, void* feat, void* acc, void* attn, int b, int bp, int L,
             int d, int h, int ds, int p, float scale_total, float nk_scale,
             cudaStream_t stream) {
  using tc::bf16;
  const tc::Dims D = tc::layer_dims(L, d, h, ds, p);
  cudaError_t err = cudaFuncSetAttribute(tc::layer_heads_kernel<TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, D.total);
  if (err != cudaSuccess) return err;
  const int x_vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  tc::layer_heads_kernel<TB><<<dim3(h, b), tc::THREADS, D.total, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(rot),
      static_cast<const bf16*>(trans), static_cast<const bf16*>(mask),
      static_cast<const bf16*>(w_qkv_heads), g, static_cast<const TB*>(bias),
      static_cast<bf16*>(feat), static_cast<bf16*>(attn), D, b / bp, scale_total, nk_scale,
      x_vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int M = b * L, NP = tc::round_up(d, 8);
  tc::out_proj_kernel<<<dim3((NP + tc::GN - 1) / tc::GN, (M + tc::GM - 1) / tc::GM),
                        tc::G_THREADS, 0, stream>>>(
      static_cast<const bf16*>(feat), static_cast<const bf16*>(w_out_heads),
      static_cast<bf16*>(acc), M, d, NP, h * D.FH);
  return cudaGetLastError();
}

bool shape_ok(int b, int bp, int L, int d, int h, int ds, int p) {
  return L >= 1 && L <= MAX_L && bp >= 1 && b % bp == 0 && d >= 1 && h >= 1 && ds >= 1 &&
         p >= 1 && ds + 3 * p <= MAX_FV;
}

}  // namespace

extern "C" {

// The float32 layer.  Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for shapes the kernel does not take.
int ipa_fused_layer_forward(const void* x, const void* rot, const void* trans,
                            const void* mask, const void* w_qkv, const void* w_out,
                            const float* g, const void* bias, float* proj, void* feat,
                            void* acc, void* attn, int b, int bp, int L, int d, int h, int ds,
                            int p, float scale_total, float nk_scale, void* stream) {
  if (!shape_ok(b, bp, L, d, h, ds, p)) return cudaErrorInvalidValue;
  if (attention_smem_floats(L, ds, p) * sizeof(float) > 232448) return cudaErrorInvalidValue;
  return run_f32(x, rot, trans, mask, w_qkv, w_out, g, bias, proj, feat, acc, attn, b, bp, L,
                 d, h, ds, p, scale_total, nk_scale, static_cast<cudaStream_t>(stream));
}

// The bfloat16 layer on the head-major weights; bias_dtype 0 = float32,
// 1 = bfloat16.  feat is (b L, h FH) bf16 scratch.
int ipa_fused_layer_forward_bf16(int bias_dtype, const void* x, const void* rot,
                                 const void* trans, const void* mask, const void* w_qkv_heads,
                                 const void* w_out_heads, const float* g, const void* bias,
                                 void* feat, void* acc, void* attn, int b, int bp, int L, int d,
                                 int h, int ds, int p, float scale_total, float nk_scale,
                                 void* stream) {
  if (!shape_ok(b, bp, L, d, h, ds, p)) return cudaErrorInvalidValue;
  if (tc::layer_dims(L, d, h, ds, p).total > 232448) return cudaErrorInvalidValue;
  for (const void* t : {w_qkv_heads, w_out_heads, static_cast<const void*>(feat)})
    if (reinterpret_cast<uintptr_t>(t) % 16) return cudaErrorMisalignedAddress;  // cp.async
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias_dtype == 1)
    return run_bf16<__nv_bfloat16>(x, rot, trans, mask, w_qkv_heads, w_out_heads, g, bias,
                                   feat, acc, attn, b, bp, L, d, h, ds, p, scale_total,
                                   nk_scale, s);
  if (bias_dtype == 0)
    return run_bf16<float>(x, rot, trans, mask, w_qkv_heads, w_out_heads, g, bias, feat, acc,
                           attn, b, bp, L, d, h, ds, p, scale_total, nk_scale, s);
  return cudaErrorInvalidValue;
}

const char* ipa_fused_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
