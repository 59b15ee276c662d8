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
// Three launches on the caller's stream, none of them a library call:
//   1. the Q/K/V projections of all b*L residue rows, f32 out;
//   2. attention_kernel: one block per (head, design) — frames, augmented
//      operands, logits, softmax, the attn write, weighted sums, inverse
//      frames and norms, per-head features in T (logits through weighted
//      sums are ipa::attention_rows, shared with ipa_attention.cu);
//   3. the three output projections as one [W_s; W_p; W_n] product into acc.
// The two products run on the tensor cores (WMMA, float accumulation) for
// bfloat16 operands and on the CUDA cores for float32 ones.
//
// What bounds it on this card: at the main sampling shapes (b=128, L=128,
// d=128, h=8, ds=32, pq=pv=8) the layer is ~11.6 GFLOP and ~43 MB of
// compulsory traffic, about 12 us at the H100's bf16 tensor-core peak and
// 13 us at its HBM rate — balanced, so only tensor cores and on-chip reuse
// reach the bound.  This first design keeps the attention core (logits,
// softmax, weighted sums; a third of the FLOPs) on the CUDA cores, with each
// warp taking four query rows at a time so that one shared-memory read of a
// key or value operand feeds four rows, and stages the projections and the
// per-head features through device-memory scratch (proj, feat: ~105 MB of
// extra traffic per call at the main shapes).  Tensor-core
// tiles for the attention core and keeping proj/feat on chip are later work.
//
// Limits: L <= 128, ds + 3 P <= 64, and the attention block's shared memory
// (attention_smem_floats) within the 227 KB a block may use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "ipa_attention_core.cuh"

#include <cmath>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// bfloat16 operands: the same product on the tensor cores (WMMA 16x16x16,
// float accumulation).  64x64 block tiles, 32-deep K slices, four warps of
// 32x32 each; the tile is staged through shared memory for the bounds-
// checked, converting store.
// ---------------------------------------------------------------------------
constexpr int WBM = 64, WBN = 64, WBK = 32, WMMA_THREADS = 128;

template <typename TOut>
__global__ void __launch_bounds__(WMMA_THREADS)
gemm_bf16_wmma_kernel(const __nv_bfloat16* __restrict__ A,
                      const __nv_bfloat16* __restrict__ B, TOut* __restrict__ C,
                      int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[WBM][WBK + 8];
  __shared__ __align__(32) __nv_bfloat16 Bs[WBK][WBN + 8];
  __shared__ __align__(32) float Cs[WBM][WBN + 4];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  const int row0 = blockIdx.y * WBM, col0 = blockIdx.x * WBN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += WBK) {
    for (int e = tid; e < WBM * WBK; e += WMMA_THREADS) {
      const int r = e / WBK, kk = e % WBK, gr = row0 + r, gk = k0 + kk;
      As[r][kk] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : zero;
    }
    for (int e = tid; e < WBK * WBN; e += WMMA_THREADS) {
      const int kk = e / WBN, c = e % WBN, gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < N) ? B[(size_t)gk * N + gc] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[wr + 16 * i][kk], WBK + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], &Bs[kk][wc + 16 * j], WBN + 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wr + 16 * i][wc + 16 * j], acc[i][j], WBN + 4,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < WBM * WBN; e += WMMA_THREADS) {
    const int r = e / WBN, c = e % WBN, gr = row0 + r, gc = col0 + c;
    if (gr < M && gc < N) C[(size_t)gr * N + gc] = from_f<TOut>(Cs[r][c]);
  }
}

// C = A @ B on the caller's stream: tensor cores for bfloat16 operands,
// CUDA cores for float32 ones (which must stay float32-exact per product).
template <typename T, typename TOut>
cudaError_t launch_gemm(const T* A, const T* B, TOut* C, int M, int N, int K,
                        cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    gemm_bf16_wmma_kernel<TOut><<<dim3((N + WBN - 1) / WBN, (M + WBM - 1) / WBM),
                                  WMMA_THREADS, 0, stream>>>(A, B, C, M, N, K);
  } else {
    gemm_kernel<T, TOut><<<dim3((N + GBN - 1) / GBN, (M + GBM - 1) / GBM),
                           GEMM_THREADS, 0, stream>>>(A, B, C, M, N, K);
  }
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

template <typename T, typename TB>
int run(const void* x, const void* rot, const void* trans, const void* mask,
        const void* w_qkv, const void* w_out, const float* g, const void* bias,
        float* proj, void* feat, void* acc, void* attn, int b, int bp, int L,
        int d, int h, int ds, int p, float scale_total, float nk_scale,
        cudaStream_t stream) {
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

}  // namespace

extern "C" {

// dtype / bias_dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t
// (0 on success); cudaErrorInvalidValue for shapes the kernel does not take.
int ipa_fused_layer_forward(int dtype, int bias_dtype, const void* x,
                            const void* rot, const void* trans, const void* mask,
                            const void* w_qkv, const void* w_out, const float* g,
                            const void* bias, float* proj, void* feat, void* acc,
                            void* attn, int b, int bp, int L, int d, int h, int ds,
                            int p, float scale_total, float nk_scale, void* stream) {
  if (L < 1 || L > MAX_L || bp < 1 || b % bp != 0 || h < 1 || ds < 1 || p < 1 ||
      ds + 3 * p > MAX_FV)
    return cudaErrorInvalidValue;
  if (attention_smem_floats(L, ds, p) * sizeof(float) > 232448) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && bias_dtype == 0)
    return run<float, float>(x, rot, trans, mask, w_qkv, w_out, g, bias, proj, feat,
                             acc, attn, b, bp, L, d, h, ds, p, scale_total, nk_scale, s);
  if (dtype == 1 && bias_dtype == 1)
    return run<__nv_bfloat16, __nv_bfloat16>(x, rot, trans, mask, w_qkv, w_out, g, bias,
                                             proj, feat, acc, attn, b, bp, L, d, h, ds, p,
                                             scale_total, nk_scale, s);
  if (dtype == 1 && bias_dtype == 0)
    return run<__nv_bfloat16, float>(x, rot, trans, mask, w_qkv, w_out, g, bias, proj,
                                     feat, acc, attn, b, bp, L, d, h, ds, p, scale_total,
                                     nk_scale, s);
  return cudaErrorInvalidValue;
}

const char* ipa_fused_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
