// The bfloat16 fused IPA layer on the tensor cores (sm_90a): two launches,
// included by ipa_fused_layer.cu, which documents the layer and owns the
// entry points.
//
//   1. layer_heads_kernel, one block of 8 warps per (head, design), two
//      blocks per SM:
//      a. this head's Q/K/V projection x[design] (L x d) @ W_h (d x 3 FVP)
//         with mma.sync m16n8k16 (bf16 operands, f32 accumulation); x and
//         W_h come in 64-deep slices by cp.async, double-buffered; warp w
//         owns rows 16 w .. 16 w + 15 and keeps all 3 FVP columns of them
//         in registers.  The projection never reaches device memory.
//      b. scalar columns go straight to the bf16 operand tiles; point
//         columns go through shared memory in f32 to the frames, g folding
//         and point norms, which write the augmented q / k rows
//         (FA = ds + 3P + 3 padded with zeros to FAP, a multiple of 16) and
//         the value rows [v_s | v_p] (padded to FVP, a multiple of 8).
//      c. each warp's 16 query rows x all LP keys of logits stay in
//         registers (S = Q_aug K_aug^T on the tensor cores), then bias,
//         scale and a float32 softmax with quad shuffles; keys >= L get
//         weight exactly 0; the weights are written in bf16 through a
//         shared-memory tile, 16 bytes per store.
//      d. the weights stay in registers as bf16 A fragments for
//         P [v_s | v_p] on the tensor cores (V by ldmatrix.trans).
//      e. epilogue: inverse frames and point norms; the head's features
//         [out_s | loc | nrm | 0 pad] (FH columns) are written in bf16 to
//         feat (b L, h FH), head-major.
//   2. out_proj_kernel: acc = feat @ W_out_h (h FH x dP), a tensor-core
//      GEMM with 64 x 64 x 64 tiles, cp.async double buffering.
//
// What holds launch 1 back: not the tensor cores nor the bytes (at its
// measured time it runs far below both peaks, PERF.md), but latency.  Each
// block runs its phases one after another (loads, projection, frames,
// logits, softmax, attn store, weighted sums, epilogue) with barriers
// between them, and only 16 warps per SM (two blocks of 8) are there to
// hide the waits on loads and shared memory.  More warps in flight need
// less shared memory and fewer registers per block than this layout.  With
// many items a call, ipa_fused_layer_persistent.cuh's kernel takes launch 1
// instead (two items in flight per SM, wgmma, the phases in registers).
//
// Weight layouts (ops/ipa_fused_layer.py pack_layer_weights, the one
// head-major layout that both product routes read):
//   w_qkv (h, d, 3 FVP): per head and input row [q | k | v], each
//     [scalar (ds) | points (3, P) | 0 pad];
//   w_out (h FH, dP): per head the rows [W_s (ds) | W_p (3, P) | W_n (P) |
//     0 pad], columns padded with zeros to dP = d rounded up to 8.
//
// Shared memory of launch 1 (layer_dims): frames 13 LP floats, then one
// region that first holds two projection stages (x slice LP x 72 and W
// slice 64 x NQ in bf16) and afterwards the operand tiles (qa, ka: LP x FAP,
// va: LP x FVP in bf16) with an f32 staging area: the point columns on
// their way to the frames, then per warp its 16 rows of attention weights
// (bf16, for row-contiguous stores) and of outputs (f32, for the
// epilogue).  Strides are padded so that ldmatrix and the fragment stores
// are free of bank conflicts.  At the default shapes (L = 128, ds = 32,
// P = 8) that is 95,872 bytes, two blocks per SM; at the largest shapes
// taken (L = 128, ds + 3P = 64, P = 21) 169,936 bytes, within the 227 KB a
// block may use whatever d and h are (d is sliced, h is the grid).
// Beyond 128 rows each block takes 128 of them (CHUNKED below), with the
// same layout and bytes.

#pragma once

#include "ipa_attention_tc.cuh"
#include "ipa_fused_layer_features.cuh"
#include "ptx.cuh"

#include <cmath>

namespace tc {

using namespace ptx;

__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// ---- shapes -------------------------------------------------------------------
constexpr int THREADS = 256;
constexpr int KC = 64;             // projection depth per cp.async stage
constexpr int MAX_FA_STEPS = 5;    // FAP / 16 with FAP <= 80
constexpr int MAX_KEY_TILES = 16;  // LP / 8 with LP <= 128
constexpr int MAX_V_TILES = 8;     // FVP / 8

struct Dims {
  int L, LP, d, h, ds, p, FV, FVP, FAP, NQ, FH;
  int xs, ws, qs, vs;  // tile strides (elements)
  int ps;              // point staging: column stride (floats), LP + 4
  int as, os;          // per-warp attn tile (bf16) and output tile (f32) strides
  int warp_bytes;      // per-warp staging: the attn tile, then the output tile
  int stage_bytes, post_bytes, total;  // launch 1 dynamic shared memory
};

// dir: the features carry the point directions (FH = ds + 7 P rounded up)
inline Dims layer_dims(int L, int d, int h, int ds, int p, bool dir = false) {
  Dims D;
  D.L = L, D.LP = round_up(L, 16), D.d = d, D.h = h, D.ds = ds, D.p = p;
  D.FV = ds + 3 * p, D.FVP = round_up(D.FV, 8), D.FAP = round_up(D.FV + 3, 16);
  D.NQ = 3 * D.FVP, D.FH = round_up(ds + (dir ? 7 : 4) * p, 8);
  D.xs = tile_stride<bf16>(KC), D.ws = tile_stride<bf16>(D.NQ);
  D.qs = tile_stride<bf16>(D.FAP), D.vs = tile_stride<bf16>(D.FVP);
  D.ps = D.LP + 4, D.as = D.LP + 8, D.os = tile_stride<bf16>(D.FVP);
  D.warp_bytes = 16 * (D.as * 2 > D.os * 4 ? D.as * 2 : D.os * 4);
  D.stage_bytes = (D.LP * D.xs + KC * D.ws) * 2;
  const int points = 9 * p * D.ps * 4, warps = D.LP / 16 * D.warp_bytes;
  D.post_bytes = (2 * D.LP * D.qs + D.LP * D.vs) * 2 + (points > warps ? points : warps);
  const int region = 2 * D.stage_bytes > D.post_bytes ? 2 * D.stage_bytes : D.post_bytes;
  D.total = 13 * D.LP * 4 + region;
  return D;
}

// ---- launch 1 ------------------------------------------------------------------
// CHUNKED (L > MAX_L): the block takes rows row0 .. row0 + CHUNK - 1 of the
// patch (D made for CHUNK rows, D.L the patch's L), stops after the
// operands and writes them feature-major to opnd: q, k (b, h, FAP, LS)
// then v (b, h, FVP, LS), LS = D.L rounded up to 16, padded rows included
// (finite; their keys get weight 0 in the chunked core).  DIR: the
// epilogue writes the point directions too (ipa_fused_layer_features.cuh)
template <bool CHUNKED = false, bool DIR = false>
__global__ void __launch_bounds__(THREADS, 2)
layer_heads_kernel(const bf16* __restrict__ x,        // (b, L, d)
                   const bf16* __restrict__ rot,      // (b, L, 3, 3)
                   const bf16* __restrict__ trans,    // (b, L, 3)
                   const bf16* __restrict__ mask,     // (b, L)
                   const bf16* __restrict__ w_qkv,    // (h, d, 3 FVP)
                   const float* __restrict__ g,       // (h,)
                   const bf16* __restrict__ bias,     // (bp, h, L, L)
                   bf16* __restrict__ feat,           // (b L, h FH)
                   bf16* __restrict__ attn,           // (b, h, L, L)
                   const Dims D, int n_designs, float scale_total, float nk_scale,
                   int x_vec, bf16* __restrict__ opnd) {
  const int hh = blockIdx.x, design = blockIdx.y, target = design / n_designs;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = CHUNKED ? blockIdx.z * ipa_tc::CHUNK : 0;  // the block's first row
  const int L = CHUNKED ? min(ipa_tc::CHUNK, D.L - row0) : D.L;  // its rows
  const int LP = D.LP, d = D.d, h = D.h, ds = D.ds, p = D.p;
  const int FV = D.FV, FVP = D.FVP, FAP = D.FAP, NQ = D.NQ;
  const int m0 = warp * 16;  // this warp's query / projection rows
  const bf16 zero = __float2bfloat16_rn(0.f);

  extern __shared__ __align__(16) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem);  // LP x 9
  float* ts = rs + LP * 9;                     // LP x 3
  float* nks = ts + LP * 3;                    // LP
  unsigned char* region = smem + 13 * LP * 4;
  // after the projection the region holds:
  bf16* qa = reinterpret_cast<bf16*>(region);  // LP x qs
  bf16* ka = qa + LP * D.qs;                   // LP x qs
  bf16* va = ka + LP * D.qs;                   // LP x vs
  unsigned char* stg = reinterpret_cast<unsigned char*>(va + LP * D.vs);
  // point staging, f32, column-major: pts[(part 3P + column) ps + row]
  float* pts = reinterpret_cast<float*>(stg);

  const size_t row_base = (size_t)design * D.L + row0;
  const bf16* xg = x + row_base * d;
  const bf16* wg = w_qkv + (size_t)hh * d * NQ;
  const float g_t = rnd(g[hh]);

  // ---- a. projection ---------------------------------------------------------
  // 64-deep slices of x[design] and W_h by cp.async, double-buffered
  auto load_stage = [&](int chunk, int buf) {
    bf16* xs = reinterpret_cast<bf16*>(region + buf * D.stage_bytes);
    bf16* ws = xs + LP * D.xs;
    const int k0 = chunk * KC;
    for (int e = tid; e < LP * (KC / 8); e += THREADS) {
      const int r = e / (KC / 8), k = k0 + 8 * (e % (KC / 8));
      bf16* dst = xs + r * D.xs + (k - k0);
      if (x_vec) {
        const bool ok = r < L && k < d;
        cp_async16(dst, ok ? xg + (size_t)r * d + k : xg, ok);
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          dst[u] = (r < L && k + u < d) ? xg[(size_t)r * d + k + u] : zero;
      }
    }
    for (int kr = warp; kr < KC; kr += THREADS / 32) {
      const int k = k0 + kr;
      for (int c = 8 * lane; c < NQ; c += 8 * 32)
        cp_async16(ws + kr * D.ws + c, k < d ? wg + (size_t)k * NQ + c : wg, k < d);
    }
  };

  const int n_chunks = (d + KC - 1) / KC, v_tiles = FVP / 8;
  float acc[3][MAX_V_TILES][4];  // [q | k | v] columns of this warp's rows
#pragma unroll
  for (int part = 0; part < 3; ++part)
#pragma unroll
    for (int vt = 0; vt < MAX_V_TILES; ++vt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[part][vt][e] = 0.f;

  load_stage(0, 0);
  cp_async_commit();
  // the frames, while the first slice is in flight
  for (int e = tid; e < LP * 9; e += THREADS)
    rs[e] = e < L * 9 ? __bfloat162float(rot[row_base * 9 + e]) : 0.f;
  for (int e = tid; e < LP * 3; e += THREADS)
    ts[e] = e < L * 3 ? __bfloat162float(trans[row_base * 3 + e]) : 0.f;
  for (int l = tid; l < LP; l += THREADS)
    nks[l] = l < L ? rnd((__bfloat162float(mask[row_base + l]) - 1.f) * nk_scale) : 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      load_stage(c + 1, (c + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* xs = reinterpret_cast<const bf16*>(region + (c & 1) * D.stage_bytes);
    const bf16* ws = xs + LP * D.xs;
    if (m0 < LP) {
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, xs + (m0 + (lane & 15)) * D.xs + ks * 16 + (lane >> 4) * 8);
        const bf16* wrow = ws + (ks * 16 + (lane & 15)) * D.ws;
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int vt = 0; vt < MAX_V_TILES; ++vt) {
            if (vt < v_tiles) {
              uint32_t b[2];
              ldsm_x2_t(b, wrow + part * FVP + vt * 8);
              mma_bf16(acc[part][vt], a, b[0], b[1]);
            }
          }
      }
    }
    __syncthreads();  // the stage is free for the next slice (or the operands)
  }

  // ---- b. operands -----------------------------------------------------------
  // scalar columns straight to the tiles (rounded to bf16), point columns to
  // the f32 staging
  if (m0 < LP) {
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      bf16* tile = part == 0 ? qa : part == 1 ? ka : va;
      const int stride = part == 2 ? D.vs : D.qs;
#pragma unroll
      for (int vt = 0; vt < MAX_V_TILES; ++vt) {
        if (vt < v_tiles) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = m0 + lane / 4 + hr * 8, c = vt * 8 + (lane & 3) * 2;
            const float v0 = acc[part][vt][2 * hr], v1 = acc[part][vt][2 * hr + 1];
            if (c + 1 < ds) {
              *reinterpret_cast<__nv_bfloat162*>(tile + r * stride + c) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const float v = u ? v1 : v0;
                if (c + u < ds) tile[r * stride + c + u] = __float2bfloat16_rn(v);
                else if (c + u < FV) pts[(part * 3 * p + c + u - ds) * D.ps + r] = v;
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < 3 * LP; e += THREADS) {
    const int part = e / LP, l = e % LP;
    const float* P = pts + part * 3 * p * D.ps + l;  // column j at P[j ps]
    const float* R = rs + l * 9;
    bf16* row = part == 0 ? qa + l * D.qs : part == 1 ? ka + l * D.qs : va + l * D.vs;
    float t[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) t[c] = part < 2 ? rnd(ts[l * 3 + c] * g_t) : ts[l * 3 + c];
    float sq = 0.f;
    for (int pp = 0; pp < p; ++pp) {
      const float p0 = P[pp * D.ps], p1 = P[(p + pp) * D.ps], p2 = P[(2 * p + pp) * D.ps];
      float s3 = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = p0 * R[c] + p1 * R[3 + c] + p2 * R[6 + c] + t[c];
        s3 += v * v;
        row[ds + c * p + pp] = __float2bfloat16_rn(part == 0 ? 2.f * v : v);
      }
      sq += s3;
    }
    int pad = FV;
    if (part == 0) {
      row[FV] = __float2bfloat16_rn(-sq);
      row[FV + 1] = __float2bfloat16_rn(-1.f);
      row[FV + 2] = __float2bfloat16_rn(1.f);
      pad = FV + 3;
    } else if (part == 1) {
      row[FV] = __float2bfloat16_rn(1.f);
      row[FV + 1] = __float2bfloat16_rn(sq);
      row[FV + 2] = __float2bfloat16_rn(nks[l]);
      pad = FV + 3;
    }
    for (int c = pad; c < (part < 2 ? FAP : FVP); ++c) row[c] = zero;
  }
  __syncthreads();
  if constexpr (CHUNKED) {
    const int LS = round_up(D.L, 16), cols = LS - row0 < LP ? LS - row0 : LP;
    const size_t gi = (size_t)design * h + hh, qk = (size_t)gridDim.y * h * FAP * LS;
    bf16* qo = opnd + gi * FAP * LS + row0;
    bf16* vo = opnd + 2 * qk + gi * FVP * LS + row0;
    for (int e = tid; e < (2 * FAP + FVP) * cols; e += THREADS) {
      const int f = e / cols, l = e - f * cols;
      if (f < FAP) qo[(size_t)f * LS + l] = qa[l * D.qs + f];
      else if (f < 2 * FAP) qo[qk + (size_t)(f - FAP) * LS + l] = ka[l * D.qs + f - FAP];
      else vo[(size_t)(f - 2 * FAP) * LS + l] = va[l * D.vs + f - 2 * FAP];
    }
    return;
  }
  if (m0 >= LP) return;  // warp-uniform; no block barrier follows
  unsigned char* wbuf = stg + warp * D.warp_bytes;  // the staging is free now
  bf16* at = reinterpret_cast<bf16*>(wbuf);  // this warp's attn tile, stride as
  const int rows = L - m0 < 16 ? L - m0 : 16;

  // ---- c. logits and softmax -----------------------------------------------------
  const int fa_steps = FAP / 16, key_tiles = LP / 8;
  float s[MAX_KEY_TILES][4];
#pragma unroll
  for (int nt = 0; nt < MAX_KEY_TILES; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < MAX_FA_STEPS; ++ks) {
    if (ks < fa_steps) {
      uint32_t a[4];
      ldsm_x4(a, qa + (m0 + (lane & 15)) * D.qs + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < MAX_KEY_TILES / 2; ++np) {
        if (2 * np < key_tiles) {
          uint32_t kb[4];
          ldsm_x4(kb, ka + (np * 16 + (lane & 7) + (lane >> 4) * 8) * D.qs + ks * 16 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], a, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], a, kb[2], kb[3]);
        }
      }
    }
  }

  const int r0 = m0 + lane / 4;  // this thread's rows r0 and r0 + 8
  const bf16* bias_h = bias + ((size_t)target * h + hh) * L * L;
  const bool even = L % 2 == 0;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < MAX_KEY_TILES; ++nt) {
    if (nt < key_tiles) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = r0 + hr * 8, j = nt * 8 + (lane & 3) * 2;
        float b0 = 0.f, b1 = 0.f;
        if (i < L) {
          if (even) {
            if (j < L) load_f2<bf16>(bias_h + (size_t)i * L + j, b0, b1);
          } else {
            if (j < L) b0 = load_f<bf16>(bias_h + (size_t)i * L + j);
            if (j + 1 < L) b1 = load_f<bf16>(bias_h + (size_t)i * L + j + 1);
          }
        }
        const float v0 = j < L ? (s[nt][2 * hr] + b0) * scale_total : -INFINITY;
        const float v1 = j + 1 < L ? (s[nt][2 * hr + 1] + b1) * scale_total : -INFINITY;
        s[nt][2 * hr] = v0;
        s[nt][2 * hr + 1] = v1;
        mx[hr] = fmaxf(mx[hr], fmaxf(v0, v1));
      }
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
  }
#pragma unroll
  for (int nt = 0; nt < MAX_KEY_TILES; ++nt) {
    if (nt < key_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
    // one division per row: e / sum as e * (1 / sum) is within one f32 ulp
    // of the quotient, and a division per weight takes the slow path on
    // the many denormal e of a peaked row
    sum[hr] = 1.f / sum[hr];
  }
  // the rounded weights: kept in s for the second product, and staged in
  // the attn tile for row-contiguous stores
#pragma unroll
  for (int nt = 0; nt < MAX_KEY_TILES; ++nt) {
    if (nt < key_tiles) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const __nv_bfloat162 w2 = __floats2bfloat162_rn(s[nt][2 * hr] * sum[hr],
                                                        s[nt][2 * hr + 1] * sum[hr]);
        s[nt][2 * hr] = __low2float(w2);
        s[nt][2 * hr + 1] = __high2float(w2);
        *reinterpret_cast<__nv_bfloat162*>(at + (lane / 4 + hr * 8) * D.as + nt * 8 +
                                           (lane & 3) * 2) = w2;
      }
    }
  }
  __syncwarp();
  bf16* attn_h = attn + ((size_t)design * h + hh) * L * L;
  if (L % 8 == 0) {  // 16-byte pieces; a warp writes 512 contiguous bytes
    const int per_row = L / 8;
    for (int e = lane; e < rows * per_row; e += 32) {
      const int r = e / per_row, c = 8 * (e - r * per_row);
      *reinterpret_cast<uint4*>(attn_h + (size_t)(m0 + r) * L + c) =
          *reinterpret_cast<const uint4*>(at + r * D.as + c);
    }
  } else {
    for (int e = lane; e < rows * L; e += 32) {
      const int r = e / L, c = e - r * L;
      attn_h[(size_t)(m0 + r) * L + c] = at[r * D.as + c];
    }
  }

  // ---- d. weighted sums: P [v_s | v_p] ---------------------------------------------
  float o[MAX_V_TILES][4];
#pragma unroll
  for (int vt = 0; vt < MAX_V_TILES; ++vt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[vt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < MAX_KEY_TILES / 2; ++ks) {
    if (2 * ks < key_tiles) {
      const uint32_t a[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                             pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                             pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                             pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int vp = 0; vp < MAX_V_TILES / 2; ++vp) {
        if (2 * vp + 1 < v_tiles) {
          uint32_t vb[4];
          ldsm_x4_t(vb, va + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * D.vs + vp * 16 +
                            (lane >> 4) * 8);
          mma_bf16(o[2 * vp], a, vb[0], vb[1]);
          mma_bf16(o[2 * vp + 1], a, vb[2], vb[3]);
        } else if (2 * vp < v_tiles) {
          uint32_t vb[2];
          ldsm_x2_t(vb, va + (ks * 16 + (lane & 15)) * D.vs + vp * 16);
          mma_bf16(o[2 * vp], a, vb[0], vb[1]);
        }
      }
    }
  }

  // ---- e. epilogue: inverse frames, norms, features ---------------------------------
  __syncwarp();  // every lane is done reading the attn tile
  float* orow = reinterpret_cast<float*>(wbuf);  // 16 x FVP outputs, stride os
#pragma unroll
  for (int vt = 0; vt < MAX_V_TILES; ++vt) {
    if (vt < v_tiles) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(orow + (lane / 4 + hr * 8) * D.os + vt * 8 + (lane & 3) * 2) =
            make_float2(o[vt][2 * hr], o[vt][2 * hr + 1]);
    }
  }
  __syncwarp();
  ipa_layer::write_features<bf16, DIR>(orow, D.os, 1, rs + m0 * 9, ts + m0 * 3, rows, ds, p,
                                       D.FH, feat + ((row_base + m0) * h + hh) * D.FH,
                                       (size_t)h * D.FH, lane);
}

// ---- launch 2: C (M x N) = A (M x K) @ B (K x NP), bf16 out ---------------------------
// 64 x 64 tiles (4 warps of 32 x 32), 64-deep K slices, cp.async
// double-buffered: 512 blocks at b = 128 and 128 at b = 32 for d = 128.
constexpr int GM = 64, GN = 64, GK = 64, G_THREADS = 128;

__global__ void __launch_bounds__(G_THREADS)
out_proj_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* __restrict__ C,
                int M, int N, int NP, int K) {
  __shared__ __align__(16) bf16 As[2][GM][GK + 8];
  __shared__ __align__(16) bf16 Bs[2][GK][GN + 8];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int row0 = blockIdx.y * GM, col0 = blockIdx.x * GN;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  auto load = [&](int kt, int buf) {
    const int k0 = kt * GK;
#pragma unroll
    for (int e = tid; e < GM * (GK / 8); e += G_THREADS) {
      const int r = e / (GK / 8), c = 8 * (e % (GK / 8)), gr = row0 + r, k = k0 + c;
      const bool ok = gr < M && k < K;
      cp_async16(&As[buf][r][c], ok ? A + (size_t)gr * K + k : A, ok);
    }
#pragma unroll
    for (int e = tid; e < GK * (GN / 8); e += G_THREADS) {
      const int kr = e / (GN / 8), c = 8 * (e % (GN / 8)), k = k0 + kr, gc = col0 + c;
      const bool ok = k < K && gc < NP;
      cp_async16(&Bs[buf][kr][c], ok ? B + (size_t)k * NP + gc : B, ok);
    }
  };

  const int n_kt = (K + GK - 1) / GK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {
      load(kt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < GK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], &As[buf][wm + mi * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, &Bs[buf][ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                        [wn + np * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = row0 + wm + mi * 16 + lane / 4 + hr * 8;
        const int c = col0 + wn + ni * 8 + (lane & 3) * 2;
        if (r >= M) continue;
        bf16* dst = C + (size_t)r * N + c;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(acc[mi][ni][2 * hr], acc[mi][ni][2 * hr + 1]);
        if (pairs && c < N) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = v;
        } else if (!pairs) {
          if (c < N) dst[0] = __low2bfloat16(v);
          if (c + 1 < N) dst[1] = __high2bfloat16(v);
        }
      }
}

}  // namespace tc
