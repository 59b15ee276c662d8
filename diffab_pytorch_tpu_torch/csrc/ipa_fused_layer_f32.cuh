// The float32 fused IPA layer on the tensor cores (sm_90a), every product
// as 3xTF32: two launches, included by ipa_fused_layer.cu, which documents
// the layer and owns the entry points.  The same design as the bfloat16
// layer (ipa_fused_layer_bf16.cuh) on the other product route; the
// attention phases are the warp core of ipa_attention_tc.cuh.
//
//   1. layer_heads_kernel, one block of 8 warps per (head, design):
//      a. this head's Q/K/V projection x[design] (L x d) @ W_h (d x 3 FVP)
//         with mma.sync m16n8k8 on tf32 operands; x and W_h come in
//         32-deep float32 slices by cp.async, double-buffered; warp w owns
//         rows 16 w .. 16 w + 15 and keeps all 3 FVP columns of them in
//         registers.  The projection never reaches device memory.
//      b. the projection goes into the feature-major operand tiles the
//         core reads ([feature][row], stride ts): scalar columns as they
//         are, point columns raw; then one thread per (part, row) applies
//         the frames in place (g folded into the q / k translations), sums
//         the point norms and writes the augmented rows
//         q: [q_s | 2 q_p | -|q_p|^2 | -1 | 1], k: [k_s | k_p | 1 | |k_p|^2 |
//         key mask], zero-padded to FP (a multiple of 8), and the value
//         rows [v_s | v_p] zero-padded to FVP.
//      c. each warp's 16 query rows x all LP keys of logits in registers
//         (ipa_tc::logits), bias, scale and a float32 softmax
//         (softmax_rows; keys >= L get weight exactly 0), the weights
//         written in float32 from the accumulators (store_weights).
//      d. the weights stay in registers as the A operand of P [v_s | v_p]
//         (weighted_sums; keys relabelled inside each 8-key tile so the
//         logits' accumulators feed it as they lie).
//      e. epilogue: the outputs transposed through the warp's own 16
//         columns of the q tile (only it reads them); inverse frames and
//         point norms; the head's features [out_s | loc | nrm | 0 pad]
//         (FH columns) written in float32 to feat (b L, h FH), head-major.
//   2. out_proj_kernel: acc = feat @ W_out_h (h FH x dP), a 3xTF32 GEMM
//      with 64 x 64 tiles, 32-deep cp.async double-buffered slices.
//
// 3xTF32: each operand x splits into big = tf32(x) and small =
// tf32(x - big) (ptx::split_tf32) and a b is taken as a_small b_big +
// a_big b_small + a_big b_big, accumulated in float32: ~3 2^-22 of each
// product, where one TF32 product leaves ~2^-11, which the float32 checks
// (1e-4) do not accept at the logits' magnitudes (|q'|^2, |k'|^2 ~ 10^2;
// tests/test_torch_fused_layer.py emulates both on the CPU).  Operands are
// split as the fragments are loaded, so shared memory holds each value
// once.
//
// Shared memory of launch 1 (layer_dims), in floats: frames 13 LP, then one
// region that first holds two projection stages (x slice LP x 36 and W
// slice 32 x ws, ws = 3 FVP rounded up to 32 plus 8) and afterwards the
// operand tiles qa, ka (FP x ts) and va (FVP x ts), ts = LP rounded up to
// 32 plus 8.  The strides keep every fragment load free of bank
// conflicts (x rows at 4 mod 32 words, W and tile rows at 8 mod 32).  At
// the default shapes (L = 128, ds = 32, P = 8) that is 106,752 bytes, two
// blocks per SM; at the largest shapes taken (L = 128, ds + 3P = 64,
// P = 21) 119,808 bytes, within the 227 KB a block may use whatever d and
// h are (d is sliced, h is the grid).  Beyond 128 rows each block takes
// 128 of them (CHUNKED below), with the same layout and bytes.

#pragma once

#include "ipa_attention_tc.cuh"
#include "ipa_fused_layer_features.cuh"
#include "ptx.cuh"

#include <cmath>

namespace tf32x3 {

using namespace ptx;

constexpr int THREADS = 256;
constexpr int KC = 32;  // projection depth per cp.async stage
constexpr int XS = KC + 4;  // x slice row stride (floats), 4 mod 32
constexpr int MAX_V_TILES = ipa_tc::MAX_V_TILES;      // FVP / 8
constexpr int MAX_KEY_TILES = ipa_tc::MAX_KEY_TILES;  // LP / 8

struct Dims {
  int L, LP, d, h, ds, p, FV, FVP, FP, NQ, FH;
  int ws, ts;        // W slice and operand tile row strides (floats)
  int stage_floats;  // one projection stage: x slice LP x XS, then W slice KC x ws
  int total;         // launch 1 dynamic shared memory (bytes)
};

// dir: the features carry the point directions (FH = ds + 7 P rounded up)
inline Dims layer_dims(int L, int d, int h, int ds, int p, bool dir = false) {
  Dims D;
  D.L = L, D.LP = round_up(L, 16), D.d = d, D.h = h, D.ds = ds, D.p = p;
  D.FV = ds + 3 * p, D.FVP = round_up(D.FV, 8), D.FP = round_up(D.FV + 3, 8);
  D.NQ = 3 * D.FVP, D.FH = round_up(ds + (dir ? 7 : 4) * p, 8);
  D.ws = tile_stride<float>(D.NQ), D.ts = tile_stride<float>(D.LP);
  D.stage_floats = D.LP * XS + KC * D.ws;
  const int tiles = (2 * D.FP + D.FVP) * D.ts;
  const int region = 2 * D.stage_floats > tiles ? 2 * D.stage_floats : tiles;
  D.total = (13 * D.LP + region) * 4;
  return D;
}

// ---- launch 1 ------------------------------------------------------------------
// CHUNKED (L > MAX_L): as the bf16 layer's (tc::layer_heads_kernel), the
// block takes rows row0 .. row0 + CHUNK - 1, stops after the operands and
// writes them feature-major to opnd: q, k (b, h, FP, LS), v (b, h, FVP, LS).
// DIR: the epilogue writes the point directions too
template <bool CHUNKED = false, bool DIR = false>
__global__ void __launch_bounds__(THREADS, 2)
layer_heads_kernel(const float* __restrict__ x,        // (b, L, d)
                   const float* __restrict__ rot,      // (b, L, 3, 3)
                   const float* __restrict__ trans,    // (b, L, 3)
                   const float* __restrict__ mask,     // (b, L)
                   const float* __restrict__ w_qkv,    // (h, d, 3 FVP)
                   const float* __restrict__ g,        // (h,)
                   const float* __restrict__ bias,     // (bp, h, L, L)
                   float* __restrict__ feat,           // (b L, h FH)
                   float* __restrict__ attn,           // (b, h, L, L)
                   const Dims D, int n_designs, float scale_total, float nk_scale,
                   int x_vec, float* __restrict__ opnd) {
  const int hh = blockIdx.x, design = blockIdx.y, target = design / n_designs;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, column pair
  const int row0 = CHUNKED ? blockIdx.z * ipa_tc::CHUNK : 0;  // the block's first row
  const int L = CHUNKED ? min(ipa_tc::CHUNK, D.L - row0) : D.L;  // its rows
  const int LP = D.LP, d = D.d, h = D.h, ds = D.ds, p = D.p;
  const int FV = D.FV, FVP = D.FVP, FP = D.FP, NQ = D.NQ, ts = D.ts;
  const int m0 = warp * 16;  // this warp's query / projection rows

  extern __shared__ __align__(16) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem);  // LP x 9
  float* tr = rs + LP * 9;    // LP x 3
  float* nks = tr + LP * 3;   // LP
  float* region = nks + LP;
  // after the projection the region holds:
  float* qa = region;         // FP x ts   [feature][query row]
  float* ka = qa + FP * ts;   // FP x ts   [feature][key]
  float* va = ka + FP * ts;   // FVP x ts  [value feature][key]

  const size_t row_base = (size_t)design * D.L + row0;
  const float* xg = x + row_base * d;
  const float* wg = w_qkv + (size_t)hh * d * NQ;
  const float gh = g[hh];

  // ---- a. projection ---------------------------------------------------------
  // 32-deep slices of x[design] and W_h by cp.async, double-buffered
  auto load_stage = [&](int chunk, int buf) {
    float* xs = region + buf * D.stage_floats;
    float* ws = xs + LP * XS;
    const int k0 = chunk * KC;
    for (int e = tid; e < LP * (KC / 4); e += THREADS) {
      const int r = e / (KC / 4), k = k0 + 4 * (e % (KC / 4));
      float* dst = xs + r * XS + (k - k0);
      if (x_vec) {
        const bool ok = r < L && k < d;
        cp_async16(dst, ok ? xg + (size_t)r * d + k : xg, ok);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dst[u] = (r < L && k + u < d) ? xg[(size_t)r * d + k + u] : 0.f;
      }
    }
    const int pieces = NQ / 4;
    for (int e = tid; e < KC * pieces; e += THREADS) {
      const int kr = e / pieces, c = 4 * (e - kr * pieces), k = k0 + kr;
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
  for (int e = tid; e < LP * 9; e += THREADS) rs[e] = e < L * 9 ? rot[row_base * 9 + e] : 0.f;
  for (int e = tid; e < LP * 3; e += THREADS) tr[e] = e < L * 3 ? trans[row_base * 3 + e] : 0.f;
  for (int l = tid; l < LP; l += THREADS)
    nks[l] = l < L ? (mask[row_base + l] - 1.f) * nk_scale : 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      load_stage(c + 1, (c + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = region + (c & 1) * D.stage_floats;
    const float* ws = xs + LP * XS;
    if (m0 < LP) {
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        // A: rows gq and gq + 8, k-columns tq and tq + 4 of this slice
        const float* xa = xs + (m0 + gq) * XS + ks * 8 + tq;
        uint32_t ab[4], as[4];
        split_tf32(xa[0], ab[0], as[0]);
        split_tf32(xa[8 * XS], ab[1], as[1]);
        split_tf32(xa[4], ab[2], as[2]);
        split_tf32(xa[8 * XS + 4], ab[3], as[3]);
        // B: k-rows tq and tq + 4, column gq of each 8-column tile
        const float* wb = ws + (ks * 8 + tq) * D.ws + gq;
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int vt = 0; vt < MAX_V_TILES; ++vt) {
            if (vt < v_tiles) {
              const int n = part * FVP + vt * 8;
              uint32_t bb[2], bs[2];
              split_tf32(wb[n], bb[0], bs[0]);
              split_tf32(wb[4 * D.ws + n], bb[1], bs[1]);
              mma_tf32(acc[part][vt], as, bb[0], bb[1]);
              mma_tf32(acc[part][vt], ab, bs[0], bs[1]);
              mma_tf32(acc[part][vt], ab, bb[0], bb[1]);
            }
          }
      }
    }
    __syncthreads();  // the stage is free for the next slice (or the operands)
  }

  // ---- b. operands -----------------------------------------------------------
  // every column < FV of the projection into its tile row; point columns
  // raw for now
  if (m0 < LP) {
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      float* tile = part == 0 ? qa : part == 1 ? ka : va;
#pragma unroll
      for (int vt = 0; vt < MAX_V_TILES; ++vt) {
        if (vt < v_tiles) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = m0 + gq + (e >> 1) * 8, c = vt * 8 + 2 * tq + (e & 1);
            if (c < FV) tile[c * ts + r] = acc[part][vt][e];
          }
        }
      }
    }
  }
  __syncthreads();
  // frames in place (p @ R + t; g folded into t for q and k), point norms,
  // the augmented rows and the zero padding
  for (int e = tid; e < 3 * LP; e += THREADS) {
    const int part = e / LP, l = e - part * LP;
    float* tile = part == 0 ? qa : part == 1 ? ka : va;
    const float* R = rs + l * 9;
    float t[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) t[c] = part < 2 ? tr[l * 3 + c] * gh : tr[l * 3 + c];
    float sq = 0.f;
    for (int pp = 0; pp < p; ++pp) {
      float* P = tile + (ds + pp) * ts + l;  // coordinate c at P[c p ts]
      const float p0 = P[0], p1 = P[p * ts], p2 = P[2 * p * ts];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = p0 * R[c] + p1 * R[3 + c] + p2 * R[6 + c] + t[c];
        sq += v * v;
        P[c * p * ts] = part == 0 ? 2.f * v : v;
      }
    }
    int pad = FV;
    if (part == 0) {
      tile[FV * ts + l] = -sq;
      tile[(FV + 1) * ts + l] = -1.f;
      tile[(FV + 2) * ts + l] = 1.f;
      pad = FV + 3;
    } else if (part == 1) {
      tile[FV * ts + l] = 1.f;
      tile[(FV + 1) * ts + l] = sq;
      tile[(FV + 2) * ts + l] = nks[l];
      pad = FV + 3;
    }
    for (int c = pad; c < (part < 2 ? FP : FVP); ++c) tile[c * ts + l] = 0.f;
  }
  __syncthreads();
  if constexpr (CHUNKED) {
    const int LS = round_up(D.L, 16), cols = LS - row0 < LP ? LS - row0 : LP;
    const size_t gi = (size_t)design * h + hh, qk = (size_t)gridDim.y * h * FP * LS;
    float* qo = opnd + gi * FP * LS + row0;
    float* vo = opnd + 2 * qk + gi * FVP * LS + row0;
    // qa, ka and va are consecutive rows of stride ts: 2 FP + FVP of them
    for (int e = tid; e < (2 * FP + FVP) * cols; e += THREADS) {
      const int f = e / cols, l = e - f * cols;
      float* dst = f < 2 * FP ? qo + (f < FP ? 0 : qk) + (size_t)(f % FP) * LS
                              : vo + (size_t)(f - 2 * FP) * LS;
      dst[l] = qa[f * ts + l];
    }
    return;
  }
  if (m0 >= LP) return;  // warp-uniform; no block barrier follows

  // ---- c, d. the attention core ------------------------------------------------
  float s[MAX_KEY_TILES][4];
  ipa_tc::logits<float>(qa, ts, m0, ka, ts, FP, LP, lane, s);
  ipa_tc::softmax_rows<float>(s, bias + ((size_t)target * h + hh) * L * L, L, LP, m0,
                                     scale_total, lane);
  ipa_tc::store_weights<float>(s, attn + ((size_t)design * h + hh) * L * L, L, m0, 0, LP,
                               lane, nullptr, 0);
  float o[MAX_V_TILES][4];
  ipa_tc::weighted_sums<float>(s, va, ts, FVP, LP, lane, o);

  // ---- e. epilogue: inverse frames, norms, features ---------------------------------
  // the outputs, transposed through this warp's own 16 columns of the q
  // tile (FVP <= FP rows): ot[c ts + r] for feature c of row m0 + r
  float* ot = qa + m0;
  __syncwarp();
#pragma unroll
  for (int vt = 0; vt < MAX_V_TILES; ++vt) {
    if (vt < v_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ot[(vt * 8 + 2 * tq + (e & 1)) * ts + gq + (e >> 1) * 8] = o[vt][e];
    }
  }
  __syncwarp();
  const int rows = L - m0 < 16 ? L - m0 : 16;
  ipa_layer::write_features<float, DIR>(ot, 1, ts, rs + m0 * 9, tr + m0 * 3, rows, ds, p,
                                        D.FH, feat + ((row_base + m0) * h + hh) * D.FH,
                                        (size_t)h * D.FH, lane);
}

// ---- launch 2: C (M x N) = A (M x K) @ B (K x NP), float32 ------------------------------
// 64 x 64 tiles (4 warps of 32 x 32), 32-deep K slices, cp.async
// double-buffered; each fragment split into tf32 big + small as it is
// loaded, three products per tile.  512 blocks at b = 128 and 128 at
// b = 32 for d = 128.
constexpr int GM = 64, GN = 64, GK = 32, G_THREADS = 128;

__global__ void __launch_bounds__(G_THREADS)
out_proj_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                int M, int N, int NP, int K) {
  __shared__ __align__(16) float As[2][GM][GK + 4];  // rows at 4 mod 32 words
  __shared__ __align__(16) float Bs[2][GK][GN + 8];  // rows at 8 mod 32 words
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
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
    for (int e = tid; e < GM * (GK / 4); e += G_THREADS) {
      const int r = e / (GK / 4), c = 4 * (e % (GK / 4)), gr = row0 + r, k = k0 + c;
      const bool ok = gr < M && k < K;
      cp_async16(&As[buf][r][c], ok ? A + (size_t)gr * K + k : A, ok);
    }
#pragma unroll
    for (int e = tid; e < GK * (GN / 4); e += G_THREADS) {
      const int kr = e / (GN / 4), c = 4 * (e % (GN / 4)), k = k0 + kr, gc = col0 + c;
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
    for (int ks = 0; ks < GK / 8; ++ks) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* a = &As[buf][wm + mi * 16 + gq][ks * 8 + tq];
        split_tf32(a[0], ab[mi][0], as[mi][0]);
        split_tf32(a[8 * (GK + 4)], ab[mi][1], as[mi][1]);
        split_tf32(a[4], ab[mi][2], as[mi][2]);
        split_tf32(a[8 * (GK + 4) + 4], ab[mi][3], as[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* b = &Bs[buf][ks * 8 + tq][wn + ni * 8 + gq];
        uint32_t bb[2], bs[2];
        split_tf32(b[0], bb[0], bs[0]);
        split_tf32(b[4 * (GN + 8)], bb[1], bs[1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_tf32(acc[mi][ni], as[mi], bb[0], bb[1]);
          mma_tf32(acc[mi][ni], ab[mi], bs[0], bs[1]);
          mma_tf32(acc[mi][ni], ab[mi], bb[0], bb[1]);
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
        const int r = row0 + wm + mi * 16 + gq + hr * 8;
        const int c = col0 + wn + ni * 8 + 2 * tq;
        if (r >= M || c >= N) continue;
        float* dst = C + (size_t)r * N + c;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[mi][ni][2 * hr], acc[mi][ni][2 * hr + 1]);
        } else {
          dst[0] = acc[mi][ni][2 * hr];
          if (c + 1 < N) dst[1] = acc[mi][ni][2 * hr + 1];
        }
      }
}

}  // namespace tf32x3
