// The float32 fused IPA layer on the tensor cores (sm_90a), every product
// as 3xTF32: two launches, included by ipa_fused_layer.cu, which documents
// the layer and owns the entry points.  The same design as the bfloat16
// layer (ipa_fused_layer_bf16.cuh) on the other product route; the
// attention phases are those of ipa_attention_tc.cuh's warp core, with the
// products issued as its one-pass core issues them (below).
//
//   1. layer_heads_kernel, one block of 8 warps per (head, design):
//      a. this head's Q/K/V projection x[design] (L x d) @ W_h (d x 3 FVP)
//         with mma.sync m16n8k8 on tf32 operands; x and W_h come in
//         16-deep float32 slices by cp.async through a ring of three
//         stages, one block barrier a slice; each thread splits the W
//         pieces it copied into tf32 (big, small) pairs once they land, so
//         W_h is split once per block and one 16-byte load gives a B
//         fragment's big and small pairs; warp w owns rows 16 w .. 16 w + 15,
//         splits its own x fragments as it loads them and keeps all 3 FVP
//         columns of them in registers.  The projection never reaches
//         device memory.
//      b. the projection goes into the feature-major operand tiles the
//         core reads ([feature][row], stride ts): scalar columns as they
//         are, point columns raw; then one thread per (part, row) applies
//         the frames in place (g folded into the q / k translations), sums
//         the point norms and writes the augmented rows
//         q: [q_s | 2 q_p | -|q_p|^2 | -1 | 1], k: [k_s | k_p | 1 | |k_p|^2 |
//         key mask], zero-padded to FP (a multiple of 8), and the value
//         rows [v_s | v_p] zero-padded to FVP.
//      c. each warp's 16 query rows x all LP keys of logits in registers
//         (logits_3x), bias, scale and a float32 softmax (softmax_rows;
//         keys >= L get weight exactly 0), the weights written in float32
//         from the accumulators (store_weights).
//      d. the weights stay in registers as the A operand of P [v_s | v_p]
//         (weighted_sums_3x; keys relabelled inside each 8-key tile so the
//         logits' accumulators feed it as they lie).
//      e. epilogue: the outputs transposed through the warp's own 16
//         columns of the q tile (only it reads them); inverse frames and
//         point norms by (row, point) item (write_features_by_item); the
//         head's features [out_s | loc | nrm | 0 pad] (FH columns) written
//         in float32 to feat (b L, h FH), head-major.
//   2. out_proj_kernel: acc = feat @ W_out_h (h FH x dP), a 3xTF32 GEMM
//      with 64 x 64 tiles, 32-deep cp.async double-buffered slices.
//
// 3xTF32: each operand x splits into big = tf32(x) and small =
// tf32(x - big) (ptx::split_tf32) and a b is taken as a_small b_big +
// a_big b_small + a_big b_big, accumulated in float32: ~3 2^-22 of each
// product, where one TF32 product leaves ~2^-11, which the float32 checks
// (1e-4) do not accept at the logits' magnitudes (|q'|^2, |k'|^2 ~ 10^2;
// tests/test_torch_fused_layer.py emulates both on the CPU).  Launch 1's
// three products issue their terms tile-interleaved: for each 8-deep
// k-group, the small-big term of a group of tiles, then their big-small
// terms, then their big-big terms, so that neighbouring mma.sync feed
// different accumulators.  Each accumulator still takes its terms in the
// order above and its k-groups in ascending order, so every product is
// bitwise the one-tile-at-a-time result.  FIXED instantiates the default
// (and official) head widths, ds 32 and P 8 (FP / 8 = 8, FVP / 8 = 7) at
// 128 rows a block, with every slice a compile-time constant, so the
// products carry no branch; other shapes take the slices at run time.
//
// Shared memory of launch 1 (layer_dims), in floats: frames 13 LP, then one
// region that first holds the projection ring (three stages of the x slice
// LP x 20 and the W slice's 8 pair rows of 4 (3 FVP + 2)) and afterwards
// the operand tiles qa, ka (FP x ts) and va (FVP x ts), ts = LP rounded up
// to 32 plus 8.  The strides keep every fragment load free of bank
// conflicts (x rows at 20 mod 32 words, W pair rows at 2 mod 8 16-byte
// words, tile rows at 8 mod 32).  At the default shapes (L = 128, ds = 32,
// P = 8) the ring (96,000 bytes) fits under the tiles and the block takes
// 106,752 bytes, two blocks per SM, as before the ring; at the largest
// shapes taken (L = 128, ds + 3P = 64, P = 21) 119,808 bytes, within the
// 227 KB a block may use whatever d and h are (d is sliced, h is the
// grid).  Beyond 128 rows each block takes 128 of them (CHUNKED below),
// with the same layout and bytes.  K and V stay raw (each warp splits the
// fragments it reads): as tf32 pairs they would take ~164 KB at L = 128
// and one block an SM.
//
// What bounds it on an H100 (700 W): per (head, design) block of 128 rows
// at the default widths the products are 13,824 mma.sync (8,064 of them
// the projection), ~0.09 ms for a b = 128, h = 8 launch at the card's
// measured 1.52 cycles an mma an SM; the block's bytes are small (x, W_h,
// bias and attn).  With each tile's three products chained on one
// accumulator and every warp splitting every fragment it loaded, that
// launch took 0.46 ms, its warps waiting on latency; this design takes
// 0.27 ms (0.38 ms for the official chunked launch, 0.58 before).  Its
// block's ~125k cycles (clock64 stamps): the projection ~60k, logits and
// softmax ~31k (K split by every warp, the bias read after the products),
// weighted sums ~11k, the operands, frames, attn stores and epilogue the
// rest.  Without its products the official launch takes 0.25 ms of its
// 0.38: the products themselves run near the tensor pipe's rate, and what
// bounds the launch is the work around them that they do not overlap (the
// x and W_h slices every block reads again, their split, a barrier a
// slice, the operand stores); thinning the W loads' shared-memory traffic
// fourfold changed nothing.  Unrolling the projection's k-groups let ptxas
// load ahead and spill the accumulators (128 registers a thread at two
// blocks an SM); one block an SM with 255 registers was 23% slower.

#pragma once

#include "ipa_attention_tc.cuh"
#include "ipa_fused_layer_features.cuh"
#include "ptx.cuh"

#include <cmath>

namespace tf32x3 {

using namespace ptx;

constexpr int THREADS = 256;
constexpr int KC = 16;      // projection depth per ring stage
constexpr int STAGES = 3;   // ring stages
constexpr int XS = KC + 4;  // x slice row stride (floats), 20 mod 32
constexpr int MAX_V_TILES = ipa_tc::MAX_V_TILES;      // FVP / 8
constexpr int MAX_KEY_TILES = ipa_tc::MAX_KEY_TILES;  // LP / 8
constexpr int MAX_KK = ipa_tc::MAX_F / 8;             // FP / 8
// the default and official head widths (ds 32, P 8: FP 64, FVP 56) at 128
// rows a block, compiled with their slices fixed
constexpr int FIXED_KK = 8, FIXED_VT = 7, FIXED_LP = ipa_tc::MAX_L;
constexpr int GROUP = 4;  // tiles whose terms interleave (2, 3, 7, 8 no faster on an H100)

struct Dims {
  int L, LP, d, h, ds, p, FV, FVP, FP, NQ, FH;
  int wrow, ts;      // W pair-row and operand tile row strides (floats)
  int stage_floats;  // one ring stage: x slice LP x XS, then W slice KC / 2 x wrow
  int total;         // launch 1 dynamic shared memory (bytes)
};

// dir: the features carry the point directions (FH = ds + 7 P rounded up)
inline Dims layer_dims(int L, int d, int h, int ds, int p, bool dir = false) {
  Dims D;
  D.L = L, D.LP = round_up(L, 16), D.d = d, D.h = h, D.ds = ds, D.p = p;
  D.FV = ds + 3 * p, D.FVP = round_up(D.FV, 8), D.FP = round_up(D.FV + 3, 8);
  D.NQ = 3 * D.FVP, D.FH = round_up(ds + (dir ? 7 : 4) * p, 8);
  D.wrow = 4 * (D.NQ + 2), D.ts = tile_stride<float>(D.LP);
  D.stage_floats = D.LP * XS + KC / 2 * D.wrow;
  const int tiles = (2 * D.FP + D.FVP) * D.ts;
  const int region = STAGES * D.stage_floats > tiles ? STAGES * D.stage_floats : tiles;
  D.total = (13 * D.LP + region) * 4;
  return D;
}

// Whether a launch 1 of these dims runs the FIXED instantiation
inline bool fixed_widths(const Dims& D) {
  return D.FP == 8 * FIXED_KK && D.FVP == 8 * FIXED_VT && D.LP == FIXED_LP;
}

// ---- the products, terms interleaved across tiles ----------------------------------
// acc[vt] += x W for the warp's 16 rows, one 8-deep k-group: (ab, as) the
// split A fragment, wp the group's W pair row at the part's first column
// (tile vt's [big k | big k + 4 | small k | small k + 4] at wp + 32 vt + 4 g)
template <int VT>
__device__ __forceinline__ void project_3x(float (&acc)[MAX_V_TILES][4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const float* wp,
                                           int v_tiles) {
  constexpr int VTM = VT ? VT : MAX_V_TILES;
#pragma unroll
  for (int g0 = 0; g0 < VTM; g0 += GROUP) {
    uint4 w[GROUP];
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      if (g0 + j < VTM && (VT || g0 + j < v_tiles))
        w[j] = *reinterpret_cast<const uint4*>(wp + 32 * (g0 + j));
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      if (g0 + j < VTM && (VT || g0 + j < v_tiles)) mma_tf32(acc[g0 + j], as, w[j].x, w[j].y);
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      if (g0 + j < VTM && (VT || g0 + j < v_tiles)) mma_tf32(acc[g0 + j], ab, w[j].z, w[j].w);
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      if (g0 + j < VTM && (VT || g0 + j < v_tiles)) mma_tf32(acc[g0 + j], ab, w[j].x, w[j].y);
  }
}

// s = Q_aug K_aug^T for the warp's 16 query rows (columns m0 .. m0 + 15 of
// qa) against all LP keys: ipa_tc::logits' float32 route with the terms
// interleaved.  KK: FP / 8, NT: LP / 8 at compile time, or 0 for run time.
template <int KK, int NT>
__device__ __forceinline__ void logits_3x(const float* __restrict__ qa,
                                          const float* __restrict__ ka, int ts, int m0, int FP,
                                          int LP, int lane, float (&s)[MAX_KEY_TILES][4]) {
  constexpr int KKM = KK ? KK : MAX_KK, NTM = NT ? NT : MAX_KEY_TILES;
  const int g = lane / 4, t = lane % 4, kk_n = FP / 8, key_tiles = LP / 8;
#pragma unroll
  for (int nt = 0; nt < MAX_KEY_TILES; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KKM; ++kk) {
    if (KK || kk < kk_n) {
      const float* q = qa + (kk * 8 + t) * ts + m0 + g;
      uint32_t ab[4], as[4];
      split_tf32(q[0], ab[0], as[0]);
      split_tf32(q[8], ab[1], as[1]);
      split_tf32(q[4 * ts], ab[2], as[2]);
      split_tf32(q[4 * ts + 8], ab[3], as[3]);
      const float* k = ka + (kk * 8 + t) * ts + g;
#pragma unroll
      for (int g0 = 0; g0 < NTM; g0 += GROUP) {
        uint32_t bb[GROUP][2], bs[GROUP][2];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          const int nt = g0 + j;
          if (nt < NTM && (NT || nt < key_tiles)) {
            split_tf32(k[nt * 8], bb[j][0], bs[j][0]);
            split_tf32(k[4 * ts + nt * 8], bb[j][1], bs[j][1]);
          }
        }
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          if (g0 + j < NTM && (NT || g0 + j < key_tiles))
            mma_tf32(s[g0 + j], as, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          if (g0 + j < NTM && (NT || g0 + j < key_tiles))
            mma_tf32(s[g0 + j], ab, bs[j][0], bs[j][1]);
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          if (g0 + j < NTM && (NT || g0 + j < key_tiles))
            mma_tf32(s[g0 + j], ab, bb[j][0], bb[j][1]);
      }
    }
  }
}

// o = P [v_s | v_p] for the warp's rows, the weights from registers, V
// ([feature][key], stride ts) from shared memory: ipa_tc::weighted_sums'
// float32 route with the terms interleaved.  VT: FVP / 8, NT: LP / 8 at
// compile time, or 0 for run time.
template <int VT, int NT>
__device__ __forceinline__ void weighted_sums_3x(const float (&s)[MAX_KEY_TILES][4],
                                                 const float* __restrict__ va, int ts, int FVP,
                                                 int LP, int lane, float (&o)[MAX_V_TILES][4]) {
  constexpr int VTM = VT ? VT : MAX_V_TILES, NTM = NT ? NT : MAX_KEY_TILES;
  const int g = lane / 4, t = lane % 4, key_tiles = LP / 8, v_tiles = FVP / 8;
#pragma unroll
  for (int vt = 0; vt < MAX_V_TILES; ++vt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[vt][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NTM; ++nt) {
    if (NT || nt < key_tiles) {
      // k-column t is key 2t and t + 4 is key 2t + 1 (ipa_attention_tc.cuh)
      uint32_t ab[4], as[4];
      split_tf32(s[nt][0], ab[0], as[0]);
      split_tf32(s[nt][2], ab[1], as[1]);
      split_tf32(s[nt][1], ab[2], as[2]);
      split_tf32(s[nt][3], ab[3], as[3]);
      const float* vk = va + g * ts + nt * 8 + 2 * t;
#pragma unroll
      for (int g0 = 0; g0 < VTM; g0 += GROUP) {
        uint32_t bb[GROUP][2], bs[GROUP][2];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          if (g0 + j < VTM && (VT || g0 + j < v_tiles)) {
            const float2 v = *reinterpret_cast<const float2*>(vk + (g0 + j) * 8 * ts);
            split_tf32(v.x, bb[j][0], bs[j][0]);
            split_tf32(v.y, bb[j][1], bs[j][1]);
          }
        }
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          if (g0 + j < VTM && (VT || g0 + j < v_tiles))
            mma_tf32(o[g0 + j], as, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          if (g0 + j < VTM && (VT || g0 + j < v_tiles))
            mma_tf32(o[g0 + j], ab, bs[j][0], bs[j][1]);
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          if (g0 + j < VTM && (VT || g0 + j < v_tiles))
            mma_tf32(o[g0 + j], ab, bb[j][0], bb[j][1]);
      }
    }
  }
}

// ---- launch 1 ------------------------------------------------------------------
// CHUNKED (L > MAX_L): as the bf16 layer's (tc::layer_heads_kernel), the
// block takes rows row0 .. row0 + CHUNK - 1, stops after the operands and
// writes them feature-major to opnd: q, k (b, h, FP, LS), v (b, h, FVP, LS).
// DIR: the epilogue writes the point directions too.  FIXED: the default
// widths' slices at compile time (fixed_widths).
template <bool CHUNKED = false, bool DIR = false, bool FIXED = false>
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
  constexpr int VT = FIXED ? FIXED_VT : 0, KK = FIXED ? FIXED_KK : 0;
  constexpr int NT = FIXED ? FIXED_LP / 8 : 0;
  const int hh = blockIdx.x, design = blockIdx.y, target = design / n_designs;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, column pair
  const int row0 = CHUNKED ? blockIdx.z * ipa_tc::CHUNK : 0;  // the block's first row
  const int L = CHUNKED ? min(ipa_tc::CHUNK, D.L - row0) : D.L;  // its rows
  const int LP = FIXED ? FIXED_LP : D.LP, d = D.d, h = D.h, ds = D.ds, p = D.p;
  const int FV = D.FV, FVP = VT ? 8 * VT : D.FVP, FP = KK ? 8 * KK : D.FP, NQ = 3 * FVP;
  const int ts = FIXED ? tile_stride<float>(FIXED_LP) : D.ts;
  const int wrow = FIXED ? 4 * (3 * 8 * FIXED_VT + 2) : D.wrow;
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

  // ---- a. projection ---------------------------------------------------------
  // slice `chunk` (KC deep) of x[design] and W_h into a stage: x rows raw
  // (LP x XS), W as KC / 2 pair rows, row (8 ks + t) for k-rows k = k0 +
  // 8 ks + t and k + 4; each thread copies a row's 4 columns of both k-rows
  // raw into the first half of their 16-float span (split_stage pairs them)
  const int pieces = NQ / 4, w_spans = KC / 2 * pieces;
  const int xk = 4 * (tid % (KC / 4));  // this thread's x columns in every slice
  auto load_stage = [&](int chunk, float* xs) {
    float* ws = xs + LP * XS;
    const int k0 = chunk * KC, k = k0 + xk;
    if (x_vec) {
      for (int r = tid / (KC / 4); r < LP; r += THREADS / (KC / 4)) {
        const bool ok = r < L && k < d;
        cp_async16(xs + r * XS + xk, ok ? xg + (size_t)r * d + k : xg, ok);
      }
    } else {
      for (int r = tid / (KC / 4); r < LP; r += THREADS / (KC / 4)) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          xs[r * XS + xk + u] = (r < L && k + u < d) ? xg[(size_t)r * d + k + u] : 0.f;
      }
    }
    for (int e = tid; e < w_spans; e += THREADS) {
      const int r2 = e / pieces, c = 4 * (e - r2 * pieces);
      const int kw = k0 + (r2 / 4) * 8 + r2 % 4;
      float* dst = ws + r2 * wrow + 4 * c;
      cp_async16(dst, kw < d ? wg + (size_t)kw * NQ + c : wg, kw < d);
      cp_async16(dst + 4, kw + 4 < d ? wg + (size_t)(kw + 4) * NQ + c : wg, kw + 4 < d);
    }
  };
  // this thread's W spans of a landed stage into [big k | big k + 4 | small
  // k | small k + 4] per column
  auto split_stage = [&](float* xs) {
    float* ws = xs + LP * XS;
    for (int e = tid; e < w_spans; e += THREADS) {
      const int r2 = e / pieces, c = 4 * (e - r2 * pieces);
      uint4* dst = reinterpret_cast<uint4*>(ws + r2 * wrow + 4 * c);
      const float4 a = *reinterpret_cast<const float4*>(dst);
      const float4 b = *reinterpret_cast<const float4*>(dst + 1);
      const float fa[4] = {a.x, a.y, a.z, a.w}, fb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t ab, as, bb, bs;
        split_tf32(fa[u], ab, as);
        split_tf32(fb[u], bb, bs);
        dst[u] = make_uint4(ab, bb, as, bs);
      }
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

  load_stage(0, region);
  cp_async_commit();
  if (n_chunks > 1) load_stage(1, region + D.stage_floats);
  cp_async_commit();
  // the frames, while the first slices are in flight
  for (int e = tid; e < LP * 9; e += THREADS) rs[e] = e < L * 9 ? rot[row_base * 9 + e] : 0.f;
  for (int e = tid; e < LP * 3; e += THREADS) tr[e] = e < L * 3 ? trans[row_base * 3 + e] : 0.f;
  for (int l = tid; l < LP; l += THREADS)
    nks[l] = l < L ? (mask[row_base + l] - 1.f) * nk_scale : 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    float* xs = region + (c % STAGES) * D.stage_floats;
    cp_async_wait<1>();  // slice c of this thread's copies has landed
    split_stage(xs);
    // slice c split by every thread; every warp done with slice c - 1,
    // whose stage slice c + 2 refills
    __syncthreads();
    if (c + 2 < n_chunks) load_stage(c + 2, region + ((c + 2) % STAGES) * D.stage_floats);
    cp_async_commit();  // possibly empty: one group a slice
    if (m0 < LP) {
      const float* ws = xs + LP * XS;
#pragma unroll 1  // unrolled, ptxas loads ahead and spills the accumulators
      for (int ks = 0; ks < KC / 8; ++ks) {
        // A: rows gq and gq + 8, k-columns tq and tq + 4 of this slice
        const float* xa = xs + (m0 + gq) * XS + ks * 8 + tq;
        uint32_t ab[4], as[4];
        split_tf32(xa[0], ab[0], as[0]);
        split_tf32(xa[8 * XS], ab[1], as[1]);
        split_tf32(xa[4], ab[2], as[2]);
        split_tf32(xa[8 * XS + 4], ab[3], as[3]);
        // B: pair row (ks, tq), column gq of each 8-column tile
        const float* wb = ws + (ks * 4 + tq) * wrow + 4 * gq;
#pragma unroll
        for (int part = 0; part < 3; ++part)
          project_3x<VT>(acc[part], ab, as, wb + 4 * part * FVP, v_tiles);
      }
    }
  }
  __syncthreads();  // every warp is done with the ring: the operands overwrite it

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
  const float gh = g[hh];
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
    // qa, ka and va are consecutive rows of stride ts: 2 FP + FVP of them,
    // 16 bytes a thread (LS, row0, cols and ts are multiples of 4 floats)
    const int c4 = cols / 4;
    for (int e = tid; e < (2 * FP + FVP) * c4; e += THREADS) {
      const int f = e / c4, l = 4 * (e - f * c4);
      float* dst = f < 2 * FP ? qo + (f < FP ? 0 : qk) + (size_t)(f % FP) * LS
                              : vo + (size_t)(f - 2 * FP) * LS;
      *reinterpret_cast<float4*>(dst + l) = *reinterpret_cast<const float4*>(qa + f * ts + l);
    }
    return;
  }
  if (m0 >= LP) return;  // warp-uniform; no block barrier follows

  // ---- c, d. the attention core ------------------------------------------------
  float s[MAX_KEY_TILES][4];
  logits_3x<KK, NT>(qa, ka, ts, m0, FP, LP, lane, s);
  ipa_tc::softmax_rows<float>(s, bias + ((size_t)target * h + hh) * L * L, L, LP, m0,
                                     scale_total, lane);
  ipa_tc::store_weights<float>(s, attn + ((size_t)design * h + hh) * L * L, L, m0, 0, LP,
                               lane, nullptr, 0);
  float o[MAX_V_TILES][4];
  weighted_sums_3x<VT, NT>(s, va, ts, FVP, LP, lane, o);

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
  ipa_layer::write_features_by_item<DIR>(ot, 1, rs + m0 * 9, tr + m0 * 3, rows, ds, p, D.FH,
                                         feat + ((row_base + m0) * h + hh) * D.FH,
                                         (size_t)h * D.FH, lane, ts);
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
