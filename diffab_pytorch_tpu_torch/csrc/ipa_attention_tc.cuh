// The IPA attention core on the tensor cores (sm_90a), one warp's 16 query
// rows of one (design, head) at a time: the augmented logits
// S = Q_aug K_aug^T, the bias, the float32 softmax, the attention weights and
// the weighted sums P [v_s | v_p].  The caller owns the shared-memory
// operand tiles, the grid and the epilogue: K2 (ipa_attention.cu) in both
// dtypes, and the float32 fused layer (ipa_fused_layer_f32.cuh), which
// builds its float32 tiles itself in the layout described here.
//
// Two product routes, by the compute dtype T:
//   bfloat16: mma.sync m16n8k16 (bf16 operands, f32 accumulation), which
//     gives the plain version's rounding points: products of bf16 operands
//     summed in float32, the weights rounded to bf16 once and fed from
//     registers to the second product.
//   float32, 3xTF32: mma.sync m16n8k8 on tf32 operands.  Each operand x
//     splits into big = tf32(x) and small = tf32(x - big), each rounded as
//     cvt.rna.tf32.f32 rounds (to_tf32); a b is
//     taken as a_small b_big + a_big b_small + a_big b_big, small terms
//     first, accumulated in float32.  That leaves ~3 2^-22 of each product,
//     where one TF32 product leaves ~2^-11, which the float32 checks (1e-4)
//     do not accept at the logits' magnitudes (|q'|^2 and |k'|^2 ~ 10^2).
//     The f32 weights are the A operand of the second product and are split
//     the same way.
//
// Operand tiles in shared memory, feature-major as K2's inputs arrive:
//   qa  FP x qs    [feature][query row], the block's query rows
//   ka  FP x ks    [feature][key]
//   va  FVP x ks   [value feature][key]
// FP is the augmented width rounded up to 16 (8 is enough in float32),
// FVP = ds + 3P rounded up to 8, keys padded to LP (a multiple of 16) with
// zeros; strides come from tile_stride so that every fragment access is
// free of bank conflicts.
// Keys >= L get logit -inf, so weight exactly 0; masked keys carry
// -1e9 / scale_total in the operands and underflow to exactly 0 as well.
// Up to MAX_L keys one block holds a whole (design, head) and each warp
// all its logits (logits .. weighted_sums); longer patches run in query
// and key chunks of MAX_L (chunked_attention, at the end of this file).
//
// Fragment layouts (thread lane, group g = lane / 4, t = lane % 4): the
// accumulators of an m16n8 tile hold rows g and g + 8, columns 2t and
// 2t + 1.  bf16 A fragments of Q come from the [feature][row] tile by
// ldmatrix.trans, B fragments of K by ldmatrix.trans, B fragments of V by
// plain ldmatrix ([feature][key] is already the col layout).  In the tf32
// second product, k-column t of the A and B fragments stands for key 2t and
// column t + 4 for key 2t + 1, so the logits' accumulators are the A
// fragment as they lie and V's pair of keys is one 8-byte load.

#pragma once

#include "ptx.cuh"

#include <cmath>

namespace ipa_tc {

using namespace ptx;

constexpr int MAX_L = 128;                // keys and query rows of one block's core
constexpr int MAX_FV = 64;                // ds + 3P
constexpr int MAX_F = 80;                 // augmented features (ds + 3P + 3 padded to 16)
constexpr int MAX_KEY_TILES = MAX_L / 8;  // 8-key tiles of one warp's logits
constexpr int MAX_V_TILES = MAX_FV / 8;   // 8-feature tiles of its outputs

// ---- tiles -------------------------------------------------------------------
// rows x cols tile at dst (row stride `stride`) from feature-major rows of
// `ld` elements starting at src: rows < rows_valid and columns < n_cols
// are read, the rest zero.  vec (ld and the column offset of src multiples
// of 8 elements): 16-byte cp.async pieces, each read whole when it starts
// before n_cols (so n_cols a multiple of the piece, or the source readable
// past it); otherwise element by element.  The caller waits
// (cp_async_wait_all) and synchronises.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int rows_valid,
                                          int rows, int ld, int n_cols, int cols, int stride,
                                          bool vec, int tid, int n_threads) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);
    const int pieces = cols / PER;
    for (int e = tid; e < rows * pieces; e += n_threads) {
      const int r = e / pieces, c = (e - r * pieces) * PER;
      T* d = dst + r * stride + c;
      if (r < rows_valid && c < n_cols)
        cp_async16(d, src + (size_t)r * ld + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int e = tid; e < rows * cols; e += n_threads) {
      const int r = e / cols, c = e - r * cols;
      dst[r * stride + c] =
          r < rows_valid && c < n_cols ? src[(size_t)r * ld + c] : from_f<T>(0.f);
    }
  }
}

// ---- the warp's attention core -----------------------------------------------

// s = Q_aug K_aug^T for the warp's 16 query rows (columns qcol .. qcol + 15
// of qa) against all LP keys
template <typename T, int NT>
__device__ __forceinline__ void logits(const T* __restrict__ qa, int qs, int qcol,
                                       const T* __restrict__ ka, int ks, int FP, int LP,
                                       int lane, float (&s)[NT][4]) {
  const int key_tiles = LP / 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  if constexpr (is_bf16<T>) {
#pragma unroll
    for (int kk = 0; kk < MAX_F / 16; ++kk) {
      if (kk < FP / 16) {
        uint32_t a[4];
        ldsm_x4_t(a, qa + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * qs + qcol +
                         ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          if (2 * np < key_tiles) {
            uint32_t b[4];
            ldsm_x4_t(b, ka + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ks + np * 16 +
                             (lane >> 4) * 8);
            mma_bf16(s[2 * np], a, b[0], b[1]);
            mma_bf16(s[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
    }
  } else {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < MAX_F / 8; ++kk) {
      if (kk < FP / 8) {
        const float* q = qa + (kk * 8 + t) * qs + qcol + g;
        uint32_t ab[4], as[4];
        split_tf32(q[0], ab[0], as[0]);
        split_tf32(q[8], ab[1], as[1]);
        split_tf32(q[4 * qs], ab[2], as[2]);
        split_tf32(q[4 * qs + 8], ab[3], as[3]);
        const float* k = ka + (kk * 8 + t) * ks + g;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < key_tiles) {
            uint32_t bb[2], bs[2];
            split_tf32(k[nt * 8], bb[0], bs[0]);
            split_tf32(k[4 * ks + nt * 8], bb[1], bs[1]);
            mma_tf32(s[nt], as, bb[0], bb[1]);
            mma_tf32(s[nt], ab, bs[0], bs[1]);
            mma_tf32(s[nt], ab, bb[0], bb[1]);
          }
        }
      }
    }
  }
}

// s <- (s + bias) * scale_total for keys j0 .. j0 + KW - 1 and the
// thread's rows i0 + g, i0 + g + 8 (bias rows read for rows < L only);
// keys >= L get -inf.  TAKE_MAX: mx[hr] takes the max of each row's new
// values in the same loop (the L <= MAX_L softmax: a separate max loop
// there costs predicate spills; the chunked core is faster with one)
template <typename TB, int NT, bool TAKE_MAX = false>
__device__ __forceinline__ void add_bias(float (&s)[NT][4],
                                           const TB* __restrict__ bias_h, int L, int i0, int j0,
                                           int KW, float scale_total, int lane,
                                           float* mx = nullptr) {
  const int key_tiles = KW / 8, r0 = i0 + lane / 4;
  const bool even = L % 2 == 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt < key_tiles) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = r0 + hr * 8, j = j0 + nt * 8 + (lane & 3) * 2;
        float b0 = 0.f, b1 = 0.f;
        if (i < L) {
          if (even) {
            if (j < L) load_f2<TB>(bias_h + (size_t)i * L + j, b0, b1);
          } else {
            if (j < L) b0 = load_f<TB>(bias_h + (size_t)i * L + j);
            if (j + 1 < L) b1 = load_f<TB>(bias_h + (size_t)i * L + j + 1);
          }
        }
        const float v0 = j < L ? (s[nt][2 * hr] + b0) * scale_total : -INFINITY;
        const float v1 = j + 1 < L ? (s[nt][2 * hr + 1] + b1) * scale_total : -INFINITY;
        s[nt][2 * hr] = v0;
        s[nt][2 * hr + 1] = v1;
        if constexpr (TAKE_MAX) mx[hr] = fmaxf(mx[hr], fmaxf(v0, v1));
      }
    }
  }
}

// s <- softmax_j((s + bias) * scale_total) in float32 for the warp's rows
// m0 .. m0 + 15 (bias rows read for rows < L only), keys >= L weight 0;
// the weights are left rounded to T.  One reciprocal per row: a division per
// weight takes the slow path on the many denormal exponentials of a peaked
// row, and e * (1 / sum) is within one f32 ulp of the quotient.
template <typename T, typename TB>
__device__ __forceinline__ void softmax_rows(float (&s)[MAX_KEY_TILES][4],
                                             const TB* __restrict__ bias_h, int L, int LP,
                                             int m0, float scale_total, int lane) {
  const int key_tiles = LP / 8;
  float mx[2] = {-INFINITY, -INFINITY};
  add_bias<TB, MAX_KEY_TILES, true>(s, bias_h, L, m0, 0, LP, scale_total, lane, mx);
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
    sum[hr] = 1.f / sum[hr];
  }
#pragma unroll
  for (int nt = 0; nt < MAX_KEY_TILES; ++nt) {
    if (nt < key_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = to_f<T>(from_f<T>(s[nt][e] * sum[e >> 1]));
    }
  }
}

// The weights of rows i0 .. i0 + 15 and keys j0 .. j0 + KW - 1 (those
// < L) to attn_h (L x L, row major).  bf16: through this warp's tile
// (16 x as) for row-contiguous 16-byte stores.  float32: straight from the
// accumulators, 8 bytes a thread, four neighbours filling one 32-byte
// sector of a row (staging them through shared memory for 16-byte stores
// was slower on the H100).
template <typename T, int NT>
__device__ __forceinline__ void store_weights(const float (&s)[NT][4],
                                                    T* __restrict__ attn_h, int L, int i0,
                                                    int j0, int KW, int lane, T* tile, int as) {
  const int key_tiles = KW / 8, g = lane / 4, c2 = (lane & 3) * 2;
  if constexpr (is_bf16<T>) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < key_tiles) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<__nv_bfloat162*>(tile + (g + hr * 8) * as + nt * 8 + c2) =
              __floats2bfloat162_rn(s[nt][2 * hr], s[nt][2 * hr + 1]);
      }
    }
    __syncwarp();
    const int rows = L - i0 < 16 ? L - i0 : 16, cols = L - j0 < KW ? L - j0 : KW;
    if (L % 8 == 0) {  // a warp writes 512 contiguous bytes at a time
      const int per_row = cols / 8;
      for (int e = lane; e < rows * per_row; e += 32) {
        const int r = e / per_row, c = 8 * (e - r * per_row);
        *reinterpret_cast<uint4*>(attn_h + (size_t)(i0 + r) * L + j0 + c) =
            *reinterpret_cast<const uint4*>(tile + r * as + c);
      }
    } else {
      for (int e = lane; e < rows * cols; e += 32) {
        const int r = e / cols, c = e - r * cols;
        attn_h[(size_t)(i0 + r) * L + j0 + c] = tile[r * as + c];
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < key_tiles) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = i0 + g + hr * 8, j = j0 + nt * 8 + c2;
          if (i >= L) continue;
          float* dst = attn_h + (size_t)i * L + j;
          if (L % 2 == 0) {
            if (j < L) *reinterpret_cast<float2*>(dst) = make_float2(s[nt][2 * hr], s[nt][2 * hr + 1]);
          } else {
            if (j < L) dst[0] = s[nt][2 * hr];
            if (j + 1 < L) dst[1] = s[nt][2 * hr + 1];
          }
        }
      }
    }
  }
}

// o += P [v_s | v_p] for the warp's rows: the weights from registers, V
// ([feature][key], stride vs) from shared memory
template <typename T, int NT>
__device__ __forceinline__ void weighted_sums_acc(const float (&s)[NT][4],
                                                  const T* __restrict__ va, int vs, int FVP,
                                                  int LP, int lane, float (&o)[MAX_V_TILES][4]) {
  const int key_tiles = LP / 8, v_tiles = FVP / 8;
  if constexpr (is_bf16<T>) {
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (2 * kk < key_tiles) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const T* vk = va + kk * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int vp = 0; vp < MAX_V_TILES / 2; ++vp) {
          if (2 * vp + 1 < v_tiles) {
            uint32_t b[4];
            ldsm_x4(b, vk + (vp * 16 + (lane >> 4) * 8 + (lane & 7)) * vs);
            mma_bf16(o[2 * vp], a, b[0], b[1]);
            mma_bf16(o[2 * vp + 1], a, b[2], b[3]);
          } else if (2 * vp < v_tiles) {
            uint32_t b[2];
            ldsm_x2(b, vk + (vp * 16 + (lane & 7)) * vs);
            mma_bf16(o[2 * vp], a, b[0], b[1]);
          }
        }
      }
    }
  } else {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < key_tiles) {
        // k-column t is key 2t and t + 4 is key 2t + 1 (see the note above)
        uint32_t ab[4], as[4];
        split_tf32(s[nt][0], ab[0], as[0]);
        split_tf32(s[nt][2], ab[1], as[1]);
        split_tf32(s[nt][1], ab[2], as[2]);
        split_tf32(s[nt][3], ab[3], as[3]);
        const float* vk = va + g * vs + nt * 8 + 2 * t;
#pragma unroll
        for (int vt = 0; vt < MAX_V_TILES; ++vt) {
          if (vt < v_tiles) {
            const float2 v = *reinterpret_cast<const float2*>(vk + vt * 8 * vs);
            uint32_t bb[2], bs[2];
            split_tf32(v.x, bb[0], bs[0]);
            split_tf32(v.y, bb[1], bs[1]);
            mma_tf32(o[vt], as, bb[0], bb[1]);
            mma_tf32(o[vt], ab, bs[0], bs[1]);
            mma_tf32(o[vt], ab, bb[0], bb[1]);
          }
        }
      }
    }
  }
}

// o = P [v_s | v_p]
template <typename T>
__device__ __forceinline__ void weighted_sums(const float (&s)[MAX_KEY_TILES][4],
                                              const T* __restrict__ va, int vs, int FVP, int LP,
                                              int lane, float (&o)[MAX_V_TILES][4]) {
#pragma unroll
  for (int vt = 0; vt < MAX_V_TILES; ++vt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[vt][e] = 0.f;
  weighted_sums_acc<T>(s, va, vs, FVP, LP, lane, o);
}

// ---- patches longer than MAX_L: query and key chunks --------------------------
// Beyond MAX_L a (design, head) is cut into chunks of CHUNK query rows, one
// block each (the caller's grid), and each block streams the keys through
// its tiles in chunks of CHUNK, in two passes:
//   pass 1: every key chunk's logits (+ bias, scaled); each row's running
//     max m and sum l of exp(logit - m), the sum rescaled by exp(m_old -
//     m_new) when the max grows;
//   pass 2: every key chunk's logits again, the weights exp(logit - m) / l
//     rounded to T and written to attn (normalised: the pair-row reduction
//     reads them), and o += P [v_s | v_p] from registers.
// The tiles hold one chunk, so the shared memory is that of L = CHUNK
// whatever L is.  Each warp takes a tile's keys in two halves of SUB = 64
// (16 x 64 logits in registers): a whole chunk of logits beside the
// weighted sums spilled far more at the 128 registers that two blocks per
// SM leave a thread (PERF.md).  One chunk is never all padding (it holds keys
// j0 .. j0 + KW - 1 with j0 < L); keys >= L get logit -inf and weight
// exactly 0, masked keys the -1e9 / scale_total operand that underflows.
// Pass 2 recomputes the logits: the extra work is the first product again,
// in exchange for registers and shared memory independent of L.
constexpr int CHUNK = MAX_L;
constexpr int SUB = CHUNK / 2;  // keys of one warp's logits in registers

// pass 1: the rows' running max m (quad-reduced) and this thread's part of
// the running sum l over one chunk of scaled logits
template <int NT>
__device__ __forceinline__ void chunk_max_sum(const float (&s)[NT][4], int KW,
                                              float (&m)[2], float (&l)[2]) {
  const int key_tiles = KW / 8;
  float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt < key_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[nt][e]);
    }
  }
  float base[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    cm[hr] = fmaxf(cm[hr], __shfl_xor_sync(0xffffffffu, cm[hr], 1));
    cm[hr] = fmaxf(cm[hr], __shfl_xor_sync(0xffffffffu, cm[hr], 2));
    const float mn = fmaxf(m[hr], cm[hr]);
    // no finite logit yet (both -inf): exp(-inf - -inf) would be NaN
    base[hr] = mn == -INFINITY ? 0.f : mn;
    l[hr] *= expf(m[hr] - base[hr]);  // 0 while m is -inf
    m[hr] = mn;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt < key_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += expf(s[nt][e] - base[e >> 1]);
    }
  }
}

// pass 2: s <- exp(s - m) / l, rounded to T (inv_l = 1 / l)
template <typename T, int NT>
__device__ __forceinline__ void chunk_weights(float (&s)[NT][4], int KW,
                                              const float (&m)[2], const float (&inv_l)[2]) {
  const int key_tiles = KW / 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt < key_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = to_f<T>(from_f<T>(expf(s[nt][e] - m[e >> 1]) * inv_l[e >> 1]));
    }
  }
}

// The chunked attention of one (design, head) and query chunk q0 .. q0 +
// CHUNK - 1, by all threads of a block of CHUNK / 16 warps (it synchronises
// the block; call it from every thread).  Sources are feature-major rows
// of `ld` elements, columns < n_cols read (the rest zero): q, k (F rows,
// zero-padded to FP), values v1 (n1 rows) then v2 (n2 rows) zero-padded to
// FVP.  Tiles qa, ka (FP x ts) and va (FVP x ts), ts = tile_stride<T>(CHUNK);
// bf16 also stages each warp's attn rows in `tile` (16 x as).  Leaves
// o = attn [v1 | v2] of the warp's 16 rows, q0 + 16 warp .. (nothing for a
// warp past the chunk's padded rows), and qa holding the warp's own query
// columns, which only this warp reads.
template <typename T, typename TB>
__device__ __forceinline__ void chunked_attention(
    const T* __restrict__ q, const T* __restrict__ k, int F, int FP,
    const T* __restrict__ v1, int n1, const T* __restrict__ v2, int n2, int FVP, int ld,
    int n_cols, int L, const TB* __restrict__ bias_h, T* __restrict__ attn_h, int q0,
    float scale_total, T* qa, T* ka, T* va, int ts, T* tile, int as, int tid, int n_threads,
    float (&o)[MAX_V_TILES][4]) {
  const int LP = round_up(L, 16), lane = tid % 32, m0 = 16 * (tid / 32), i0 = q0 + m0;
  const int QW = LP - q0 < CHUNK ? LP - q0 : CHUNK, n_chunks = (LP + CHUNK - 1) / CHUNK;
  const bool vec = ld % 8 == 0, active = m0 < QW;
  load_tile(qa, q + q0, F, FP, ld, n_cols - q0, QW, ts, vec, tid, n_threads);

  float s[SUB / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    const int j0 = c * CHUNK, KW = LP - j0 < CHUNK ? LP - j0 : CHUNK;
    __syncthreads();  // every warp is done with the previous chunk
    load_tile(ka, k + j0, F, FP, ld, n_cols - j0, KW, ts, vec, tid, n_threads);
    cp_async_wait_all();
    __syncthreads();
    if (active) {
      for (int h0 = 0; h0 < KW; h0 += SUB) {
        const int SW = KW - h0 < SUB ? KW - h0 : SUB;
        logits<T>(qa, ts, m0, ka + h0, ts, FP, SW, lane, s);
        add_bias<TB>(s, bias_h, L, i0, j0 + h0, SW, scale_total, lane);
        chunk_max_sum(s, SW, m, l);
      }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    l[hr] = 1.f / l[hr];
  }
#pragma unroll
  for (int vt = 0; vt < MAX_V_TILES; ++vt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[vt][e] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int j0 = c * CHUNK, KW = LP - j0 < CHUNK ? LP - j0 : CHUNK;
    __syncthreads();
    load_tile(ka, k + j0, F, FP, ld, n_cols - j0, KW, ts, vec, tid, n_threads);
    load_tile(va, v1 + j0, n1, n1, ld, n_cols - j0, KW, ts, vec, tid, n_threads);
    load_tile(va + n1 * ts, v2 + j0, n2, FVP - n1, ld, n_cols - j0, KW, ts, vec, tid,
               n_threads);
    cp_async_wait_all();
    __syncthreads();
    if (active) {
      for (int h0 = 0; h0 < KW; h0 += SUB) {
        const int SW = KW - h0 < SUB ? KW - h0 : SUB;
        logits<T>(qa, ts, m0, ka + h0, ts, FP, SW, lane, s);
        add_bias<TB>(s, bias_h, L, i0, j0 + h0, SW, scale_total, lane);
        chunk_weights<T>(s, SW, m, l);
        store_weights<T>(s, attn_h, L, i0, j0 + h0, SW, lane, tile, as);
        __syncwarp();  // the bf16 staging tile is rewritten next
        weighted_sums_acc<T>(s, va + h0, ts, FVP, SW, lane, o);
      }
    }
  }
}

}  // namespace ipa_tc
