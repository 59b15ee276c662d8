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
// and key chunks of MAX_L (chunked_attention; the fused layer's float32
// calls in one pass over the keys, chunked_attention_onepass, last in this
// file).
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
template <typename T, int NT, bool TAKE_MAX = false>
__device__ __forceinline__ void add_bias(float (&s)[NT][4],
                                           const T* __restrict__ bias_h, int L, int i0, int j0,
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
            if (j < L) load_f2<T>(bias_h + (size_t)i * L + j, b0, b1);
          } else {
            if (j < L) b0 = load_f<T>(bias_h + (size_t)i * L + j);
            if (j + 1 < L) b1 = load_f<T>(bias_h + (size_t)i * L + j + 1);
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
template <typename T>
__device__ __forceinline__ void softmax_rows(float (&s)[MAX_KEY_TILES][4],
                                             const T* __restrict__ bias_h, int L, int LP,
                                             int m0, float scale_total, int lane) {
  const int key_tiles = LP / 8;
  float mx[2] = {-INFINITY, -INFINITY};
  add_bias<T, MAX_KEY_TILES, true>(s, bias_h, L, m0, 0, LP, scale_total, lane, mx);
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
template <typename T>
__device__ __forceinline__ void chunked_attention(
    const T* __restrict__ q, const T* __restrict__ k, int F, int FP,
    const T* __restrict__ v1, int n1, const T* __restrict__ v2, int n2, int FVP, int ld,
    int n_cols, int L, const T* __restrict__ bias_h, T* __restrict__ attn_h, int q0,
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
        add_bias<T>(s, bias_h, L, i0, j0 + h0, SW, scale_total, lane);
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
        add_bias<T>(s, bias_h, L, i0, j0 + h0, SW, scale_total, lane);
        chunk_weights<T>(s, SW, m, l);
        store_weights<T>(s, attn_h, L, i0, j0 + h0, SW, lane, tile, as);
        __syncwarp();  // the bf16 staging tile is rewritten next
        weighted_sums_acc<T>(s, va + h0, ts, FVP, SW, lane, o);
      }
    }
  }
}

// ---- float32 beyond MAX_L: one pass over the keys ------------------------------
// The float32 (3xTF32) route of the chunked core in one pass, for the fused
// layer's attention launch (ipa_fused_layer.cu onepass_attend_kernel; bf16
// and K2 keep chunked_attention above).  One block of CHUNK / 16 = 8 warps
// per (design, head, CHUNK query rows); each warp's 16 rows:
//   - q: the raw tile lands once (in the strip's space), and each warp keeps
//     its rows' A fragments split into tf32 big + small in registers;
//   - keys in chunks of OP_KC = 32 through a ring of two stages by
//     cp.async: chunk c + 1 is in flight while chunk c is multiplied.  Each
//     thread splits what it copied in place once it lands (the raw values
//     in the first half of their span), so K and V are split once per
//     block, not once per warp that reads them, and laid out so that one
//     16-byte load gives a fragment's big and small pairs as mma.sync takes
//     them: K per (8-feature slice, t) row, key by key, [big f | big f + 4 |
//     small f | small f + 4] (f = 8 slice + t); V per feature row, keys
//     2j and 2j + 1 as [big | big | small | small];
//   - each logit once: the 3xTF32 product, bias and scale, the running row
//     max m and sum l, o and l rescaled by exp(m_old - m_new) when m grows,
//     p = exp(s - m_new) into the warp's strip rows in shared memory (keys
//     of the whole patch, 16 x LS floats) with that chunk's m beside it, and
//     o += p [v_s | v_p] from registers.  The three products of each tile go
//     out term by term across the chunk's tiles, so that neighbouring
//     mma.sync instructions feed different accumulators;
//   - after the last chunk the strip rows go to attn once, each times
//     exp(m_chunk - m) / l (normalised: the pair-row reduction reads them),
//     16-byte stores where L % 4 == 0 and attn is 16-byte aligned, and o is
//     scaled by 1 / l.
// A chunk past LS (the last of an L with LS % 32 = 16) is zero-filled and
// computed whole: its keys are >= L, so their weights are 0.  KK and VT,
// the slices FP / 8 and FVP / 8, are compile-time at the default widths
// (8, 7), so the products carry no branch; 0 takes them at run time.
// The strip is what bounds the path: CHUNK x (LS + 8) floats beside the
// two stages (OnepassDims, ipa_fused_layer.cu), so one block per SM
// (__launch_bounds__(256, 1), 255 registers a thread: the q fragments live
// there), and beyond L = 272 at the default widths (256 at the widest) the
// strip no longer fits and the layer takes the two-pass core.  What bounds
// it on an H100 (700 W): at the official call (b 100, h 12, L 256) it takes
// 0.76 ms against 0.19 ms of compulsory bytes (0.11 ms of products at the
// 3xTF32 rate); a chunk's 1,440 mma.sync of a block would take 2.2k cycles
// at the card's measured 1.52 cycles an mma an SM, and a chunk takes 6.6k:
// with 8 warps an SM and a barrier a chunk the loop waits on latency, and a
// block's q loads, attn stores and epilogue (a third of its time) overlap
// nothing.
constexpr int OP_KC = 32;                 // keys of one ring stage
constexpr int OP_KROW = 4 * (OP_KC + 2);  // floats of a K stage row: 2 mod 8 float4s
constexpr int OP_VROW = 2 * OP_KC + 16;   // floats of a V stage row: 16 mod 32
constexpr int OP_QS = CHUNK + 8;          // raw q tile row stride (floats): 8 mod 32
constexpr int OP_MAX_KK = 9;              // FP / 8 for ds + 3P <= 64 in float32
constexpr int OP_THREADS = CHUNK / 16 * 32;

// Chunk c of k (FP rows) and v (FVP rows) into a stage (FP / 2 K rows of
// OP_KROW floats, then FVP V rows of OP_VROW): !SPLIT copies the pieces that
// exist (keys < LS) by cp.async, raw, into the first half of their spans;
// SPLIT turns each landed span into its (big, small) layout and zero-fills
// the spans past LS.  A K span (slice row r, 4 keys) holds features f and
// f + 4, so one thread copies and splits both.
template <bool SPLIT>
__device__ __forceinline__ void onepass_stage(const float* __restrict__ k,
                                              const float* __restrict__ v, int FP, int FVP,
                                              int LS, int c, float* stg, int tid) {
  const int j0 = c * OP_KC, per = (LS - j0 < OP_KC ? LS - j0 : OP_KC) / 4, kr = FP / 2;
  for (int e = tid; e < (kr + FVP) * (OP_KC / 4); e += OP_THREADS) {
    const int r = e / (OP_KC / 4), k4 = e % (OP_KC / 4);
    const bool have = k4 < per;
    if (r < kr) {
      float* dst = stg + r * OP_KROW + 16 * k4;
      if constexpr (!SPLIT) {
        if (have) {
          const float* src = k + (size_t)((r / 4) * 8 + r % 4) * LS + j0 + 4 * k4;
          cp_async16(dst, src);
          cp_async16(dst + 4, src + 4 * (size_t)LS);
        }
      } else {
        uint4* d = reinterpret_cast<uint4*>(dst);
        if (!have) {
#pragma unroll
          for (int u = 0; u < 4; ++u) d[u] = make_uint4(0u, 0u, 0u, 0u);
          continue;
        }
        const float4 a = *reinterpret_cast<const float4*>(dst);
        const float4 b = *reinterpret_cast<const float4*>(dst + 4);
        const float fa[4] = {a.x, a.y, a.z, a.w}, fb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t ab, as, bb, bs;
          split_tf32(fa[u], ab, as);
          split_tf32(fb[u], bb, bs);
          d[u] = make_uint4(ab, bb, as, bs);
        }
      }
    } else {
      float* dst = stg + kr * OP_KROW + (r - kr) * OP_VROW + 8 * k4;
      if constexpr (!SPLIT) {
        if (have) cp_async16(dst, v + (size_t)(r - kr) * LS + j0 + 4 * k4);
      } else {
        uint4* d = reinterpret_cast<uint4*>(dst);
        if (!have) {
          d[0] = d[1] = make_uint4(0u, 0u, 0u, 0u);
          continue;
        }
        const float4 x = *reinterpret_cast<const float4*>(dst);
        uint32_t b[4], s[4];
        split_tf32(x.x, b[0], s[0]);
        split_tf32(x.y, b[1], s[1]);
        split_tf32(x.z, b[2], s[2]);
        split_tf32(x.w, b[3], s[3]);
        d[0] = make_uint4(b[0], b[1], s[0], s[1]);
        d[1] = make_uint4(b[2], b[3], s[2], s[3]);
      }
    }
  }
}

// Sources feature-major rows of LS floats (LS = L rounded up to 16, 16-byte
// aligned): q, k (FP rows), v (FVP rows).  Shared memory: strip (CHUNK x
// ss floats, ss = LS + 8), mrow (CHUNK x nch, nch = LS / OP_KC rounded
// up), ring (two stages of FP / 2 x OP_KROW + FVP x OP_VROW floats).  Call
// from every thread of the block: it synchronises the block.  Leaves o =
// attn [v_s | v_p] of the warp's 16 rows q0 + 16 warp .. (nothing for a
// warp past LS) with attn written, and the warp's own strip rows free.
template <int KK, int VT>
__device__ __forceinline__ void chunked_attention_onepass(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    int FP, int FVP, int LS, int L, const float* __restrict__ bias_h,
    float* __restrict__ attn_h, bool attn_vec, int q0, float scale_total, float* strip, int ss,
    float* mrow, int nch, float* ring, int tid, float (&o)[MAX_V_TILES][4]) {
  constexpr int KT = OP_KC / 8;  // key tiles of a stage
  constexpr int KKM = KK ? KK : OP_MAX_KK, VTM = VT ? VT : MAX_V_TILES;
  const int lane = tid % 32, m0 = 16 * (tid / 32), i0 = q0 + m0, g = lane / 4, t = lane % 4;
  const int QW = LS - q0 < CHUNK ? LS - q0 : CHUNK, n_chunks = (LS + OP_KC - 1) / OP_KC;
  const int k_floats = FP / 2 * OP_KROW, stage = k_floats + FVP * OP_VROW;
  const int kk_n = FP / 8, v_tiles = FVP / 8;
  const bool active = m0 < QW;

  // the raw q tile (FP x QW, stride OP_QS) in the strip's space, with chunk 0
  for (int e = tid; e < FP * (QW / 4); e += OP_THREADS) {
    const int f = e / (QW / 4), c4 = e - f * (QW / 4);
    cp_async16(strip + f * OP_QS + 4 * c4, q + (size_t)f * LS + q0 + 4 * c4);
  }
  onepass_stage<false>(k, v, FP, FVP, LS, 0, ring, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // this warp's q rows as A fragments, split once: rows g, g + 8, k-columns
  // t, t + 4 of each 8-feature slice
  uint32_t qb[KKM][4], qsm[KKM][4];
#pragma unroll
  for (int kk = 0; kk < KKM; ++kk) {
    if (active && (KK || kk < kk_n)) {
      const float* qp = strip + (kk * 8 + t) * OP_QS + m0 + g;
      split_tf32(qp[0], qb[kk][0], qsm[kk][0]);
      split_tf32(qp[8], qb[kk][1], qsm[kk][1]);
      split_tf32(qp[4 * OP_QS], qb[kk][2], qsm[kk][2]);
      split_tf32(qp[4 * OP_QS + 8], qb[kk][3], qsm[kk][3]);
    }
  }

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int vt = 0; vt < MAX_V_TILES; ++vt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[vt][e] = 0.f;
  const bool even = L % 2 == 0;
  for (int c = 0; c < n_chunks; ++c) {
    if (c > 0) cp_async_wait<0>();
    // what this thread copied has landed
    onepass_stage<true>(k, v, FP, FVP, LS, c, ring + (c & 1) * stage, tid);
    // chunk c split by every thread; every warp done with chunk c - 1 (its
    // stage is refilled next) and, at c = 0, with the q tile in the strip
    __syncthreads();
    if (c + 1 < n_chunks) {
      onepass_stage<false>(k, v, FP, FVP, LS, c + 1, ring + ((c + 1) & 1) * stage, tid);
      cp_async_commit();
    }
    if (!active) continue;
    const int j0 = c * OP_KC;
    const float* ks = ring + (c & 1) * stage;
    const float* vs = ks + k_floats;

    // the chunk's bias (rows i0 + g, i0 + g + 8 < L; keys < L), read before
    // the products so that the loads are in flight under them
    float bv[KT][4];
#pragma unroll
    for (int nt = 0; nt < KT; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = i0 + g + hr * 8, j = j0 + nt * 8 + 2 * t;
        float b0 = 0.f, b1 = 0.f;
        if (i < L) {
          if (even) {
            if (j < L) load_f2<float>(bias_h + (size_t)i * L + j, b0, b1);
          } else {
            if (j < L) b0 = bias_h[(size_t)i * L + j];
            if (j + 1 < L) b1 = bias_h[(size_t)i * L + j + 1];
          }
        }
        bv[nt][2 * hr] = b0, bv[nt][2 * hr + 1] = b1;
      }

    // s = Q_aug K_aug^T; (w.x, w.y) the big B pair of features t, t + 4,
    // (w.z, w.w) the small
    float s[KT][4];
#pragma unroll
    for (int nt = 0; nt < KT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KKM; ++kk) {
      if (KK || kk < kk_n) {
        const float* kp = ks + (kk * 4 + t) * OP_KROW + 4 * g;
        uint4 w[KT];
#pragma unroll
        for (int nt = 0; nt < KT; ++nt) w[nt] = *reinterpret_cast<const uint4*>(kp + 32 * nt);
#pragma unroll
        for (int nt = 0; nt < KT; ++nt) mma_tf32(s[nt], qsm[kk], w[nt].x, w[nt].y);
#pragma unroll
        for (int nt = 0; nt < KT; ++nt) mma_tf32(s[nt], qb[kk], w[nt].z, w[nt].w);
#pragma unroll
        for (int nt = 0; nt < KT; ++nt) mma_tf32(s[nt], qb[kk], w[nt].x, w[nt].y);
      }
    }

    // (s + bias) * scale_total, keys >= L -inf; the running max
    float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = j < L ? (s[nt][e] + bv[nt][e]) * scale_total : -INFINITY;
        cm[e >> 1] = fmaxf(cm[e >> 1], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      cm[hr] = fmaxf(cm[hr], __shfl_xor_sync(0xffffffffu, cm[hr], 1));
      cm[hr] = fmaxf(cm[hr], __shfl_xor_sync(0xffffffffu, cm[hr], 2));
      // every chunk holds a key < L (j0 <= LS - 16 < L), so m is finite
      // from chunk 0 on and exp(-inf - m) = 0 there
      const float mn = fmaxf(m_run[hr], cm[hr]);
      alpha[hr] = expf(m_run[hr] - mn);
      m_run[hr] = mn;
      l_run[hr] *= alpha[hr];
    }
#pragma unroll
    for (int vt = 0; vt < VTM; ++vt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[vt][e] *= alpha[e >> 1];

    // p = exp(s - m) into the strip (keys < LS) and o += p [v_s | v_p]
    float* srow = strip + (m0 + g) * ss + j0 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m_run[e >> 1]);
        l_run[e >> 1] += s[nt][e];
      }
      if (j0 + nt * 8 < LS) {
        *reinterpret_cast<float2*>(srow + nt * 8) = make_float2(s[nt][0], s[nt][1]);
        *reinterpret_cast<float2*>(srow + 8 * ss + nt * 8) = make_float2(s[nt][2], s[nt][3]);
      }
      // k-column t is key 2t and t + 4 is key 2t + 1 (see the note above)
      uint32_t ab[4], as[4];
      split_tf32(s[nt][0], ab[0], as[0]);
      split_tf32(s[nt][2], ab[1], as[1]);
      split_tf32(s[nt][1], ab[2], as[2]);
      split_tf32(s[nt][3], ab[3], as[3]);
      // keys 2t, 2t + 1 of feature g of each 8-feature tile: [big | big |
      // small | small]
      const float* vk = vs + g * OP_VROW + (nt * 4 + t) * 4;
      uint4 w[VTM];
#pragma unroll
      for (int vt = 0; vt < VTM; ++vt)
        if (VT || vt < v_tiles) w[vt] = *reinterpret_cast<const uint4*>(vk + vt * 8 * OP_VROW);
#pragma unroll
      for (int vt = 0; vt < VTM; ++vt)
        if (VT || vt < v_tiles) mma_tf32(o[vt], as, w[vt].x, w[vt].y);
#pragma unroll
      for (int vt = 0; vt < VTM; ++vt)
        if (VT || vt < v_tiles) mma_tf32(o[vt], ab, w[vt].z, w[vt].w);
#pragma unroll
      for (int vt = 0; vt < VTM; ++vt)
        if (VT || vt < v_tiles) mma_tf32(o[vt], ab, w[vt].x, w[vt].y);
    }
    if (t == 0) {
      mrow[(m0 + g) * nch + c] = m_run[0];
      mrow[(m0 + g + 8) * nch + c] = m_run[1];
    }
  }
  if (!active) return;

  // the rows' l, 1 / l on o, and each chunk's factor exp(m_chunk - m) / l
  float inv_l[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 1);
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 2);
    inv_l[hr] = 1.f / l_run[hr];
  }
#pragma unroll
  for (int vt = 0; vt < VTM; ++vt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[vt][e] *= inv_l[e >> 1];
  __syncwarp();  // every lane's strip rows and chunk maxima are in
  if (t == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float* mr = mrow + (m0 + g + hr * 8) * nch;
      for (int c = 0; c < n_chunks; ++c) mr[c] = expf(mr[c] - m_run[hr]) * inv_l[hr];
    }
  }
  __syncwarp();
  // attn rows i0 .. i0 + rows - 1, keys < L, once
  const int rows = L - i0 < 16 ? L - i0 : 16;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const float* sr = strip + (m0 + r) * ss;
    const float* fr = mrow + (m0 + r) * nch;
    float* dst = attn_h + (size_t)(i0 + r) * L;
    if (attn_vec) {
      for (int j = 4 * lane; j < L; j += 128) {
        const float f = fr[j / OP_KC];
        const float4 w = *reinterpret_cast<const float4*>(sr + j);
        *reinterpret_cast<float4*>(dst + j) = make_float4(w.x * f, w.y * f, w.z * f, w.w * f);
      }
    } else {
      for (int j = lane; j < L; j += 32) dst[j] = sr[j] * fr[j / OP_KC];
    }
  }
  __syncwarp();  // the strip rows are free for the caller
}

}  // namespace ipa_tc
