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

constexpr int MAX_L = 128;                // keys and query rows per (design, head)
constexpr int MAX_FV = 64;                // ds + 3P
constexpr int MAX_F = 80;                 // augmented features (ds + 3P + 3 padded to 16)
constexpr int MAX_KEY_TILES = MAX_L / 8;  // 8-key tiles of one warp's logits
constexpr int MAX_V_TILES = MAX_FV / 8;   // 8-feature tiles of its outputs

// ---- tiles -------------------------------------------------------------------
// rows x cols tile at dst (row stride `stride`) from a row-major source of
// rows_valid rows of L elements, its first cols columns; zeros outside the
// source.  vec (L % 8 == 0): 16-byte cp.async pieces, each wholly
// inside or outside the source; otherwise element by element.  The caller
// waits (cp_async_wait_all) and synchronises.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int rows_valid,
                                          int rows, int L, int cols, int stride,
                                          bool vec, int tid, int n_threads) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);
    const int pieces = cols / PER;
    for (int e = tid; e < rows * pieces; e += n_threads) {
      const int r = e / pieces, c = (e - r * pieces) * PER;
      T* d = dst + r * stride + c;
      if (r < rows_valid && c < L)
        cp_async16(d, src + (size_t)r * L + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int e = tid; e < rows * cols; e += n_threads) {
      const int r = e / cols, c = e - r * cols;
      dst[r * stride + c] =
          r < rows_valid && c < L ? src[(size_t)r * L + c] : from_f<T>(0.f);
    }
  }
}

// ---- the warp's attention core -----------------------------------------------

// s = Q_aug K_aug^T for the warp's 16 query rows (columns qcol .. qcol + 15
// of qa) against all LP keys
template <typename T>
__device__ __forceinline__ void logits(const T* __restrict__ qa, int qs, int qcol,
                                       const T* __restrict__ ka, int ks, int FP, int LP,
                                       int lane, float (&s)[MAX_KEY_TILES][4]) {
  const int key_tiles = LP / 8;
#pragma unroll
  for (int nt = 0; nt < MAX_KEY_TILES; ++nt)
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
        for (int np = 0; np < MAX_KEY_TILES / 2; ++np) {
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
        for (int nt = 0; nt < MAX_KEY_TILES; ++nt) {
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

// s <- softmax_j((s + bias) * scale_total) in float32 for the warp's rows
// m0 .. m0 + 15 (bias rows read for rows < L only), keys >= L weight 0;
// the weights are left rounded to T.  One reciprocal per row: a division per
// weight takes the slow path on the many denormal exponentials of a peaked
// row, and e * (1 / sum) is within one f32 ulp of the quotient.
template <typename T, typename TB>
__device__ __forceinline__ void softmax_rows(float (&s)[MAX_KEY_TILES][4],
                                             const TB* __restrict__ bias_h, int L, int LP,
                                             int m0, float scale_total, int lane) {
  const int key_tiles = LP / 8, r0 = m0 + lane / 4;
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

// The weights of rows m0 .. m0 + 15 (those < L) to attn_h (L x L, row
// major).  bf16: through this warp's tile (16 x as) for row-contiguous
// 16-byte stores.  float32: straight from the accumulators, 8 bytes a
// thread, four neighbours filling one 32-byte sector of a row (staging
// them through shared memory for 16-byte stores was slower on the H100).
template <typename T>
__device__ __forceinline__ void store_weights(const float (&s)[MAX_KEY_TILES][4],
                                              T* __restrict__ attn_h, int L, int LP, int m0,
                                              int lane, T* tile, int as) {
  const int key_tiles = LP / 8, g = lane / 4, c2 = (lane & 3) * 2;
  if constexpr (is_bf16<T>) {
#pragma unroll
    for (int nt = 0; nt < MAX_KEY_TILES; ++nt) {
      if (nt < key_tiles) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<__nv_bfloat162*>(tile + (g + hr * 8) * as + nt * 8 + c2) =
              __floats2bfloat162_rn(s[nt][2 * hr], s[nt][2 * hr + 1]);
      }
    }
    __syncwarp();
    const int rows = L - m0 < 16 ? L - m0 : 16;
    if (L % 8 == 0) {  // a warp writes 512 contiguous bytes at a time
      const int per_row = L / 8;
      for (int e = lane; e < rows * per_row; e += 32) {
        const int r = e / per_row, c = 8 * (e - r * per_row);
        *reinterpret_cast<uint4*>(attn_h + (size_t)(m0 + r) * L + c) =
            *reinterpret_cast<const uint4*>(tile + r * as + c);
      }
    } else {
      for (int e = lane; e < rows * L; e += 32) {
        const int r = e / L, c = e - r * L;
        attn_h[(size_t)(m0 + r) * L + c] = tile[r * as + c];
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < MAX_KEY_TILES; ++nt) {
      if (nt < key_tiles) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = m0 + g + hr * 8, j = nt * 8 + c2;
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

// o = P [v_s | v_p] for the warp's rows: the weights from registers, V
// ([feature][key], stride vs) from shared memory
template <typename T>
__device__ __forceinline__ void weighted_sums(const float (&s)[MAX_KEY_TILES][4],
                                              const T* __restrict__ va, int vs, int FVP, int LP,
                                              int lane, float (&o)[MAX_V_TILES][4]) {
  const int key_tiles = LP / 8, v_tiles = FVP / 8;
#pragma unroll
  for (int vt = 0; vt < MAX_V_TILES; ++vt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[vt][e] = 0.f;
  if constexpr (is_bf16<T>) {
#pragma unroll
    for (int kk = 0; kk < MAX_KEY_TILES / 2; ++kk) {
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
    for (int nt = 0; nt < MAX_KEY_TILES; ++nt) {
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

}  // namespace ipa_tc
