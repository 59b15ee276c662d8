// The fused IPA layer's epilogue, shared by its kernels (launch 1 of both
// dtype routes, ipa_fused_layer_bf16.cuh and ipa_fused_layer_f32.cuh, and
// the long-patch attention kernels of ipa_fused_layer.cu): from a warp's
// weighted sums [out_s | out_p] to the head's features [out_s | loc | nrm]
// in feat, through the inverse frames and the point norms; with DIR (the
// official DiffAb block's point directions) [out_s | loc | nrm | dir],
// dir = loc / (nrm + 1e-4).  Without DIR the direction code is compiled
// out.

#pragma once

#include "ptx.cuh"

#include <cmath>

namespace ipa_layer {

using namespace ptx;

// The head's features [out_s | loc | nrm (| dir) | 0 pad] (FH columns) of
// `rows` rows: inverse frames and point norms of the f32 outputs (feature c
// of row r at ot[r rstr + c cstr]) with the rows' frames (rs: 9, tr: 3
// floats a row); row r goes to feat[r fstride .. + FH - 1] in TO
template <typename TO, bool DIR = false>
__device__ __forceinline__ void write_features(const float* ot, int rstr, int cstr,
                                               const float* rs, const float* tr, int rows,
                                               int ds, int p, int FH, TO* __restrict__ feat,
                                               size_t fstride, int lane) {
  // lane owns feature columns 2 cp and 2 cp + 1 of every row: out_s (kind
  // 0), coordinate kc of point pp's loc (1), point pp's norm (2), zero (3);
  // with DIR, coordinate kc of point pp's direction (4) before the zeros
  for (int cp = lane; cp < FH / 2; cp += 32) {
    int kind[2], kc[2], pp[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = 2 * cp + u, q = c - ds;
      kind[u] = c < ds ? 0 : c < ds + 3 * p ? 1 : c < ds + 4 * p ? 2 : 3;
      if constexpr (DIR) {
        if (c >= ds + 4 * p && c < ds + 7 * p) kind[u] = 4;
      }
      kc[u] = kind[u] == 1 ? q / p : 0;
      pp[u] = kind[u] == 1 ? q - kc[u] * p : kind[u] == 2 ? q - 3 * p : 0;
      if constexpr (DIR) {
        if (kind[u] == 4) kc[u] = (q - 4 * p) / p, pp[u] = q - 4 * p - kc[u] * p;
      }
    }
    for (int r = 0; r < rows; ++r) {
      const float* orr = ot + r * rstr;
      const float* R = rs + r * 9;
      const float t0 = tr[r * 3], t1 = tr[r * 3 + 1], t2 = tr[r * 3 + 2];
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {  // every lane takes one path: no divergence
        const float d0 = orr[(ds + pp[u]) * cstr] - t0, d1 = orr[(ds + p + pp[u]) * cstr] - t1,
                    d2 = orr[(ds + 2 * p + pp[u]) * cstr] - t2;
        const float l0 = d0 * R[0] + d1 * R[1] + d2 * R[2];
        const float l1 = d0 * R[3] + d1 * R[4] + d2 * R[5];
        const float l2 = d0 * R[6] + d1 * R[7] + d2 * R[8];
        float nrm = 0.f;
        nrm += l0 * l0;
        nrm += l1 * l1;
        nrm += l2 * l2;
        const float loc = kc[u] == 0 ? l0 : kc[u] == 1 ? l1 : l2;
        const float sc = orr[(kind[u] == 0 ? 2 * cp + u : 0) * cstr];
        v[u] = kind[u] == 0 ? sc : kind[u] == 1 ? loc : kind[u] == 2 ? sqrtf(nrm + 1e-8f) : 0.f;
        if constexpr (DIR) {
          if (kind[u] == 4) v[u] = loc / (sqrtf(nrm + 1e-8f) + 1e-4f);
        }
      }
      store2<TO>(feat + r * fstride + 2 * cp, v[0], v[1]);
    }
  }
}

// The same features of `rows` rows, float32, with work split by item
// rather than by column: a lane takes (row, point) items, point pp of row
// r computing its inverse frame, norm (and direction) once, and (row,
// column) items for the scalars and the zero pad, which it copies.  The
// same expressions as write_features, so the same values; for the
// one-pass attention kernel (ipa_fused_layer.cu), where write_features'
// per-column lanes, each recomputing a row's rotation for every column,
// took a fifth of the block's time, and the float32 launch 1 at L <= 128
// (feature c of row r at ot[r rstr + c cstr]).  Consecutive lanes write
// consecutive columns of a row (points pp of one coordinate, scalars c).
template <bool DIR = false>
__device__ __forceinline__ void write_features_by_item(const float* ot, int rstr,
                                                       const float* rs, const float* tr,
                                                       int rows, int ds, int p, int FH,
                                                       float* __restrict__ feat,
                                                       size_t fstride, int lane,
                                                       int cstr = 1) {
  const int pc = ds + (DIR ? 7 : 4) * p, ns = ds + FH - pc;  // scalar and pad columns
  for (int it = lane; it < rows * ns; it += 32) {
    const int r = it / ns, c0 = it - r * ns, c = c0 < ds ? c0 : c0 - ds + pc;
    feat[r * fstride + c] = c0 < ds ? ot[r * rstr + c * cstr] : 0.f;
  }
  for (int it = lane; it < rows * p; it += 32) {
    const int r = it / p, pp = it - r * p;
    const float* orr = ot + r * rstr;
    const float* R = rs + r * 9;
    const float d0 = orr[(ds + pp) * cstr] - tr[r * 3],
                d1 = orr[(ds + p + pp) * cstr] - tr[r * 3 + 1],
                d2 = orr[(ds + 2 * p + pp) * cstr] - tr[r * 3 + 2];
    const float l0 = d0 * R[0] + d1 * R[1] + d2 * R[2];
    const float l1 = d0 * R[3] + d1 * R[4] + d2 * R[5];
    const float l2 = d0 * R[6] + d1 * R[7] + d2 * R[8];
    float nrm = 0.f;
    nrm += l0 * l0;
    nrm += l1 * l1;
    nrm += l2 * l2;
    const float n = sqrtf(nrm + 1e-8f);
    float* fr = feat + r * fstride + ds + pp;
    fr[0] = l0, fr[p] = l1, fr[2 * p] = l2, fr[3 * p] = n;
    if constexpr (DIR) fr[4 * p] = l0 / (n + 1e-4f), fr[5 * p] = l1 / (n + 1e-4f),
                       fr[6 * p] = l2 / (n + 1e-4f);
  }
}

}  // namespace ipa_layer
