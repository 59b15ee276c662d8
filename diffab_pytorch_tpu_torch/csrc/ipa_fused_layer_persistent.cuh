// Launch 1 of the bfloat16 fused IPA layer as a persistent, warp-specialised
// kernel on wgmma (sm_90a), for calls with many (head, design) items: one
// block per SM walks a contiguous, head-major range of the b h items.
// Included by ipa_fused_layer.cu, which documents the layer, owns the entry
// points and runs this kernel or tc::layer_heads_kernel
// (ipa_fused_layer_bf16.cuh) as the wrapper chose (ops/ipa_fused_layer.py
// takes_persistent); launch 2 (tc::out_proj_kernel) is the same for both.
//
// Why: tc::layer_heads_kernel runs one (head, design) per block of 8 warps,
// its phases one after another with barriers between them; all its warps
// reach the softmax, the MUFU work and the attn store together, and its
// operand and feature phases go through shared memory a column at a time.
// It is bound by latency, far below the tensor cores' and the memory's
// peaks.  Here each block holds two items in flight, one per consumer
// warpgroup, a producer warp loads the next items ahead of use, and every
// phase between the products stays in registers:
//
//   producer (warpgroup 0; warp 0 loads, the others give their registers
//     back): consumer c's next x rows (cp.async, 16 bytes each, into K-major
//     core matrices) and frames, translations and mask (bf16 as they are,
//     two slots a consumer) once c's last projection is done; the head's W_h
//     (cp.async, MN-major core matrices), resident, only when the walk
//     crosses into a new head and every earlier item's projection is done.
//     mbarriers carry each hand-over.
//   consumers (warpgroups 1 and 2) take items first + c, first + c + 2, ...
//     and walk each item's 128 rows as two m64 halves:
//     a. the half's Q/K/V projection x W_h on wgmma, three m64n64k16
//        products per 16-deep slice of d, f32 accumulators;
//     b. the operands from the accumulators: with P = 8 a thread's columns
//        hold whole points (x, y, z of point pp in columns ds + pp,
//        ds + 8 + pp, ds + 16 + pp), so frames, g folding and the point
//        norms (a quad's shuffles, summed in point order) need no staging;
//        q_aug, k_aug (128 x 64, K-major) and v (128 keys x 64 features,
//        MN-major) go to shared memory in bf16, two columns a store;
//     c. per half, the logits Q_aug K_aug^T on wgmma while the bias loads are
//        in flight, then bias, scale and the float32 softmax in registers
//        (keys >= L weight exactly 0);
//     d. P [v_s | v_p] on wgmma with P from registers, while the weights are
//        written to attn from the same registers;
//     e. the epilogue in registers: inverse frames, norms and the head's
//        features [out_s | loc | nrm] (FH = 64) to feat.
//   While one warpgroup waits on its asynchronous products or loads, the
//   other runs its softmax, stores and epilogue.
//
// The arithmetic is tc::layer_heads_kernel's and the Pallas kernel's: the
// augmented operands, the attention weights and the output-projection
// operands in bf16, everything else in float32 in the same order, keys >= L
// at weight exactly 0; only the order of the float32 sums inside a product
// differs.
//
// Shapes taken (the wrapper's rule, takes_persistent): L <= 128, ds = 32 and
// P = 8 (DS and P below: each q / k / v part fills 64 columns with the three
// augmented ones, and each point's coordinates fall in one thread), d % 8 ==
// 0 and 16-byte aligned x rows (cp.async), and persistent_dims(d).total
// within the 227 KB of one block.  Every item pads to 128 rows.  Shared
// memory (persistent_dims): the mbarriers, W_h (192 x KD bf16, KD = d
// rounded up to 16), then per consumer its x rows (128 x KD bf16), its
// operand tiles (3 x 16 KB) and two slots of frames, translations and mask
// (13 x 128 bf16).  At d = 128: 226,432 bytes, one block per SM.

#pragma once

#include "ptx.cuh"

#include <cmath>

namespace tc_pp {

using namespace ptx;

constexpr int DS = 32, P = 8;               // scalar columns and points of a head
constexpr int FV = DS + 3 * P;              // 56 value columns; 59 augmented
constexpr int FH = DS + 4 * P;              // 64 feature columns
constexpr int ROWS = 128;                   // an item's rows and keys, padded
constexpr int NV = 64;                      // columns of a q / k / v part
constexpr int THREADS = 3 * 128;            // a producer warpgroup, two consumer warpgroups
constexpr int PRODUCER_REGS = 40;           // registers a thread, after setmaxnreg
constexpr int CONSUMER_REGS = 232;
constexpr int TILE_BYTES = ROWS * NV * 2;   // one 128 x 64 bf16 operand tile
constexpr int FRAME_BYTES = 13 * ROWS * 2;  // rot (9), trans (3), mask (1) a row
constexpr int BAR_BYTES = 128;
constexpr int SMEM_LIMIT = 232448;

struct Dims {
  int L, d, KD, h;
  int w_bytes, x_bytes, consumer_bytes, total;
};

__host__ __device__ inline Dims persistent_dims(int L, int d, int h) {
  Dims D;
  D.L = L, D.d = d, D.KD = round_up(d, 16), D.h = h;
  D.w_bytes = 3 * NV * D.KD * 2;
  D.x_bytes = ROWS * D.KD * 2;
  D.consumer_bytes = D.x_bytes + 3 * TILE_BYTES + 2 * FRAME_BYTES;
  D.total = BAR_BYTES + D.w_bytes + 2 * D.consumer_bytes;
  return D;
}

// byte offsets in tiles of 8 x 8 core matrices (16-bit values):
// K-major, (row r, column c) of rows of `cols` columns: core matrices along a
// row 128 bytes apart, groups of 8 rows 16 cols bytes
__device__ __forceinline__ int km_off(int r, int c, int cols) {
  return (r >> 3) * (cols * 16) + (c >> 3) * 128 + (r & 7) * 16 + (c & 7) * 2;
}
// MN-major, (k, n) with `kdim` rows of k: groups of 8 k 128 bytes apart,
// groups of 8 n 16 kdim bytes
__device__ __forceinline__ int mn_off(int k, int n, int kdim) {
  return (n >> 3) * (kdim * 16) + (k >> 3) * 128 + (k & 7) * 16 + (n & 7) * 2;
}
__device__ __forceinline__ void st_pair(unsigned char* tile, int off, float a, float b) {
  *reinterpret_cast<uint32_t*>(tile + off) = pack_bf16(a, b);
}
__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float ld_bf(const bf16* p) { return __bfloat162float(*p); }

// Two neighbouring bias values as loaded (one 32-bit word), and as f32
struct BiasPair {
  uint32_t w;
  __device__ __forceinline__ void load(const bf16* p, bool pair, const bf16* q) {
    w = pair ? *reinterpret_cast<const uint32_t*>(p)
             : (uint32_t)*reinterpret_cast<const unsigned short*>(p) |
                   ((uint32_t)*reinterpret_cast<const unsigned short*>(q) << 16);
  }
  __device__ __forceinline__ float lo() const { return __uint_as_float(w << 16); }
  __device__ __forceinline__ float hi() const { return __uint_as_float(w & 0xffff0000u); }
};

// A row's 4-byte words w[k] (columns 8 (4 m + k) + 2 tq, +1 in lane tq of a
// quad) turned so that lane tq holds tile 4 m + tq's 16 bytes (its word k:
// columns 8 (4 m + tq) + 2 k, +1): a 4 x 4 transpose across the quad in two
// butterfly steps, for 16-byte stores
__device__ __forceinline__ uint4 quad_transpose(uint32_t w0, uint32_t w1, uint32_t w2,
                                                uint32_t w3, int tq) {
  const bool b0 = tq & 1, b1 = tq & 2;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, b0 ? w0 : w1, 1);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, b0 ? w2 : w3, 1);
  const uint32_t v0 = b0 ? r0 : w0, v1 = b0 ? w1 : r0, v2 = b0 ? r1 : w2, v3 = b0 ? w3 : r1;
  r0 = __shfl_xor_sync(0xffffffffu, b1 ? v0 : v2, 2);
  r1 = __shfl_xor_sync(0xffffffffu, b1 ? v1 : v3, 2);
  return make_uint4(b1 ? r0 : v0, b1 ? r1 : v1, b1 ? v2 : r0, b1 ? v3 : r1);
}

// The items of block blk of G: [first, last) of b h, head-major (item
// hh b + design); ops/ipa_fused_layer.py persistent_counts counts from them.
__device__ __forceinline__ void block_items(long long items, int blk, int G, long long& first,
                                            long long& last) {
  first = items * blk / G;
  last = items * (blk + 1) / G;
}

__global__ void __launch_bounds__(THREADS, 1)
persistent_layer_heads_kernel(const bf16* __restrict__ x,      // (b, L, d)
                              const bf16* __restrict__ rot,    // (b, L, 3, 3)
                              const bf16* __restrict__ trans,  // (b, L, 3)
                              const bf16* __restrict__ mask,   // (b, L)
                              const bf16* __restrict__ w_qkv,  // (h, d, 3 FV)
                              const float* __restrict__ g,     // (h,)
                              const bf16* __restrict__ bias,   // (bp, h, L, L)
                              bf16* __restrict__ feat,         // (b L, h FH)
                              bf16* __restrict__ attn,         // (b, h, L, L)
                              const Dims D, int b, int n_designs, float scale_total,
                              float nk_scale, int frames_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full_x = bars;       // [2] producer -> consumer c: its next item landed
  uint64_t* empty_x = bars + 2;  // [2] consumer c: its projection is done, x is free
  uint64_t* full_w = bars + 4;   // producer -> consumers: the head's W_h landed
  unsigned char* w_tile = smem + BAR_BYTES;

  const int L = D.L, d = D.d, KD = D.KD, h = D.h;
  long long first, last;
  block_items((long long)b * h, blockIdx.x, gridDim.x, first, last);
  const int head0 = (int)(first / b);
  // the warp index through a shuffle: the compiler then knows it is the same
  // on every lane, so no branch on it counts as divergent around a wgmma
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int c = 0; c < 2; ++c) {
      mbar_init(&full_x[c], 64);  // the producer's lanes: once their copies land, and
                                  // once their plain stores are done
      mbar_init(&empty_x[c], 128);
    }
    mbar_init(full_w, 32);
  }
  __syncthreads();

  auto x_tile = [&](int c) { return smem + BAR_BYTES + D.w_bytes + c * D.consumer_bytes; };
  // frames slot s of consumer c
  auto frames = [&](int c, int s) {
    return reinterpret_cast<bf16*>(x_tile(c) + D.x_bytes + 3 * TILE_BYTES + s * FRAME_BYTES);
  };

  if (warp < 4) {
    // ---- producer ------------------------------------------------------------------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > 0) return;
    int loaded_head = -1;
    for (long long j = first; j < last; ++j) {
      const int c = (int)((j - first) & 1), kc = (int)((j - first) >> 1);
      const int hh = (int)(j / b), design = (int)(j % b);
      // consumer c is past item j - 2's projection, so done with item j - 4
      // (the other frames slot) and with its x rows
      if (kc >= 1) mbar_wait(&empty_x[c], (kc - 1) & 1);
      if (hh != loaded_head) {
        if (j > first) {  // item j - 1 (the other consumer's) is past its projection
          const long long jp = j - 1 - first;
          mbar_wait(&empty_x[jp & 1], (uint32_t)((jp >> 1) & 1));
        }
        // W_h, MN-major: tile column part 64 + n is w_qkv column part FV + n
        const bf16* wg = w_qkv + (size_t)hh * d * 3 * FV;
        for (int kg = 0; kg < KD / 8; ++kg) {
          const int k = kg * 8 + (lane & 7);
          for (int ng = lane >> 3; ng < 3 * NV / 8; ng += 4) {
            const int part = ng / (NV / 8), n = (ng % (NV / 8)) * 8;
            const bool ok = k < d && n < FV;
            cp_async16(w_tile + mn_off(k, ng * 8, KD),
                       ok ? wg + (size_t)k * 3 * FV + part * FV + n : wg, ok);
          }
        }
        mbar_arrive_cp_async(full_w);
        loaded_head = hh;
      }
      // x rows, K-major: a warp's copies take 8 rows x 4 chunks of 16 bytes
      unsigned char* X = x_tile(c);
      const bf16* xg = x + (size_t)design * L * d;
      for (int r = lane & 7; r < ROWS; r += 8) {
        for (int kk = lane >> 3; kk < KD / 8; kk += 4) {
          const bool ok = r < L && kk * 8 < d;
          cp_async16(X + km_off(r, kk * 8, KD), ok ? xg + (size_t)r * d + kk * 8 : xg, ok);
        }
      }
      // the frames, translations and mask, bf16 as they are, rows >= L zero:
      // 16-byte copies where every design's rows start on 16 bytes
      bf16* fr = frames(c, kc & 1);
      const size_t row_base = (size_t)design * L;
      if (frames_vec) {
        for (int e = lane; e < 13 * ROWS / 8; e += 32) {
          const int f = e < 9 * ROWS / 8 ? 0 : e < 12 * ROWS / 8 ? 1 : 2;
          const int width = f == 0 ? 9 : f == 1 ? 3 : 1;
          const int ce = 8 * e - (f == 0 ? 0 : f == 1 ? 9 * ROWS : 12 * ROWS);
          const bf16* src = f == 0 ? rot : f == 1 ? trans : mask;
          const bool ok = ce < L * width;
          cp_async16(fr + 8 * e, ok ? src + row_base * width + ce : src, ok);
        }
      } else {
        for (int e = lane; e < 13 * ROWS; e += 32) {
          const int f = e < 9 * ROWS ? 0 : e < 12 * ROWS ? 1 : 2;
          const int width = f == 0 ? 9 : f == 1 ? 3 : 1;
          const int ce = e - (f == 0 ? 0 : f == 1 ? 9 * ROWS : 12 * ROWS);
          const bf16* src = f == 0 ? rot : f == 1 ? trans : mask;
          fr[e] = ce < L * width ? src[row_base * width + ce] : __float2bfloat16_rn(0.f);
        }
      }
      mbar_arrive_cp_async(&full_x[c]);
      mbar_arrive(&full_x[c]);
    }
    cp_async_wait_all();
    return;
  }

  // ---- consumers -------------------------------------------------------------------
  setmaxnreg_inc<CONSUMER_REGS>();
  const int c = warp / 4 - 1, wq = warp % 4;
  const int gq = lane / 4, tq = lane % 4;
  unsigned char* X = x_tile(c);
  unsigned char* qt = X + D.x_bytes;    // q_aug: 128 rows x 64, K-major
  unsigned char* kt = qt + TILE_BYTES;  // k_aug: 128 keys x 64, K-major
  unsigned char* vt = kt + TILE_BYTES;  // v: 128 keys x 64 features, MN-major

  int kc = 0;
  for (long long j = first + c; j < last; j += 2, ++kc) {
    const int hh = (int)(j / b), design = (int)(j % b), target = design / n_designs;
    const float g_t = rnd(g[hh]);
    const size_t row_base = (size_t)design * L;
    const bf16* rs = frames(c, kc & 1);  // rot, 9 a row
    const bf16* ts = rs + 9 * ROWS;      // trans, 3 a row
    const bf16* ms = rs + 12 * ROWS;     // mask
    mbar_wait(&full_x[c], kc & 1);
    mbar_wait(full_w, (uint32_t)((hh - head0) & 1));
    fence_proxy_async();

    // ---- a, b. projection and operands, one half at a time --------------------------
    for (int hf = 0; hf < 2; ++hf) {
      float acc[3][32];
      wgmma_fence();
      for (int ks = 0; ks < KD / 16; ++ks) {
        const uint64_t da = gmma_desc(X + hf * 8 * (KD * 16) + ks * 256, 128, KD * 16);
#pragma unroll
        for (int part = 0; part < 3; ++part)
          wgmma_ss<1>(acc[part], da,
                      gmma_desc(w_tile + part * NV * (KD * 2) + ks * 256, 128, KD * 16),
                      ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int part = 0; part < 3; ++part) wgmma_hold(acc[part]);
      if (hf == 0) named_bar_sync(1 + c, 128);  // every warp is done with the last item's tiles
      else mbar_arrive(&empty_x[c]);            // the x rows are free

#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int l = hf * 64 + 16 * wq + gq + 8 * hr;  // this thread's row
        float R[9], t[3];
#pragma unroll
        for (int e = 0; e < 9; ++e) R[e] = ld_bf(rs + l * 9 + e);
#pragma unroll
        for (int e = 0; e < 3; ++e) t[e] = ld_bf(ts + l * 3 + e);
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          unsigned char* tile = part == 0 ? qt : part == 1 ? kt : vt;
          auto put = [&](int col, float a, float bv) {
            st_pair(tile, part < 2 ? km_off(l, col, NV) : mn_off(l, col, ROWS), a, bv);
          };
          const float* A = acc[part];
          // scalar columns 0..31
#pragma unroll
          for (int vt8 = 0; vt8 < DS / 8; ++vt8)
            put(vt8 * 8 + 2 * tq, A[4 * vt8 + 2 * hr], A[4 * vt8 + 2 * hr + 1]);
          // points 2 tq and 2 tq + 1: x, y, z in column tiles 4, 5, 6
          float tg[3];
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) tg[cc] = part < 2 ? rnd(t[cc] * g_t) : t[cc];
          float v[3][2], s3[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p0 = A[16 + 2 * hr + e], p1 = A[20 + 2 * hr + e],
                        p2 = A[24 + 2 * hr + e];
            s3[e] = 0.f;
#pragma unroll
            for (int cc = 0; cc < 3; ++cc) {
              v[cc][e] = p0 * R[cc] + p1 * R[3 + cc] + p2 * R[6 + cc] + tg[cc];
              s3[e] += v[cc][e] * v[cc][e];
            }
          }
          const float sc = part == 0 ? 2.f : 1.f;
#pragma unroll
          for (int cc = 0; cc < 3; ++cc)
            put(DS + cc * P + 2 * tq, sc * v[cc][0], sc * v[cc][1]);
          // columns 56..63: q [-|q|^2, -1, 1, 0...], k [1, |k|^2, key mask, 0...], v 0
          float a0 = 0.f, a1 = 0.f;
          if (part < 2) {
            float sq = 0.f;  // in point order, as tc::layer_heads_kernel sums it
#pragma unroll
            for (int src = 0; src < 4; ++src) {
              sq += __shfl_sync(0xffffffffu, s3[0], (lane & ~3) | src);
              sq += __shfl_sync(0xffffffffu, s3[1], (lane & ~3) | src);
            }
            if (part == 0) {
              a0 = tq == 0 ? -sq : tq == 1 ? 1.f : 0.f;
              a1 = tq == 0 ? -1.f : 0.f;
            } else {
              const float nk = l < L ? rnd((ld_bf(ms + l) - 1.f) * nk_scale) : 0.f;
              a0 = tq == 0 ? 1.f : tq == 1 ? nk : 0.f;
              a1 = tq == 0 ? sq : 0.f;
            }
          }
          put(FV + 2 * tq, a0, a1);
        }
      }
    }
    fence_proxy_async();  // the tiles, written by these threads, read by wgmma
    named_bar_sync(1 + c, 128);

    // ---- c, d, e. attention, one half of the query rows at a time -------------------
    const bf16* bias_h = bias + ((size_t)target * h + hh) * L * L;
    bf16* attn_h = attn + ((size_t)design * h + hh) * L * L;
    bf16* feat_h = feat + row_base * h * FH + (size_t)hh * FH;
    const bool even = L % 2 == 0;
    // the bias of a half's logits in this thread's places (rows >= L read row
    // L - 1, keys >= L are masked below: no branches)
    auto load_bias = [&](int hf, BiasPair (&bp)[16][2]) {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = min(hf * 64 + 16 * wq + gq + hr * 8, L - 1), jj = nt * 8 + 2 * tq;
          const bf16* src = bias_h + (size_t)i * L;
          if (even) bp[nt][hr].load(src + min(jj, L - 2), true, nullptr);
          else bp[nt][hr].load(src + min(jj, L - 1), false, src + min(jj + 1, L - 1));
        }
      }
    };
    for (int hf = 0; hf < 2; ++hf) {
      float s[2][32];  // keys 0-63, 64-127
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < NV / 16; ++ks) {
        const uint64_t da = gmma_desc(qt + hf * 8 * (NV * 16) + ks * 256, 128, NV * 16);
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
          wgmma_ss<0>(s[kh], da, gmma_desc(kt + kh * 8 * (NV * 16) + ks * 256, 128, NV * 16),
                      ks > 0);
      }
      wgmma_commit();
      BiasPair bb[16][2];  // loaded while the products run
      load_bias(hf, bb);
      const int r0 = hf * 64 + 16 * wq + gq;  // rows r0 and r0 + 8
      wgmma_wait<0>();
      wgmma_hold(s[0]);
      wgmma_hold(s[1]);

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = nt * 8 + 2 * tq + (e & 1);
          float& v = s[nt / 8][(nt % 8) * 4 + e];
          const float bv = e & 1 ? bb[nt][e >> 1].hi() : bb[nt][e >> 1].lo();
          v = jj < L ? (v + bv) * scale_total : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      }
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& v = s[nt / 8][(nt % 8) * 4 + e];
          v = expf(v - mx[e >> 1]);
          sum[e >> 1] += v;
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
        sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
        sum[hr] = 1.f / sum[hr];  // as tc::layer_heads_kernel: one division per row
      }
      // the rounded weights, as P's A fragments for the weighted sums
      uint32_t pa[8][4];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          pa[nt / 2][(nt % 2) * 2 + hr] = pack_bf16(s[nt / 8][(nt % 8) * 4 + 2 * hr] * sum[hr],
                                                    s[nt / 8][(nt % 8) * 4 + 2 * hr + 1] * sum[hr]);

      // P [v_s | v_p] (v MN-major: keys along K)
      float o[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < ROWS / 16; ++ks)
        wgmma_rs<1>(o, pa[ks], gmma_desc(vt + ks * 256, 128, ROWS * 16), ks > 0);
      wgmma_commit();

      // the weights to attn, while the products run: 16 bytes a store where
      // rows are whole 16-byte pieces
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = r0 + hr * 8;
        bf16* arow = attn_h + (size_t)i * L;
        if (L % 8 == 0) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const uint4 q = quad_transpose(pa[2 * m][hr], pa[2 * m][2 + hr],
                                           pa[2 * m + 1][hr], pa[2 * m + 1][2 + hr], tq);
            if (i < L && 8 * (4 * m + tq) < L)
              *reinterpret_cast<uint4*>(arow + 8 * (4 * m + tq)) = q;
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const int jj = nt * 8 + 2 * tq;
            const uint32_t w2 = pa[nt / 2][(nt % 2) * 2 + hr];
            if (i < L && jj < L) *reinterpret_cast<unsigned short*>(arow + jj) = w2 & 0xffffu;
            if (i < L && jj + 1 < L) *reinterpret_cast<unsigned short*>(arow + jj + 1) = w2 >> 16;
          }
        }
      }
      wgmma_wait<0>();
      wgmma_hold(o);

      // ---- e. epilogue: inverse frames, norms, features [out_s | loc | nrm] ----------
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int l = r0 + hr * 8;
        const bool ok = l < L;  // rows >= L: zero frames, nothing stored
        bf16* fo = feat_h + (size_t)l * h * FH;
        float R[9], t[3];
#pragma unroll
        for (int e = 0; e < 9; ++e) R[e] = ld_bf(rs + l * 9 + e);
#pragma unroll
        for (int e = 0; e < 3; ++e) t[e] = ld_bf(ts + l * 3 + e);
        uint32_t out[FH / 8];
#pragma unroll
        for (int vt8 = 0; vt8 < DS / 8; ++vt8)
          out[vt8] = pack_bf16(o[4 * vt8 + 2 * hr], o[4 * vt8 + 2 * hr + 1]);
        float loc[3][2], nrm[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d0 = o[16 + 2 * hr + e] - t[0], d1 = o[20 + 2 * hr + e] - t[1],
                      d2 = o[24 + 2 * hr + e] - t[2];
          loc[0][e] = d0 * R[0] + d1 * R[1] + d2 * R[2];
          loc[1][e] = d0 * R[3] + d1 * R[4] + d2 * R[5];
          loc[2][e] = d0 * R[6] + d1 * R[7] + d2 * R[8];
          float n2 = 0.f;
          n2 += loc[0][e] * loc[0][e];
          n2 += loc[1][e] * loc[1][e];
          n2 += loc[2][e] * loc[2][e];
          nrm[e] = sqrtf(n2 + 1e-8f);
        }
#pragma unroll
        for (int k3 = 0; k3 < 3; ++k3) out[DS / 8 + k3] = pack_bf16(loc[k3][0], loc[k3][1]);
        out[DS / 8 + 3] = pack_bf16(nrm[0], nrm[1]);
#pragma unroll
        for (int m = 0; m < FH / 32; ++m) {
          const uint4 q = quad_transpose(out[4 * m], out[4 * m + 1], out[4 * m + 2],
                                         out[4 * m + 3], tq);
          if (ok) *reinterpret_cast<uint4*>(fo + 8 * (4 * m + tq)) = q;
        }
      }
    }
  }
}

}  // namespace tc_pp
