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
//   with direction rows (dir = 1, the official DiffAb block's point
//   directions): acc = [out_s | loc | nrm | loc / (nrm + 1e-4)] @
//   [W_s; W_p; W_n; W_d], from the kernels' DIR instantiations; dir = 0
//   launches the instantiations without the direction code
//
// The rounding points are the Pallas kernel's: the augmented operands, the
// attention weights and the output-projection operands are cast to the
// compute dtype T, everything else stays in float.
//
// One design in two product routes, by dtype, both on the tensor cores with
// mma.sync, both reading the head-major weights of ops/ipa_fused_layer.py
// pack_layer_weights (w_qkv (h, d, 3 FVP): per head and input row
// [q | k | v], each [scalar (ds) | points (3, P) | 0 pad]; w_out (h FH, dP):
// per head the rows [W_s (ds) | W_p (3, P) | W_n (P) | 0 pad], columns
// padded to dP = d rounded up to 8):
//   1. layer_heads_kernel, one block of 8 warps per (head, design): the
//      head's Q/K/V projection from x and the head's weight columns in
//      K-slices by cp.async, kept on chip; frames, g folding and point
//      norms into the augmented operand tiles; each warp's 16 x L logits
//      and float32 softmax in registers (keys >= L exactly 0); attn
//      written in T; the weighted sums from register fragments; inverse
//      frames and norms into head-major features feat (b L, h FH) in T.
//   2. out_proj_kernel: acc = feat @ w_out, a cp.async double-buffered
//      tensor-core GEMM.
//   bfloat16 (ipa_fused_layer_bf16.cuh): mma.sync m16n8k16, bf16 operands
//     and f32 accumulation, which gives exactly the rounding points above.
//     With at least two (head, design) items per SM at L <= 128 and the
//     default head widths (ds = 32, P = 8), launch 1 is instead
//     tc_pp::persistent_layer_heads_kernel (ipa_fused_layer_persistent.cuh):
//     one block per SM walks the items, a producer warp loads ahead, two
//     consumer warpgroups take an item each, products on wgmma and every
//     phase between them in registers; the same rounding points and
//     outputs.  The wrapper chooses (ops/ipa_fused_layer.py
//     takes_persistent) and passes the number of blocks.
//   float32 (ipa_fused_layer_f32.cuh): 3xTF32 on mma.sync m16n8k8, every
//     product (projection, logits, weighted sums, output GEMM) as three
//     tf32 products of split operands, float32-exact to the 1e-4 checks;
//     its attention phases are the warp core of ipa_attention_tc.cuh.
//
// What bounds it on this card: at the main sampling shapes (b=128, L=128,
// d=128, h=8, ds=32, pq=pv=8) the layer is ~11.6 GFLOP.  In bf16 that is
// ~43 MB of compulsory traffic, about 12 us at the H100's bf16
// tensor-core peak and 13 us at its HBM rate: balanced, so only tensor
// cores and on-chip reuse reach the bound.  In float32 it is ~86 MB
// (26 us) against ~71 us of operations at the 3xTF32 rate (a third of
// the TF32 peak): bound by operations.  Both routes reuse on chip the
// same way: the projection never leaves the block, the logits and
// weights stay in registers, and only attn (compulsory) and the per-head
// features (read back by the output GEMM) are written.  Both are bound
// by latency inside each block, not by the tensor cores or the bytes:
// each block runs its phases (loads, projection, frames, logits, softmax,
// attn store, weighted sums, epilogue) one after another with barriers
// between them, with 16 warps per SM to hide the waits; the float32 route
// issues six times the mma.sync instructions of bf16 for the same tiles
// (k8 against k16, three products) and splits its operands into tf32
// pairs (launch 1's W_h once a block, the others as they are loaded).
// mma.sync rather than wgmma, and the feature round trip (a cluster
// reduction of the output projection would remove it), are the other
// things both leave on the table.
//
// Patches longer than 128 residues take three launches: launch 1 as
// above, one block per (head, design, chunk of 128 rows), stops after the
// augmented operands and writes them to a device scratch (q, k, v
// feature-major); attend_kernel, one block per (head, design, chunk of
// 128 query rows), runs the chunked core of ipa_attention_tc.cuh on the
// scratch (keys streamed in chunks of 128, two passes) and launch 1's
// epilogue; launch 2 as above.  In float32, where its strip fits (L <= 272
// at the default widths), onepass_attend_kernel takes attend_kernel's
// place: the same work with each logit computed once (below).  Projecting
// once into the scratch, rather than each query-chunk block projecting all
// L keys itself, costs bytes and no FLOPs: at b = 128, L = 256, bf16 the
// scratch is ~96 MB written and ~159 MB read back (K and V once per query
// chunk) against the layer's 153 MB of compulsory traffic (float32: twice
// that); recomputing would add (L / 128 - 1) x the key and value
// projections per block.
// Shared memory at L = 256: launch 1 that of L = 128 (bf16 95,872 bytes
// at the default shapes, 169,936 at the widest; float32 106,752 and
// 119,808); attend_kernel bf16 91,008 and 103,936, float32 106,240 and
// 119,296 (chunk_dims); onepass_attend_kernel 216,064 at the default
// shapes (onepass_dims, growing with L).  The L <= 128 launches are
// unchanged.
//
// Limits: ds + 3 P <= 64; for these every L, d and h fit the shared
// memory a block may use (227 KB): at most ~167 KB for bf16 and ~120 KB
// for float32 (layer_dims of each header, chunk_dims; the one-pass kernel
// only where it fits, onepass_fits).  The persistent launch 1 takes d up
// to 128 (persistent_dims: 226,432 bytes at d = 128); wider rows take the
// per-item kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ipa_attention_tc.cuh"
#include "ipa_fused_layer_bf16.cuh"
#include "ipa_fused_layer_f32.cuh"
#include "ipa_fused_layer_persistent.cuh"

#include <initializer_list>

namespace {

using ipa_tc::CHUNK;
using ptx::bf16;
using ptx::round_up;

// ---- L > MAX_L: the attention on the operands in device scratch -------------------
// One block of 8 warps per (head, design, chunk of CHUNK query rows): the
// chunked core of ipa_attention_tc.cuh on the operands that launch 1 wrote
// (feature-major, LS = L rounded up to 16 columns), then the epilogue of
// launch 1 (inverse frames, point norms, features).  Shared memory: the
// query rows' frames (12 CHUNK floats), the tiles qa, ka (FP x ts) and va
// (FVP x ts), ts = tile_stride<T>(CHUNK); bf16 also per warp its attn rows
// (16 x as bf16), then its outputs (16 x os f32); float32 writes attn from
// the accumulators and turns the outputs through the q tile.
struct ChunkDims {
  int L, LS, h, ds, p, FP, FVP, FH;
  int ts, as, os, warp_bytes, total;
};

template <typename T> ChunkDims chunk_dims(int L, int h, int ds, int p, bool dir = false) {
  ChunkDims D;
  const int fv = ds + 3 * p;
  D.L = L, D.LS = round_up(L, 16), D.h = h, D.ds = ds, D.p = p;
  D.FP = round_up(fv + 3, ptx::is_bf16<T> ? 16 : 8), D.FVP = round_up(fv, 8);
  D.FH = round_up(ds + (dir ? 7 : 4) * p, 8);
  D.ts = ptx::tile_stride<T>(CHUNK), D.as = ptx::tile_stride<bf16>(CHUNK);
  D.os = ptx::tile_stride<bf16>(D.FVP);
  D.warp_bytes = ptx::is_bf16<T> ? 16 * (D.as * 2 > D.os * 4 ? D.as * 2 : D.os * 4) : 0;
  D.total = CHUNK * 12 * 4 + (2 * D.FP + D.FVP) * D.ts * (int)sizeof(T) +
            CHUNK / 16 * D.warp_bytes;
  return D;
}

template <typename T, bool DIR = false>
__global__ void __launch_bounds__(256, 2)
attend_kernel(const T* __restrict__ opnd,   // q, k (b, h, FP, LS), v (b, h, FVP, LS)
              const T* __restrict__ rot,    // (b, L, 3, 3)
              const T* __restrict__ trans,  // (b, L, 3)
              const T* __restrict__ bias,   // (bp, h, L, L)
              T* __restrict__ feat,         // (b L, h FH)
              T* __restrict__ attn,         // (b, h, L, L)
              const ChunkDims D, int n_designs, float scale_total) {
  const int hh = blockIdx.x, design = blockIdx.y, target = design / n_designs;
  const int q0 = blockIdx.z * CHUNK, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int L = D.L, LS = D.LS, h = D.h;

  extern __shared__ __align__(16) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem);  // CHUNK x 9
  float* tr = rs + CHUNK * 9;                  // CHUNK x 3
  T* qa = reinterpret_cast<T*>(tr + CHUNK * 3);
  T* ka = qa + D.FP * D.ts;
  T* va = ka + D.FP * D.ts;
  unsigned char* wbuf = reinterpret_cast<unsigned char*>(va + D.FVP * D.ts) +
                        warp * D.warp_bytes;

  const size_t row_base = (size_t)design * L + q0, gi = (size_t)design * h + hh;
  const int n_rows = L - q0 < CHUNK ? L - q0 : CHUNK;
  for (int e = tid; e < CHUNK * 9; e += 256)
    rs[e] = e < n_rows * 9 ? ptx::to_f<T>(rot[row_base * 9 + e]) : 0.f;
  for (int e = tid; e < CHUNK * 3; e += 256)
    tr[e] = e < n_rows * 3 ? ptx::to_f<T>(trans[row_base * 3 + e]) : 0.f;

  const size_t qk = (size_t)gridDim.y * h * D.FP * LS;
  const T* q = opnd + gi * D.FP * LS;
  const T* v = opnd + 2 * qk + gi * D.FVP * LS;
  float o[ipa_tc::MAX_V_TILES][4];
  ipa_tc::chunked_attention<T>(q, q + qk, D.FP, D.FP, v, D.FVP, v, 0, D.FVP, LS, LS, L,
                               bias + ((size_t)target * h + hh) * L * L,
                                   attn + gi * L * L, q0, scale_total, qa, ka, va, D.ts,
                                   reinterpret_cast<T*>(wbuf), D.as, tid, 256, o);
  const int m0 = 16 * warp, i0 = q0 + m0;
  if (i0 >= LS) return;  // warp-uniform; no block barrier follows
  const int rows = L - i0 < 16 ? L - i0 : 16, gq = lane / 4, tq = lane % 4;
  const int v_tiles = D.FVP / 8;
  // the outputs as f32, feature c of row r at ot[r rstr + c cstr]
  float* ot;
  int rstr, cstr;
  __syncwarp();  // every lane is done with the attn tile and its q columns
  if constexpr (ptx::is_bf16<T>) {
    ot = reinterpret_cast<float*>(wbuf), rstr = D.os, cstr = 1;
  } else {
    ot = qa + m0, rstr = 1, cstr = D.ts;  // the warp's own q columns
  }
#pragma unroll
  for (int vt = 0; vt < ipa_tc::MAX_V_TILES; ++vt) {
    if (vt < v_tiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ot[(gq + (e >> 1) * 8) * rstr + (vt * 8 + 2 * tq + (e & 1)) * cstr] = o[vt][e];
    }
  }
  __syncwarp();
  ipa_layer::write_features<T, DIR>(ot, rstr, cstr, rs + m0 * 9, tr + m0 * 3, rows, D.ds, D.p,
                                    D.FH, feat + ((row_base + m0) * h + hh) * D.FH,
                                    (size_t)h * D.FH, lane);
}

template <typename T>
cudaError_t run_attend(const void* opnd, const void* rot, const void* trans,
                       const void* bias, void* feat, void* attn, int b, int bp, int L, int h,
                       int ds, int p, float scale_total, bool dir, cudaStream_t stream) {
  const ChunkDims D = chunk_dims<T>(L, h, ds, p, dir);
  auto kernel = dir ? attend_kernel<T, true> : attend_kernel<T, false>;
  cudaError_t err = ptx::allow_dynamic_smem(kernel, D.total);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(h, b, (L + CHUNK - 1) / CHUNK), 256, D.total, stream>>>(
      static_cast<const T*>(opnd), static_cast<const T*>(rot), static_cast<const T*>(trans),
      static_cast<const T*>(bias), static_cast<T*>(feat), static_cast<T*>(attn), D, b / bp,
      scale_total);
  return cudaGetLastError();
}

// ---- L > MAX_L in float32: the one-pass core -------------------------------------
// One block of 8 warps per (design, head, chunk of CHUNK query rows), the
// query chunk fastest in the grid, so that the blocks of one (design, head)
// read its K and V from L2 about the same time:
// ipa_tc::chunked_attention_onepass (each logit once, a two-stage cp.async
// ring of 32 keys split once per block, the warp's weights on chip until
// the row's max and sum are known, attn written once) and the epilogue of
// attend_kernel (write_features_by_item: the same features, work split by
// (row, point) item), the outputs turned through the warp's own strip rows.
// Shared memory (OnepassDims, floats): the query rows' frames (12 CHUNK),
// the strip (CHUNK x ss, ss = LS + 8; first the raw q tile), the chunks'
// row maxima (CHUNK x nch) and the ring (2 x stage, stage = FP / 2 x 136 +
// FVP x 80: K and V split into tf32 pairs).  At the official
// shapes (L = 256, ds 32, P 8) 216,064 bytes: one block per SM, so
// __launch_bounds__(256, 1) leaves 255 registers a thread, which hold the
// warp's split q fragments (72 at the widest) beside the accumulators.
// `onepass_fits`: the layer takes this path where the bytes fit a block's
// 232,448, L <= 272 at the default widths and L <= 256 at the widest
// (ds + 3P = 64); longer patches keep attend_kernel's two passes, whose
// shared memory does not grow with L.
struct OnepassDims {
  int L, LS, h, ds, p, FP, FVP, FH;
  int ss, nch, stage, total;
};

inline OnepassDims onepass_dims(int L, int h, int ds, int p, bool dir = false) {
  OnepassDims D;
  const int fv = ds + 3 * p;
  D.L = L, D.LS = round_up(L, 16), D.h = h, D.ds = ds, D.p = p;
  D.FP = round_up(fv + 3, 8), D.FVP = round_up(fv, 8);
  D.FH = round_up(ds + (dir ? 7 : 4) * p, 8);
  D.ss = D.LS + 8, D.nch = (D.LS + ipa_tc::OP_KC - 1) / ipa_tc::OP_KC;
  D.stage = D.FP / 2 * ipa_tc::OP_KROW + D.FVP * ipa_tc::OP_VROW;
  D.total = (CHUNK * 12 + CHUNK * D.ss + CHUNK * D.nch + 2 * D.stage) * 4;
  return D;
}

inline bool onepass_fits(int L, int ds, int p) {
  return L > ipa_tc::MAX_L && onepass_dims(L, 1, ds, p).total <= 232448;
}

// KK, VT: FP / 8 and FVP / 8 at compile time (8, 7 at the default widths), or
// 0 for any (ipa_tc::chunked_attention_onepass)
template <bool DIR, int KK, int VT>
__global__ void __launch_bounds__(ipa_tc::OP_THREADS, 1)
onepass_attend_kernel(const float* __restrict__ opnd,   // q, k (b, h, FP, LS), v (b, h, FVP, LS)
                      const float* __restrict__ rot,    // (b, L, 3, 3)
                      const float* __restrict__ trans,  // (b, L, 3)
                      const float* __restrict__ bias,   // (bp, h, L, L)
                      float* __restrict__ feat,         // (b L, h FH)
                      float* __restrict__ attn,         // (b, h, L, L)
                      const OnepassDims D, int n_designs, float scale_total, int attn_vec) {
  const int q0 = blockIdx.x * CHUNK, hh = blockIdx.y, design = blockIdx.z;
  const int target = design / n_designs, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int L = D.L, LS = D.LS, h = D.h;

  extern __shared__ __align__(16) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem);  // CHUNK x 9
  float* tr = rs + CHUNK * 9;                  // CHUNK x 3
  float* strip = tr + CHUNK * 3;               // CHUNK x ss
  float* mrow = strip + CHUNK * D.ss;          // CHUNK x nch
  float* ring = mrow + CHUNK * D.nch;          // 2 x stage

  const size_t row_base = (size_t)design * L + q0, gi = (size_t)design * h + hh;
  const int m0 = 16 * warp, i0 = q0 + m0;
  // the frames of this warp's 16 rows (9 + 3 floats a row), read into
  // registers now and put into shared memory after the core, so that their
  // loads wait behind nothing and hold nothing up
  float fv[6];
#pragma unroll
  for (int u = 0; u < 6; ++u) {
    const int e = lane + 32 * u, r = e < 144 ? e / 9 : (e - 144) / 3;
    fv[u] = i0 + r >= L ? 0.f
            : e < 144 ? rot[(row_base + m0) * 9 + e]
                      : trans[(row_base + m0) * 3 + e - 144];
  }

  const size_t qk = (size_t)gridDim.z * h * D.FP * LS;
  const float* q = opnd + gi * D.FP * LS;
  float o[ipa_tc::MAX_V_TILES][4];
  ipa_tc::chunked_attention_onepass<KK, VT>(q, q + qk, opnd + 2 * qk + gi * D.FVP * LS, D.FP, D.FVP,
                                    LS, L, bias + ((size_t)target * h + hh) * L * L,
                                    attn + gi * L * L, attn_vec, q0, scale_total, strip, D.ss,
                                    mrow, D.nch, ring, tid, o);
  if (i0 >= LS) return;  // warp-uniform; no block barrier follows
  const int rows = L - i0 < 16 ? L - i0 : 16, gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int u = 0; u < 6; ++u) {
    const int e = lane + 32 * u;
    if (e < 144) rs[m0 * 9 + e] = fv[u];
    else tr[m0 * 3 + e - 144] = fv[u];
  }
  // the outputs as f32 through the warp's own strip rows: feature c of row r
  // at ot[r ss + c]
  float* ot = strip + m0 * D.ss;
#pragma unroll
  for (int vt = 0; vt < ipa_tc::MAX_V_TILES; ++vt) {
    if (vt < D.FVP / 8) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(ot + (gq + hr * 8) * D.ss + vt * 8 + 2 * tq) =
            make_float2(o[vt][2 * hr], o[vt][2 * hr + 1]);
    }
  }
  __syncwarp();
  ipa_layer::write_features_by_item<DIR>(ot, D.ss, rs + m0 * 9, tr + m0 * 3, rows, D.ds, D.p,
                                         D.FH, feat + ((row_base + m0) * h + hh) * D.FH,
                                         (size_t)h * D.FH, lane);
}

// the default and official widths (ds 32, P 8: FP 64, FVP 56) compiled with
// their slices fixed
constexpr int ONEPASS_KK = 8, ONEPASS_VT = 7;

cudaError_t run_attend_onepass(const void* opnd, const void* rot, const void* trans,
                               const void* bias, void* feat, void* attn, int b, int bp, int L,
                               int h, int ds, int p, float scale_total, bool dir,
                               cudaStream_t stream) {
  const OnepassDims D = onepass_dims(L, h, ds, p, dir);
  const bool fixed = D.FP == 8 * ONEPASS_KK && D.FVP == 8 * ONEPASS_VT;
  auto kernel = dir ? (fixed ? onepass_attend_kernel<true, ONEPASS_KK, ONEPASS_VT>
                             : onepass_attend_kernel<true, 0, 0>)
                    : (fixed ? onepass_attend_kernel<false, ONEPASS_KK, ONEPASS_VT>
                             : onepass_attend_kernel<false, 0, 0>);
  cudaError_t err = ptx::allow_dynamic_smem(kernel, D.total);
  if (err != cudaSuccess) return err;
  const int attn_vec = L % 4 == 0 && reinterpret_cast<uintptr_t>(attn) % 16 == 0;
  kernel<<<dim3((L + CHUNK - 1) / CHUNK, h, b), ipa_tc::OP_THREADS, D.total, stream>>>(
      static_cast<const float*>(opnd), static_cast<const float*>(rot),
      static_cast<const float*>(trans), static_cast<const float*>(bias),
      static_cast<float*>(feat), static_cast<float*>(attn), D, b / bp, scale_total, attn_vec);
  return cudaGetLastError();
}

// Launch 1 takes a whole (design, head) up to MAX_L rows; beyond, it writes
// the operands of each CHUNK rows to opnd and attend_kernel runs the
// attention (D is made for min(L, CHUNK) rows, D.L is the patch's L)
int run_f32(const void* x, const void* rot, const void* trans, const void* mask,
            const void* w_qkv, const void* w_out, const float* g, const void* bias,
            void* feat, void* acc, void* attn, void* opnd, int b, int bp, int L, int d, int h,
            int ds, int p, float scale_total, float nk_scale, bool dir, cudaStream_t stream) {
  const bool chunked = L > ipa_tc::MAX_L;
  tf32x3::Dims D = tf32x3::layer_dims(chunked ? CHUNK : L, d, h, ds, p, dir);
  D.L = L;
  const bool fixed = tf32x3::fixed_widths(D);
  auto heads = chunked ? (fixed ? tf32x3::layer_heads_kernel<true, false, true>
                                : tf32x3::layer_heads_kernel<true, false, false>)
               : dir   ? (fixed ? tf32x3::layer_heads_kernel<false, true, true>
                                : tf32x3::layer_heads_kernel<false, true, false>)
                       : (fixed ? tf32x3::layer_heads_kernel<false, false, true>
                                : tf32x3::layer_heads_kernel<false, false, false>);
  cudaError_t err = ptx::allow_dynamic_smem(heads, D.total);
  if (err != cudaSuccess) return err;
  const int x_vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  heads<<<dim3(h, b, (L + CHUNK - 1) / CHUNK), tf32x3::THREADS, D.total, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(rot),
      static_cast<const float*>(trans), static_cast<const float*>(mask),
      static_cast<const float*>(w_qkv), g, static_cast<const float*>(bias),
      static_cast<float*>(feat), static_cast<float*>(attn), D, b / bp, scale_total, nk_scale,
      x_vec, static_cast<float*>(opnd));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (chunked) {
    err = onepass_fits(L, ds, p)
              ? run_attend_onepass(opnd, rot, trans, bias, feat, attn, b, bp, L, h, ds, p,
                                   scale_total, dir, stream)
              : run_attend<float>(opnd, rot, trans, bias, feat, attn, b, bp, L, h, ds, p,
                                         scale_total, dir, stream);
    if (err != cudaSuccess) return err;
  }

  const int M = b * L, NP = round_up(d, 8);
  tf32x3::out_proj_kernel<<<dim3((NP + tf32x3::GN - 1) / tf32x3::GN,
                                 (M + tf32x3::GM - 1) / tf32x3::GM),
                            tf32x3::G_THREADS, 0, stream>>>(
      static_cast<const float*>(feat), static_cast<const float*>(w_out),
      static_cast<float*>(acc), M, d, NP, h * D.FH);
  return cudaGetLastError();
}

// persistent_blocks > 0: launch 1 is tc_pp::persistent_layer_heads_kernel on
// that many blocks (the wrapper's choice, ops/ipa_fused_layer.py
// takes_persistent); 0: tc::layer_heads_kernel, one block per (head, design)
int run_bf16(const void* x, const void* rot, const void* trans, const void* mask,
             const void* w_qkv, const void* w_out, const float* g, const void* bias,
             void* feat, void* acc, void* attn, void* opnd, int b, int bp, int L, int d, int h,
             int ds, int p, float scale_total, float nk_scale, int persistent_blocks, bool dir,
             cudaStream_t stream) {
  const bool chunked = L > ipa_tc::MAX_L;
  tc::Dims D = tc::layer_dims(chunked ? CHUNK : L, d, h, ds, p, dir);
  D.L = L;
  cudaError_t err;
  if (persistent_blocks > 0) {
    const tc_pp::Dims P = tc_pp::persistent_dims(L, d, h);
    auto heads = tc_pp::persistent_layer_heads_kernel;
    if ((err = ptx::allow_dynamic_smem(heads, P.total)) != cudaSuccess) return err;
    bool frames_vec = L % 8 == 0;
    for (const void* t : {rot, trans, mask})
      frames_vec = frames_vec && reinterpret_cast<uintptr_t>(t) % 16 == 0;
    heads<<<persistent_blocks, tc_pp::THREADS, P.total, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(rot),
        static_cast<const bf16*>(trans), static_cast<const bf16*>(mask),
        static_cast<const bf16*>(w_qkv), g, static_cast<const bf16*>(bias),
        static_cast<bf16*>(feat), static_cast<bf16*>(attn), P, b, b / bp, scale_total,
        nk_scale, frames_vec);
  } else {
    auto heads = chunked ? tc::layer_heads_kernel<true>
                 : dir   ? tc::layer_heads_kernel<false, true>
                         : tc::layer_heads_kernel<false>;
    if ((err = ptx::allow_dynamic_smem(heads, D.total)) != cudaSuccess) return err;
    const int x_vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    heads<<<dim3(h, b, (L + CHUNK - 1) / CHUNK), tc::THREADS, D.total, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(rot),
        static_cast<const bf16*>(trans), static_cast<const bf16*>(mask),
        static_cast<const bf16*>(w_qkv), g, static_cast<const bf16*>(bias),
        static_cast<bf16*>(feat), static_cast<bf16*>(attn), D, b / bp, scale_total, nk_scale,
        x_vec, static_cast<bf16*>(opnd));
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (chunked && (err = run_attend<bf16>(opnd, rot, trans, bias, feat, attn, b, bp, L, h, ds,
                                         p, scale_total, dir, stream)) != cudaSuccess)
    return err;

  const int M = b * L, NP = round_up(d, 8);
  tc::out_proj_kernel<<<dim3((NP + tc::GN - 1) / tc::GN, (M + tc::GM - 1) / tc::GM),
                        tc::G_THREADS, 0, stream>>>(
      static_cast<const bf16*>(feat), static_cast<const bf16*>(w_out),
      static_cast<bf16*>(acc), M, d, NP, h * D.FH);
  return cudaGetLastError();
}

bool shape_ok(int b, int bp, int L, int d, int h, int ds, int p) {
  return L >= 1 && bp >= 1 && b % bp == 0 && d >= 1 && h >= 1 && ds >= 1 && p >= 1 &&
         ds + 3 * p <= ipa_tc::MAX_FV;
}

// the shapes tc_pp::persistent_layer_heads_kernel takes (ipa_fused_layer.py
// takes_persistent adds the count of items against the card's SMs)
bool persistent_ok(int L, int d, int h, int ds, int p, const void* x) {
  return L <= ipa_tc::MAX_L && ds == tc_pp::DS && p == tc_pp::P && d % 8 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         tc_pp::persistent_dims(L, d, h).total <= tc_pp::SMEM_LIMIT;
}

}  // namespace

extern "C" {

// The layer on the head-major weights.  dtype: 0 = float32, 1 = bfloat16;
// every operand but g (float32), the bias included, is in that dtype.  feat
// is (b L, h FH) scratch in the compute dtype; for L > 128 opnd is scratch
// for the operands, ipa_fused_layer_scratch_elems elements of the compute
// dtype (unread otherwise).  Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for shapes the kernel does not take.
// persistent_blocks > 0 runs launch 1 as the persistent kernel on that many
// blocks (bf16 and its shapes only, no direction rows), 0 as one block per
// (head, design).  dir = 1: w_out holds direction rows per head and feat
// FH = ds + 7 P rounded up to 8 columns a head (else ds + 4 P).
int ipa_fused_layer_forward(int dtype, const void* x, const void* rot, const void* trans,
                            const void* mask, const void* w_qkv, const void* w_out,
                            const float* g, const void* bias, void* feat, void* acc, void* attn,
                            void* opnd, int b, int bp, int L, int d, int h, int ds, int p,
                            float scale_total, float nk_scale, int persistent_blocks, int dir,
                            void* stream) {
  if (!shape_ok(b, bp, L, d, h, ds, p)) return cudaErrorInvalidValue;
  if (persistent_blocks > 0 && (dtype != 1 || dir || !persistent_ok(L, d, h, ds, p, x)))
    return cudaErrorInvalidValue;
  const bool chunked = L > ipa_tc::MAX_L;
  for (const void* t : {w_qkv, w_out, static_cast<const void*>(feat), chunked ? opnd : w_qkv})
    if (reinterpret_cast<uintptr_t>(t) % 16) return cudaErrorMisalignedAddress;  // cp.async
  const int rows = chunked ? CHUNK : L;  // launch 1's rows per block
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (tf32x3::layer_dims(rows, d, h, ds, p).total > 232448 ||
        (chunked && chunk_dims<float>(L, h, ds, p).total > 232448))
      return cudaErrorInvalidValue;
    return run_f32(x, rot, trans, mask, w_qkv, w_out, g, bias, feat, acc, attn, opnd, b, bp,
                   L, d, h, ds, p, scale_total, nk_scale, dir != 0, s);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  if (tc::layer_dims(rows, d, h, ds, p).total > 232448 ||
      (chunked && chunk_dims<bf16>(L, h, ds, p).total > 232448))
    return cudaErrorInvalidValue;
  return run_bf16(x, rot, trans, mask, w_qkv, w_out, g, bias, feat, acc, attn, opnd, b, bp, L,
                  d, h, ds, p, scale_total, nk_scale, persistent_blocks, dir != 0, s);
}

// Elements of the operand scratch for L > 128 (0 up to 128): q and k
// (b, h, FP, LS), v (b, h, FVP, LS), LS = L rounded up to 16, FP the
// augmented width rounded up to 16 (bf16) or 8 (float32).
long long ipa_fused_layer_scratch_elems(int dtype, int b, int L, int h, int ds, int p) {
  if (L <= ipa_tc::MAX_L) return 0;
  const ChunkDims D = dtype == 1 ? chunk_dims<bf16>(L, h, ds, p) : chunk_dims<float>(L, h, ds, p);
  return (long long)b * h * (2 * D.FP + D.FVP) * D.LS;
}

// The attention launch a call beyond 128 residues takes: 2 = float32's one
// pass (onepass_attend_kernel), 1 = the two passes of attend_kernel
// (bf16, and float32 where the one-pass strip does not fit), 0 = none (L <=
// 128).  The wrapper books its counters by it (ops/ipa_fused_layer.py
// attend_path).
int ipa_fused_layer_attend_path(int dtype, int L, int ds, int p) {
  if (L <= ipa_tc::MAX_L) return 0;
  return dtype == 0 && onepass_fits(L, ds, p) ? 2 : 1;
}

const char* ipa_fused_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
