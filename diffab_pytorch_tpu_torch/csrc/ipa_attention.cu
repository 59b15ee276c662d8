// IPA attention core for Hopper (sm_90a), float32 and bfloat16.
//
// Replaces the TPU kernel diffab_pytorch_tpu/ops/ipa_pallas.py _kernel
// (launched by _pallas_raw through fused_ipa_attention_raw and
// fused_ipa_attention).  It takes the augmented operands that the caller
// assembles outside the kernel, as the JAX wrapper does, and computes for
// every (design, head) g of b designs that share bp = b / n_designs
// per-target bias blocks:
//
//   logit[i, j] = (sum_f q_aug[g, f, i] k_aug[g, f, j] + bias[g / n, i, j])
//                 * scale_total                            (f32 accumulation)
//   attn = softmax_j(logit) in float32, written in T
//   out_s[g, c, i] = sum_j v_s[g, c, j] attn[i, j]          (T operands)
//   out_p[g, c, i] = sum_j v_p[g, c, j] attn[i, j]
//
// Padded keys carry -1e9 / scale_total in a key row of the augmented
// operands, so they get exactly 0 weight without a mask input.
//
// What bounds it on this card: at the training shape (b = bp = 32, L = 128,
// h = 8, F = 64, ds = 32, 3P = 24, bf16) one call is ~1.0 GFLOP against
// ~32.5 MB of compulsory traffic, and at the sampling shape (b = 128,
// bp = 1) ~4 GFLOP against ~97 MB: bytes-bound at both (~10 and ~29 us at
// the HBM rate), and in float32 (3xTF32, a third of the TF32 rate) still
// bytes-bound.  So every product runs on the tensor cores and every input
// byte crosses device memory once:
//   - one block of 8 warps takes all the query rows of one (design, head)
//     (two blocks of 64 rows, each reading K and V, were slower at every
//     measured shape; PERF.md); the grid runs the blocks of one design's
//     heads next to each other, so a target's bias is read by neighbouring
//     blocks;
//   - q_aug, k_aug and [v_s | v_p] are copied into padded
//     shared tiles in their feature-major layout, 16 bytes per cp.async
//     (element by element when L % 8 != 0);
//   - each warp keeps its 16 rows x all keys of logits in registers and runs
//     the softmax there (ipa_attention_tc.cuh): bf16 on mma.sync m16n8k16,
//     float32 as 3xTF32 on m16n8k8, exact to float32's 1e-4 checks;
//   - attn leaves from the warp (bf16 through a per-warp tile for 16-byte
//     stores, float32 from the accumulators);
//   - the outputs go through the warp's own 16 columns of the q tile (only
//     it reads them) and leave feature-major in 16-byte stores, so no block
//     barrier follows the loads.
//
// Shared memory at the default shape (L = 128, F = 64, FV = 56): bf16
// 84,864 bytes (two blocks per SM), float32 100,096 bytes (two
// blocks per SM); at the largest shapes taken (F = 80, FV = 64) 121,856
// bytes.  Registers bound the residency to 16 warps per SM either way.
//
// On the H100 this reaches 38-51% of the bytes bound in bf16 and 19-26% in
// float32 at the two shapes (PERF.md).  What is left is latency: each warp
// runs its loads, products, softmax and stores in sequence with 16 warps
// per SM to hide the waits, and 3xTF32 issues six times the mma.sync
// instructions of bf16.
//
// Patches longer than 128 residues (attention_chunked_kernel): the grid
// gains a third dimension over chunks of 128 query rows, one block each,
// rather than a loop over them inside one block: a (design, head) at
// L = 256 then fills two blocks instead of keeping one SM twice as long,
// and each block's shared memory stays that of L = 128.  Every block
// streams the keys through its tiles in chunks of 128, twice
// (ipa_tc::chunked_attention: pass 1 the rows' max and sum, pass 2 the
// logits again, the normalised weights and the weighted sums), so K is
// read 2 x (L / 128) times and V L / 128 times per (design, head), from
// L2 mostly, and the logits' product is done twice.  Shared memory at
// L = 256 is that of L = 128: bf16 84,864 and float32 100,096 bytes at
// the default shape, 121,856 at the largest (float32, F = 80, FV = 64).
// The L <= 128 kernel is unchanged.
//
// Limits: ds + 3 P <= 64, ds + 3 P < F <= 80 (the augmented width
// ds + 3 P + 3 padded to 16); any L >= 1 whose tensors fit the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ipa_attention_tc.cuh"

using namespace ipa_tc;

namespace {

constexpr int WARPS = MAX_L / 16;  // 16 query rows each: a (design, head) up to MAX_L
constexpr int THREADS = WARPS * 32;

struct Dims {
  int L, LP, F, FP, ds, p3, FV, FVP;
  int ts, as;  // strides: q / k / v tiles, bf16 attn tile
  int qk_bytes, v_bytes, warp_bytes, total;
};

template <typename T> Dims attention_dims(int L, int F, int ds, int p3) {
  Dims D;
  D.L = L, D.LP = round_up(L, 16), D.F = F, D.FP = round_up(F, 16);
  D.ds = ds, D.p3 = p3, D.FV = ds + p3, D.FVP = round_up(D.FV, 8);
  D.ts = tile_stride<T>(D.LP), D.as = tile_stride<bf16>(D.LP);
  D.qk_bytes = D.FP * D.ts * (int)sizeof(T);
  D.v_bytes = D.FVP * D.ts * (int)sizeof(T);
  D.warp_bytes = is_bf16<T> ? 16 * D.as * 2 : 0;
  D.total = 2 * D.qk_bytes + D.v_bytes + WARPS * D.warp_bytes;
  return D;
}

// The warp's outputs o of rows i0 .. i0 + 15 (those < L) to out_s / out_p,
// transposed through its own 16 columns ot of the q tile (FVP <= FP rows,
// only this warp reads them): ot[c][r] for feature c of row i0 + r; they
// leave feature-major, 16 bytes per store where the rows allow
template <typename T>
__device__ __forceinline__ void write_outputs(const float (&o)[MAX_V_TILES][4], T* ot,
                                              const Dims& D, T* __restrict__ out_s,
                                              T* __restrict__ out_p, size_t g, int i0,
                                              int lane, bool vec) {
  const int L = D.L, ds = D.ds, p3 = D.p3;
  __syncwarp();
#pragma unroll
  for (int vt = 0; vt < MAX_V_TILES; ++vt) {
    if (vt < D.FVP / 8) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = lane / 4 + hr * 8, c = vt * 8 + (lane & 3) * 2;
        ot[c * D.ts + r] = from_f<T>(o[vt][2 * hr]);
        ot[(c + 1) * D.ts + r] = from_f<T>(o[vt][2 * hr + 1]);
      }
    }
  }
  __syncwarp();
  const int rows = L - i0 < 16 ? L - i0 : 16;
  auto out_row = [&](int c) {  // feature c's row of L outputs
    return c < ds ? out_s + (g * ds + c) * L : out_p + (g * p3 + c - ds) * L;
  };
  if (vec && rows == 16) {
    constexpr int PER = 16 / sizeof(T), PIECES = 16 / PER;  // per row of 16 outputs
    for (int e = lane; e < D.FV * PIECES; e += 32) {
      const int c = e / PIECES, q = (e - c * PIECES) * PER;
      *reinterpret_cast<uint4*>(out_row(c) + i0 + q) =
          *reinterpret_cast<const uint4*>(ot + c * D.ts + q);
    }
  } else {
    for (int e = lane; e < D.FV * rows; e += 32) {
      const int c = e / rows, r = e - c * rows;
      out_row(c)[i0 + r] = ot[c * D.ts + r];
    }
  }
}

// L <= MAX_L: one block per (head, design) holds every query row and key
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
attention_kernel(const T* __restrict__ q_aug,  // (b, h, F, L)
                 const T* __restrict__ k_aug,  // (b, h, F, L)
                 const T* __restrict__ v_s,    // (b, h, ds, L)
                 const T* __restrict__ v_p,    // (b, h, 3P, L)
                 const T* __restrict__ bias,   // (bp, h, L, L)
                 T* __restrict__ out_s,        // (b, h, ds, L)
                 T* __restrict__ out_p,        // (b, h, 3P, L)
                 T* __restrict__ attn,         // (b, h, L, L)
                 const Dims D, int h, int n_designs, float scale_total) {
  const int hh = blockIdx.x, design = blockIdx.y, target = design / n_designs;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int L = D.L, F = D.F, ds = D.ds, p3 = D.p3;
  const int m0 = 16 * warp;  // the warp's first query row, its first q-tile column
  const size_t g = (size_t)design * h + hh;
  const bool vec = L % 8 == 0;

  extern __shared__ __align__(16) unsigned char smem[];
  T* qa = reinterpret_cast<T*>(smem);
  T* ka = reinterpret_cast<T*>(smem + D.qk_bytes);
  T* va = reinterpret_cast<T*>(smem + 2 * D.qk_bytes);
  T* wtile = reinterpret_cast<T*>(smem + 2 * D.qk_bytes + D.v_bytes + warp * D.warp_bytes);

  load_tile(qa, q_aug + g * F * L, F, D.FP, L, L, D.LP, D.ts, vec, tid, THREADS);
  load_tile(ka, k_aug + g * F * L, F, D.FP, L, L, D.LP, D.ts, vec, tid, THREADS);
  load_tile(va, v_s + g * ds * L, ds, ds, L, L, D.LP, D.ts, vec, tid, THREADS);
  load_tile(va + ds * D.ts, v_p + g * p3 * L, p3, D.FVP - ds, L, L, D.LP, D.ts, vec, tid,
            THREADS);
  cp_async_wait_all();
  __syncthreads();
  if (m0 >= D.LP) return;  // warp-uniform; no block barrier follows

  float s[MAX_KEY_TILES][4];
  logits<T>(qa, D.ts, m0, ka, D.ts, D.FP, D.LP, lane, s);
  softmax_rows<T>(s, bias + ((size_t)target * h + hh) * L * L, L, D.LP, m0, scale_total, lane);
  store_weights<T>(s, attn + g * L * L, L, m0, 0, D.LP, lane, wtile, D.as);
  float o[MAX_V_TILES][4];
  weighted_sums<T>(s, va, D.ts, D.FVP, D.LP, lane, o);
  write_outputs<T>(o, qa + m0, D, out_s, out_p, g, m0, lane, vec);
}

// L > MAX_L: one block per (head, design, chunk of CHUNK query rows), the
// keys streamed through the tiles in chunks (ipa_tc::chunked_attention);
// the tiles are those of L = CHUNK (D is made for CHUNK, D.L is the
// patch's L)
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
attention_chunked_kernel(const T* __restrict__ q_aug, const T* __restrict__ k_aug,
                         const T* __restrict__ v_s, const T* __restrict__ v_p,
                         const T* __restrict__ bias, T* __restrict__ out_s,
                         T* __restrict__ out_p, T* __restrict__ attn, const Dims D, int h,
                         int n_designs, float scale_total) {
  const int hh = blockIdx.x, design = blockIdx.y, target = design / n_designs;
  const int q0 = blockIdx.z * CHUNK, tid = threadIdx.x, warp = tid / 32;
  const int L = D.L, F = D.F, ds = D.ds, p3 = D.p3;
  const size_t g = (size_t)design * h + hh;

  extern __shared__ __align__(16) unsigned char smem[];
  T* qa = reinterpret_cast<T*>(smem);
  T* ka = reinterpret_cast<T*>(smem + D.qk_bytes);
  T* va = reinterpret_cast<T*>(smem + 2 * D.qk_bytes);
  T* wtile = reinterpret_cast<T*>(smem + 2 * D.qk_bytes + D.v_bytes + warp * D.warp_bytes);

  float o[MAX_V_TILES][4];
  chunked_attention<T>(q_aug + g * F * L, k_aug + g * F * L, F, D.FP, v_s + g * ds * L, ds,
                       v_p + g * p3 * L, p3, D.FVP, L, L, L,
                       bias + ((size_t)target * h + hh) * L * L, attn + g * L * L, q0,
                       scale_total, qa, ka, va, D.ts, wtile, D.as, tid, THREADS, o);
  const int i0 = q0 + 16 * warp;
  if (i0 >= round_up(L, 16)) return;  // warp-uniform; no block barrier follows
  write_outputs<T>(o, qa + 16 * warp, D, out_s, out_p, g, i0, tid % 32, L % 8 == 0);
}

template <typename T>
int run(const void* q_aug, const void* k_aug, const void* v_s, const void* v_p,
        const void* bias, void* out_s, void* out_p, void* attn, int b, int bp, int L, int h,
        int F, int ds, int p3, float scale_total, cudaStream_t stream) {
  const bool chunked = L > MAX_L;
  Dims D = attention_dims<T>(chunked ? CHUNK : L, F, ds, p3);
  D.L = L;
  if (D.FVP > D.FP || D.total > 232448) return cudaErrorInvalidValue;
  auto kernel = chunked ? attention_chunked_kernel<T> : attention_kernel<T>;
  if (D.total > 48 * 1024) {
    const cudaError_t err = ptx::allow_dynamic_smem(kernel, D.total);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(h, b, (L + CHUNK - 1) / CHUNK), THREADS, D.total, stream>>>(
      static_cast<const T*>(q_aug), static_cast<const T*>(k_aug),
      static_cast<const T*>(v_s), static_cast<const T*>(v_p), static_cast<const T*>(bias),
      static_cast<T*>(out_s), static_cast<T*>(out_p), static_cast<T*>(attn), D, h, b / bp,
      scale_total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, of every operand, the bias included.
// Returns a cudaError_t (0 on success); cudaErrorInvalidValue for shapes the
// kernel does not take.
int ipa_attention_forward(int dtype, const void* q_aug, const void* k_aug, const void* v_s,
                          const void* v_p, const void* bias, void* out_s, void* out_p,
                          void* attn, int b, int bp, int L, int h, int F, int ds, int p3,
                          float scale_total, void* stream) {
  if (L < 1 || bp < 1 || b % bp != 0 || h < 1 || ds < 0 || p3 < 0 ||
      ds + p3 < 1 || ds + p3 > MAX_FV || F <= ds + p3 || F > MAX_F)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(q_aug, k_aug, v_s, v_p, bias, out_s, out_p, attn, b, bp, L, h, F, ds, p3,
                      scale_total, s);
  if (dtype == 1)
    return run<bf16>(q_aug, k_aug, v_s, v_p, bias, out_s, out_p, attn, b, bp, L, h, F, ds, p3,
                     scale_total, s);
  return cudaErrorInvalidValue;
}

const char* ipa_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
