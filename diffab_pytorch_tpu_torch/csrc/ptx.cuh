// The PTX wrappers and small device helpers that the port's kernels share
// (sm_90a): shared-memory addresses, cp.async, ldmatrix, the bf16 and tf32
// mma.sync shapes, mbarriers, named barriers, the async-proxy fence,
// setmaxnreg and the bf16 wgmma shape with its shared-memory descriptor,
// tf32 rounding and splitting, dtype conversions and tile strides, and one
// host helper (`allow_dynamic_smem`, the launches' shared
// memory limit set once per kernel and size).  Every kernel header includes
// this file; nothing here is defined anywhere else.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

namespace ptx {

using bf16 = __nv_bfloat16;

template <typename T> constexpr bool is_bf16 = std::is_same<T, bf16>::value;

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Row stride (elements) of a tile whose rows hold n elements (n a multiple
// of 8).  bf16: an odd count of 16-byte chunks, so the 8 rows one ldmatrix
// reads fall in 8 distinct groups of 4 banks.  float32: 8 more than a
// multiple of 32, so rows t and columns g of a tf32 fragment load
// (t * 8 + g) and 8-byte loads at (8 g + 2 t) hit 32 distinct banks.
template <typename T> __host__ __device__ constexpr int tile_stride(int n) {
  return is_bf16<T> ? ((n / 8) % 2 ? n : n + 8) : round_up(n, 32) + 8;
}

// ---- shared memory and asynchronous copies ----------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// the same, zero-filled when !valid (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- ldmatrix -------------------------------------------------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// ---- mma.sync -------------------------------------------------------------------
// d += a (16 x 16, row) b (16 x 8, col): bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 8, row) b (8 x 8, col): tf32 operands, f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- mbarriers, named barriers, proxy fence ---------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// one arrival (release: the thread's earlier writes are seen by the waiters)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// one arrival once every cp.async this thread issued so far has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
// wait until the phase of parity `parity` has completed (acquire); the loop
// stays inside the asm, so the compiler sees no branch around it
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// barrier `id` (1..15) among `threads` threads, e.g. one warpgroup
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// the thread's shared-memory writes (generic proxy) made visible to wgmma's
// reads (async proxy), and the other way round
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma (sm_90a) ------------------------------------------------------------------
// Operands in shared memory without swizzle, as 8 x 8 core matrices of 16-bit
// values (8 rows of 16 bytes, 128 contiguous bytes).  K-major: a core matrix
// holds 8 rows (M or N) of 8 consecutive k; MN-major (TRANS_B below): 8 rows
// of k of 8 consecutive m or n.  For both, the descriptor's leading field is
// the byte distance between core matrices that neighbour along K and its
// stride field that along M or N (held on the H100 by a probe of both
// majors and both orders).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t k_stride,
                                              uint32_t mn_stride) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(k_stride >> 4) << 16) |
         ((uint64_t)(mn_stride >> 4) << 32);
}

// the warpgroup's registers per thread: lowered to N (producer) or raised to
// N (consumers) once their neighbours in the block have lowered theirs
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across a
// wgmma issue or wait
template <int N> __device__ __forceinline__ void wgmma_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define PTX_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define PTX_D32_OUT(d)                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// d (64 x 64, f32) (+)= a (64 x 16, bf16, shared) b (16 x 64, bf16, shared);
// accumulate = 0 overwrites d.  TRANS_B: b is MN-major.  Row 16 w + r of d
// (w the warp of the warpgroup) is this thread's as mma.sync's m16n8 tiles
// lay it out: d[4 j + e] is row r = lane / 4 + 8 (e / 2), column 8 j + 2
// (lane % 4) + e % 2.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PTX_D32
               ", %32, %33, p, 1, 1, 0, %35;\n}\n"
               : PTX_D32_OUT(d)
               : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}
// the same with a from registers: this warp's 16 rows as mma.sync m16n8k16's
// A fragment
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PTX_D32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
               : PTX_D32_OUT(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
                 "n"(TRANS_B));
}
#undef PTX_D32
#undef PTX_D32_OUT

// ---- tf32 and bf16 values --------------------------------------------------------
// x rounded to tf32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), the 13 low bits cleared.  Half an ulp added to the magnitude
// bits, then truncated: two integer instructions, which made the float32
// kernels faster on the H100 than the cvt instruction did.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = big + small + O(2^-22 |x|), both in tf32; x - big is exact
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

// two neighbouring outputs a, b at an even element index
template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// one element of a read-only input, as float (a plain load: __ldg here
// made the float32 attention kernel ~6% slower on the H100)
template <typename T> __device__ __forceinline__ float load_f(const T* p) {
  return to_f<T>(*p);
}
// two neighbours at an even element index
template <typename T> __device__ __forceinline__ void load_f2(const T* p, float& a, float& b);
template <> __device__ __forceinline__ void load_f2<float>(const float* p, float& a, float& b) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  a = v.x, b = v.y;
}
template <> __device__ __forceinline__ void load_f2<bf16>(const bf16* p, float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v), b = __high2float(v);
}

// Host side: raise a kernel's dynamic shared-memory limit only where a
// launch needs more than the kernel was given on this device before.  The
// attribute call then runs once per kernel and size, in the first (eager)
// launch, so a launch captured into a CUDA graph later calls no runtime
// function besides the launch itself.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, int bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, int> given;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  int& have = given[{dev, reinterpret_cast<const void*>(kernel)}];
  if (bytes <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

}  // namespace ptx
