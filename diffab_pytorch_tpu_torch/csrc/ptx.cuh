// The PTX wrappers and small device helpers that the port's kernels share
// (sm_90a): shared-memory addresses, cp.async, ldmatrix, the bf16 and tf32
// mma.sync shapes, tf32 rounding and splitting, dtype conversions and tile
// strides, and one host helper (`allow_dynamic_smem`, the launches' shared
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
template <typename TB> __device__ __forceinline__ float load_f(const TB* p) {
  return to_f<TB>(*p);
}
// two neighbours at an even element index
template <typename TB> __device__ __forceinline__ void load_f2(const TB* p, float& a, float& b);
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
