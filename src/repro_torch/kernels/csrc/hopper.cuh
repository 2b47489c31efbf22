// Device helpers of the port's redesigned attention kernels for NVIDIA
// Hopper (sm_90a): the bf16 tensor-core paths of paged prefill (K1,
// paged_attention/csrc/paged_prefill_attention.cu) and flash attention (K3,
// flash_attention/csrc/flash_attention.cu), and the split-K decodes
// (split_k.cuh: K1 at C = 1 and K2 over pool pages, K4 over a contiguous
// cache).
//
// - cp.async of 16 bytes that zero-fills when the source row does not exist,
//   so a ragged tile's missing rows are zeros in shared memory, never stale
//   data (a zero key scores 0 and is masked; a zero value row adds 0 * 0);
// - ldmatrix (plain and transposed) and the bf16 tensor-core product
//   mma.sync m16n8k16 with float32 accumulators;
// - a launch with an explicit block size that raises the kernel's dynamic
//   shared memory limit past the default 48 KB when it needs more;
// - the widening of e4m3 (float8_e4m3fn) K/V elements in registers, for
//   an fp8 KV cache's pages: e4m3 -> fp16 is exact (fp16 holds every e4m3
//   value, subnormals included), fp16 -> f32 and f32 -> bf16 too, and NaN
//   stays NaN, so a kernel on fp8 pages computes on the values it would
//   read from the same pages upcast.

#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace hop {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory asynchronously; when !valid
// nothing is read and the 16 bytes are zeros (src must still be a mapped
// address, callers pass a row that exists).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of each lane receives its part of matrix i.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// As ldsm4, each matrix transposed on the way into registers.
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8, f32) += a (16x16, bf16, row major) * b (16x8, bf16, col major).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest-even bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two e4m3 values (the low byte first) as floats, exactly.
__device__ __forceinline__ float2 fp8x2_to_float2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
  return __half22float2(__half2(h));
}

// One e4m3 value as a float, exactly.
__device__ __forceinline__ float fp8_to_float(uint8_t one) {
  return fp8x2_to_float2(one).x;
}

// Two e4m3 values as a bf16 pair (the low byte in the low half), the
// tensor cores' operand form, exactly.
__device__ __forceinline__ uint32_t fp8x2_to_bf16x2(uint32_t two) {
  const float2 f = fp8x2_to_float2(two);
  return pack_bf16(f.x, f.y);
}

// Launch ``kernel`` with ``threads`` threads a block on the caller's
// stream, raising its dynamic shared memory limit first when it needs more
// than 48 KB; returns cudaGetLastError() so a refused launch is reported.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace hop
