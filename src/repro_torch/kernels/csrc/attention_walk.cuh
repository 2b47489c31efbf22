// Shared device code of the port's attention kernels for NVIDIA Hopper
// (sm_90a): paged chunked prefill (K1) and paged decode (K2) in
// paged_attention/csrc/paged_prefill_attention.cu, flash attention (K3) in
// flash_attention/csrc/flash_attention.cu and contiguous-cache decode (K4)
// in decode_attention/csrc/decode_attention.cu.
//
// All four compute one function: each query row attends, with an online
// softmax in float32, to the keys visible to it, where key kpos is visible
// iff  kpos <= qpos  and  kpos < kv_len  (qpos and kv_len per row). They
// differ only in where the keys live (pool pages through a page table, or a
// contiguous (b, S, hkv, d) cache) and in how qpos and kv_len follow from
// their arguments. ``attend`` is the walk they share.
//
// What bounds them on the card is the bytes of K/V they read, against
// 3.35 TB/s of HBM. One block owns kWarps query rows that share one kv head
// (chunk positions x the g q-heads of that kv head), one warp per row; the
// keys are walked in tiles of TILE rows, each staged in shared memory once
// and read by every row of the block, so on gemma-2b (8 q-heads on one kv
// head) a tile serves 8 heads. Tiles go in with 16-byte cp.async copies into
// two buffers: the copy of tile j+1 runs while tile j is computed. Each lane
// holds d/32 elements of q and dv/32 of the running output; dot products are
// warp reductions over d. Masked keys enter no p.V product at all, and their
// scores are replaced, not multiplied, so a NaN in a stale pool slot or in
// the unfilled rows of a partial tile cannot reach the output.

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace attn {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPerLane = 8;  // d, dv <= 256
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Queue the async copy of the first n rows of one K tile (rows of d
// elements, k_stride apart in memory) and one V tile (rows of dv, v_stride
// apart) into shared memory, packed row after row. Rows must be whole,
// 16-byte aligned chunks; the wrappers check.
template <typename T>
__device__ __forceinline__ void stage_tile(T* k_dst, T* v_dst, const T* kp,
                                           const T* vp, int n, int k_stride,
                                           int v_stride, int d, int dv) {
  const int kc = d * (int)sizeof(T) / 16;  // 16-byte chunks per row
  const int vc = dv * (int)sizeof(T) / 16;
  for (int x = threadIdx.x; x < n * kc; x += kThreads) {
    const int t = x / kc;
    __pipeline_memcpy_async(
        reinterpret_cast<char*>(k_dst) + (size_t)x * 16,
        reinterpret_cast<const char*>(kp + (size_t)t * k_stride) +
            (x - t * kc) * 16,
        16);
  }
  for (int x = threadIdx.x; x < n * vc; x += kThreads) {
    const int t = x / vc;
    __pipeline_memcpy_async(
        reinterpret_cast<char*>(v_dst) + (size_t)x * 16,
        reinterpret_cast<const char*>(vp + (size_t)t * v_stride) +
            (x - t * vc) * 16,
        16);
  }
  __pipeline_commit();
}

// One block's walk over n_tiles key tiles (n_tiles is the same for every
// thread of the block; every thread stages and syncs, inactive warps
// compute nothing). The warp's row is live when ``active``: qrow points at
// its d query elements, orow at its dv outputs. ``tile(j, kp, vp, n)`` sets
// the global addresses of tile j's first K and V rows and how many of its
// TILE rows exist; the rest of the buffer keeps stale data, which is safe
// because those keys lie past kv_len. smem holds two buffers of
// TILE * (d + dv) elements. The denominator is floored at 1e-30, so a row
// that sees no key writes zeros.
template <typename T, int TILE, typename TileFn>
__device__ __forceinline__ void attend(const T* qrow, T* orow, bool active,
                                       int qpos, int kv_len, int n_tiles,
                                       int k_stride, int v_stride, int d,
                                       int dv, float scale, TileFn tile,
                                       T* smem) {
  const int lane = threadIdx.x & 31;
  const int buf_elems = TILE * (d + dv);
  float qr[kMaxPerLane];
  float acc[kMaxPerLane];
#pragma unroll
  for (int u = 0; u < kMaxPerLane; ++u) {
    const int e = lane + 32 * u;
    qr[u] = (active && e < d) ? to_float(qrow[e]) : 0.f;
    acc[u] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  auto stage = [&](int j, T* dst) {
    const T* kp;
    const T* vp;
    int n;
    tile(j, kp, vp, n);
    stage_tile(dst, dst + TILE * d, kp, vp, n, k_stride, v_stride, d, dv);
  };
  if (n_tiles > 0) stage(0, smem);
  for (int j = 0; j < n_tiles; ++j) {
    const T* k_s = smem + (j & 1) * buf_elems;
    const T* v_s = k_s + TILE * d;
    if (j + 1 < n_tiles) {
      stage(j + 1, smem + ((j + 1) & 1) * buf_elems);
      __pipeline_wait_prior(1);  // tile j has landed, j+1 may be in flight
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();

    if (active) {
      float s[TILE];
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        float part = 0.f;
#pragma unroll
        for (int u = 0; u < kMaxPerLane; ++u) {
          const int e = lane + 32 * u;
          if (e < d) part += qr[u] * to_float(k_s[t * d + e]);
        }
        s[t] = part;
      }
      float m_tile = kNegInf;
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        const float dot = warp_sum(s[t]) * scale;
        const int kpos = j * TILE + t;
        s[t] = (kpos <= qpos && kpos < kv_len) ? dot : kNegInf;
        m_tile = fmaxf(m_tile, s[t]);
      }
      const float m_new = fmaxf(m, m_tile);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        s[t] = expf(s[t] - m_new);
        psum += s[t];
      }
      l = l * corr + psum;
#pragma unroll
      for (int u = 0; u < kMaxPerLane; ++u) acc[u] *= corr;
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        const int kpos = j * TILE + t;
        if (kpos <= qpos && kpos < kv_len) {
#pragma unroll
          for (int u = 0; u < kMaxPerLane; ++u) {
            const int e = lane + 32 * u;
            if (e < dv) acc[u] += s[t] * to_float(v_s[t * dv + e]);
          }
        }
      }
      m = m_new;
    }
    __syncthreads();
  }

  if (active) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int u = 0; u < kMaxPerLane; ++u) {
      const int e = lane + 32 * u;
      if (e < dv) orow[e] = from_float<T>(acc[u] / denom);
    }
  }
}

// Raise the kernel's dynamic shared memory limit when it needs more than
// the default 48 KB, then launch it on the caller's stream; returns
// cudaGetLastError() so a refused launch is reported.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace attn
