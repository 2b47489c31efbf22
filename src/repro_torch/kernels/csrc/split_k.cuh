// Split-K decode attention for NVIDIA Hopper (sm_90a): the two passes that
// the contiguous-cache decode (K4, decode_attention/csrc/decode_attention.cu)
// and the paged decode at float32 q (K2, and K1 at C = 1,
// paged_attention/csrc/paged_prefill_attention.cu) share. The paged decode
// at bf16 q runs its own pass 1 on the tensor cores
// (paged_split_kernel_mma, which keeps K/V tiles in shared memory once for
// all g heads of a kv head) and this file's ``merge``. Each .cu file
// wraps them in __global__ kernels of its own names, so a profile tells K4
// from the paged decode; K2 and K1 at C = 1 run the same kernels (that is
// what makes them equal bit for bit), so a profile cannot tell those two
// apart.
//
// One query per (row b, q-head). The keys of a row are cut into ranges of
// ``split`` keys; a block of pass 1 owns one range for the g q-heads of one
// kv head and writes an f32 partial (m, l, o[dv]) per head:
//   - it stages the range's rows below the row's length in shared memory
//     with 16-byte cp.async (K rows padded to an odd number of 16-byte
//     chunks, so neighbouring lanes read distinct banks); where the rows
//     live (a contiguous cache, or pool pages through a page table) is the
//     caller's ``rows`` functor;
//   - lanes go over keys: each thread computes whole dot products, q
//     broadcast from shared memory as f32, with no per-key shuffle
//     reduction and every warp live when g = 1;
//   - o = p.V with 16-byte V chunks per thread (threads sharing a chunk
//     where there are fewer chunks than threads, their sums added in order).
// Pass 2 (``merge``) merges the non-empty partials of a row in range order
// and writes the output.
//
// K/V may be e4m3 (an fp8 KV cache, KV = __nv_fp8_e4m3) under f32 or bf16
// q (T): the rows are staged as their e4m3 bytes (16 elements a 16-byte
// chunk), and the products walk them in units of T's 16-byte chunk (kPer =
// 16 / sizeof(T) elements: 4 at f32, 8 at bf16), each unit widened
// exactly in registers (hop::fp8x2_to_float2). The units, their order, the
// threads that share an output unit and every product and sum are those
// of the same call on K/V upcast to T, so it gives that call's bits. No atomics, so every call gives the same bits.
// Scores are in natural units (expf) for this pass 1, or in log2 units
// (exp2f) for the paged kernels' tensor-core passes (the prefill's M rows,
// the bf16 decode's heads), which reuse ``merge``.

#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_walk.cuh"  // type conversions, warp_sum
#include "hopper.cuh"

namespace splitk {

constexpr int kThreads = 128;
constexpr int kMergeThreads = 128;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

using fp8 = __nv_fp8_e4m3;

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// One unit (T's 16-byte chunk: kPer elements) of a K or V row staged in
// shared memory as KV, element c * kPer on, widened to floats: f32 units as
// float4, bf16 units as four float2.
template <typename T, typename KV>
struct Unit;
template <>
struct Unit<float, float> {
  float4 x;
  __device__ __forceinline__ Unit(const unsigned char* row, int c) {
    x = reinterpret_cast<const float4*>(row)[c];
  }
};
template <>
struct Unit<float, fp8> {
  float4 x;
  __device__ __forceinline__ Unit(const unsigned char* row, int c) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(row)[c];
    const float2 lo = hop::fp8x2_to_float2(w);
    const float2 hi = hop::fp8x2_to_float2(w >> 16);
    x = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};
template <>
struct Unit<__nv_bfloat16, __nv_bfloat16> {
  float2 x[4];
  __device__ __forceinline__ Unit(const unsigned char* row, int c) {
    const uint4 raw = reinterpret_cast<const uint4*>(row)[c];
    x[0] = bf16x2_to_float2(raw.x);
    x[1] = bf16x2_to_float2(raw.y);
    x[2] = bf16x2_to_float2(raw.z);
    x[3] = bf16x2_to_float2(raw.w);
  }
};
template <>
struct Unit<__nv_bfloat16, fp8> {
  float2 x[4];
  __device__ __forceinline__ Unit(const unsigned char* row, int c) {
    const uint2 raw = reinterpret_cast<const uint2*>(row)[c];
    x[0] = hop::fp8x2_to_float2(raw.x);
    x[1] = hop::fp8x2_to_float2(raw.x >> 16);
    x[2] = hop::fp8x2_to_float2(raw.y);
    x[3] = hop::fp8x2_to_float2(raw.y >> 16);
  }
};

// q . (one unit of a key row), q as f32 at the unit's columns
__device__ __forceinline__ float dot_unit(const float4& x, const float* qv) {
  const float4 qf = *reinterpret_cast<const float4*>(qv);
  return x.x * qf.x + x.y * qf.y + x.z * qf.z + x.w * qf.w;
}
__device__ __forceinline__ float dot_unit(const float2 (&x)[4],
                                          const float* qv) {
  const float4 q0 = *reinterpret_cast<const float4*>(qv);
  const float4 q1 = *reinterpret_cast<const float4*>(qv + 4);
  return x[0].x * q0.x + x[0].y * q0.y + x[1].x * q0.z + x[1].y * q0.w +
         x[2].x * q1.x + x[2].y * q1.y + x[3].x * q1.z + x[3].y * q1.w;
}
template <typename T, typename KV>
__device__ __forceinline__ float dot16(const unsigned char* row, int c,
                                       const float* qv) {
  return dot_unit(Unit<T, KV>(row, c).x, qv);
}

// Shared memory of pass 1, in bytes from the start: K rows of kcs 16-byte
// chunks, V rows of dv elements (es bytes each: K/V's own size), q of the g
// heads as f32, the g x split scores (then probabilities), each head's (m,
// l), and kThreads x 8 floats of P.V partial sums where several threads
// share one output unit.
struct Layout {
  int kcs, k_bytes, v_bytes, q_off, s_off, ml_off, part_off, total;
  __host__ __device__ Layout(int split, int g, int d, int dv, int es) {
    kcs = (d * es / 16) | 1;  // an odd count: conflict-free row reads
    k_bytes = split * kcs * 16;
    v_bytes = split * dv * es;
    q_off = k_bytes + v_bytes;
    s_off = q_off + g * d * 4;
    ml_off = s_off + ((g * split * 4 + 15) & ~15);
    part_off = ml_off + ((g * 2 * 4 + 15) & ~15);
    total = part_off + kThreads * 8 * 4;
  }
};

// acc[0..kPer) += p * (one unit of a V row)
__device__ __forceinline__ void axpy_unit(float (&acc)[8], float p,
                                          const float4& x) {
  acc[0] += p * x.x;
  acc[1] += p * x.y;
  acc[2] += p * x.z;
  acc[3] += p * x.w;
}
__device__ __forceinline__ void axpy_unit(float (&acc)[8], float p,
                                          const float2 (&x)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    acc[2 * u] += p * x[u].x;
    acc[2 * u + 1] += p * x[u].y;
  }
}
template <typename T, typename KV>
__device__ __forceinline__ void axpy16(float (&acc)[8], float p,
                                       const unsigned char* row, int c) {
  axpy_unit(acc, p, Unit<T, KV>(row, c).x);
}

// A range with no key below the row's length: m = -inf, l = 0 for each of
// the g heads (``part(gi)`` is head gi's partial index); merge skips it.
template <typename PartFn>
__device__ __forceinline__ void empty_partial(float* ws_ml, int g,
                                              PartFn part) {
  for (int gi = threadIdx.x; gi < g; gi += kThreads) {
    ws_ml[2 * part(gi)] = -INFINITY;
    ws_ml[2 * part(gi) + 1] = 0.f;
  }
}

// Pass 1 of one block over the n >= 1 keys of its range (n <= split).
// ``rows(t, kp, vp)`` sets the global addresses of range row t's K and V
// rows (of KV elements: T, or e4m3 under an fp8 cache); ``head(gi)`` is
// q-head gi of this kv head's group; ``part(gi)`` its partial index into
// ws_o (rows of dv floats) and ws_ml (pairs). qb points at row b's q
// (hq x d).
template <typename T, typename KV, typename RowFn, typename HeadFn,
          typename PartFn>
__device__ __forceinline__ void partial(const T* __restrict__ qb, int n,
                                        int split, int g, int d, int dv,
                                        float scale, RowFn rows, HeadFn head,
                                        PartFn part, float* __restrict__ ws_o,
                                        float* __restrict__ ws_ml,
                                        unsigned char* smem_raw) {
  const int tid = threadIdx.x;
  constexpr int es = (int)sizeof(KV);
  const Layout lay(split, g, d, dv, es);
  unsigned char* sK = smem_raw;
  const unsigned char* sV = smem_raw + lay.k_bytes;
  float* sQ = reinterpret_cast<float*>(smem_raw + lay.q_off);
  float* sS = reinterpret_cast<float*>(smem_raw + lay.s_off);
  float* sML = reinterpret_cast<float*>(smem_raw + lay.ml_off);
  float* sPart = reinterpret_cast<float*>(smem_raw + lay.part_off);

  // stage the rows in 16-byte chunks of KV
  const int k16 = d * es / 16;
  const int v16 = dv * es / 16;
  for (int x = tid; x < n * k16; x += kThreads) {
    const int t = x / k16;
    const int c = x - t * k16;
    const KV* kp;
    const KV* vp;
    rows(t, kp, vp);
    hop::cp16(sK + (t * lay.kcs + c) * 16,
              reinterpret_cast<const char*>(kp) + c * 16, true);
  }
  for (int x = tid; x < n * v16; x += kThreads) {
    const int t = x / v16;
    const int c = x - t * v16;
    const KV* kp;
    const KV* vp;
    rows(t, kp, vp);
    hop::cp16(smem_raw + lay.k_bytes + (size_t)x * 16,
              reinterpret_cast<const char*>(vp) + c * 16, true);
  }
  hop::cp_commit();
  for (int x = tid; x < g * d; x += kThreads) {
    const int gi = x / d;
    sQ[x] = attn::to_float(qb[(size_t)head(gi) * d + (x - gi * d)]);
  }
  hop::cp_wait<0>();
  __syncthreads();

  // scores: one (head, key) per thread, keys on neighbouring lanes; four
  // partial sums in a fixed order keep loads in flight
  constexpr int kPer = 16 / (int)sizeof(T);  // elements per unit
  const int kc = d / kPer;                   // units per row
  const int vc = dv / kPer;
  for (int x = tid; x < g * n; x += kThreads) {
    const int gi = x / n;
    const int t = x - gi * n;
    const unsigned char* kr = sK + t * lay.kcs * 16;
    const float* qv = sQ + gi * d;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int c = 0;
    for (; c + 4 <= kc; c += 4) {
      a0 += dot16<T, KV>(kr, c, qv + c * kPer);
      a1 += dot16<T, KV>(kr, c + 1, qv + (c + 1) * kPer);
      a2 += dot16<T, KV>(kr, c + 2, qv + (c + 2) * kPer);
      a3 += dot16<T, KV>(kr, c + 3, qv + (c + 3) * kPer);
    }
    for (; c < kc; ++c) a0 += dot16<T, KV>(kr, c, qv + c * kPer);
    sS[gi * split + t] = ((a0 + a1) + (a2 + a3)) * scale;
  }
  __syncthreads();

  // per head: max, probabilities and their sum, one warp a head
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int gi = warp; gi < g; gi += kThreads / 32) {
    float* sr = sS + gi * split;
    float m = -INFINITY;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, sr[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(sr[t] - m);
      sr[t] = p;
      l += p;
    }
    l = attn::warp_sum(l);
    if (lane == 0) {
      sML[2 * gi] = m;
      sML[2 * gi + 1] = l;
    }
  }
  __syncthreads();

  // o = p . V over the range: a thread owns one unit of one head's output;
  // where there are fewer units than threads, kq threads share a unit, each
  // taking every kq-th key, and their sums are added in order
  const int items = g * vc;
  int kq = 1;
  while (2 * kq * items <= kThreads && 2 * kq <= n) kq *= 2;
  for (int x = tid; x < items * kq; x += kThreads) {
    const int item = x % items;
    const int gr = x / items;
    const int gi = item / vc;
    const int c = item - gi * vc;
    const float* pr = sS + gi * split;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    // unrolled for bf16; unrolled at f32, ptxas spills
    constexpr int kUnroll = kPer == 8 ? 4 : 1;
#pragma unroll (kUnroll)
    for (int t = gr; t < n; t += kq)
      axpy16<T, KV>(acc, pr[t], sV + (size_t)t * dv * es, c);
    float* dst = kq == 1 ? ws_o + part(gi) * dv + c * kPer
                         : sPart + (size_t)x * kPer;
#pragma unroll
    for (int u = 0; u < kPer; ++u) dst[u] = acc[u];
  }
  if (kq > 1) {
    __syncthreads();
    for (int x = tid; x < items * kPer; x += kThreads) {
      const int item = x / kPer;
      const int gi = item / vc;
      float acc = 0.f;
      for (int gr = 0; gr < kq; ++gr) acc += sPart[gr * items * kPer + x];
      ws_o[part(gi) * dv + (item - gi * vc) * kPer + (x - item * kPer)] = acc;
    }
  }
  for (int gi = tid; gi < g; gi += kThreads) {
    ws_ml[2 * part(gi)] = sML[2 * gi];
    ws_ml[2 * part(gi) + 1] = sML[2 * gi + 1];
  }
}

// Pass 2 for one output row (row = blockIdx.x of R rows, batch row
// blockIdx.y): the partials' weights exp(m_s - M) (exp2 where LOG2, the
// scores' units) in shared memory, zero for empty ranges (l = 0), then each
// output column summed over the ranges in order. The row's partials are
// the first ``count`` of its n_split (all of them where count < 0). Needs
// 2 * n_split floats of dynamic shared memory (sW). This file's decodes
// load every partial's o (no load waits on its weight); SPARSE loads only
// those of non-empty ranges, for the paged tensor-core passes, where a
// row may leave most ranges empty.
template <typename T, bool LOG2, bool SPARSE = false>
__device__ __forceinline__ void merge(const float* __restrict__ ws_o,
                                      const float* __restrict__ ws_ml,
                                      T* __restrict__ out, int R, int dv,
                                      int n_split, float* sW,
                                      int count = -1) {
  __shared__ float sRed[kMergeThreads / 32];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t p0 = ((size_t)b * R + h) * n_split;
  const float* ml = ws_ml + 2 * p0;
  float* sL = sW + n_split;
  if (count < 0) count = n_split;
  float M = -INFINITY;
  for (int s = tid; s < count; s += kMergeThreads) {
    const float m = ml[2 * s];
    const float l = ml[2 * s + 1];
    sW[s] = m;
    sL[s] = l;
    if (l > 0.f) M = fmaxf(M, m);
  }
  M = warp_max(M);
  if ((tid & 31) == 0) sRed[tid >> 5] = M;
  __syncthreads();
  M = sRed[0];
#pragma unroll
  for (int w = 1; w < kMergeThreads / 32; ++w) M = fmaxf(M, sRed[w]);
  for (int s = tid; s < count; s += kMergeThreads)
    sW[s] = sL[s] > 0.f ? (LOG2 ? exp2f(sW[s] - M) : expf(sW[s] - M))
                        : 0.f;  // empty ranges wrote no o
  __syncthreads();
  float L = 0.f;
  for (int s = 0; s < count; ++s) L += sW[s] * sL[s];
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int e = tid; e < dv; e += kMergeThreads) {
    float acc = 0.f;
#pragma unroll 4
    for (int s = 0; s < count; ++s) {
      const float w = sW[s];
      if (SPARSE) {
        if (w != 0.f) acc += w * ws_o[(p0 + s) * dv + e];
      } else {
        const float o = ws_o[(p0 + s) * dv + e];  // any bits where w = 0
        acc += w != 0.f ? w * o : 0.f;
      }
    }
    out[((size_t)b * R + h) * dv + e] = attn::from_float<T>(acc * inv);
  }
}

}  // namespace splitk
