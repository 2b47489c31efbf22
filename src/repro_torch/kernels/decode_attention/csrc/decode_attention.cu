// Decode attention over a contiguous KV cache for NVIDIA Hopper (sm_90a),
// split over keys.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py:59
// (decode_attention_bhd, its pallas_call at :71, body _kernel). One query
// per (b, q-head), q (b, hq, d), against the cache in the model's own
// layout, k (b, S, hkv, d) and v (b, S, hkv, dv): no transpose and no
// padding to block multiples. Row b sees keys k < its length (kv_lens[b],
// or one length for every row), clamped to [0, S]. Float32 math from bf16
// or f32 inputs, output in q's dtype, denominator floored at 1e-30.
//
// What bounds it on an H100 is the bytes of the visible K/V rows against
// 3.35 TB/s, a few hundred kB at the paths' shapes: a microsecond or less.
// One block per (row, kv head) walking every key in turn, as the Pallas
// kernel's sequential grid axis did, gives 4 blocks on 132 SMs at gemma-2b's
// four slots. So the keys are split over the grid, as the Pallas kernel's
// blk_k split them over its sequential axis:
//   - Pass 1 (decode_split_kernel), grid (n_split, hkv, b): a block owns one
//     range of ``split`` keys for the g q-heads of one kv head. It stages
//     the range's rows below the length in shared memory with 16-byte
//     cp.async (K rows padded to an odd number of 16-byte chunks, so
//     neighbouring lanes read distinct banks), and lanes go over keys: each
//     thread computes whole dot products, q broadcast from shared memory as
//     f32, with no per-key shuffle reduction and every warp live when
//     g = 1. It writes an f32 partial (m, l, o[dv]) per (b, q-head, split);
//     a range wholly at or past the length loads nothing and writes
//     m = -inf, l = 0.
//   - Pass 2 (decode_merge_kernel), one block per (b, q-head): merges the
//     non-empty partials in split order and writes the output. No atomics,
//     so every call gives the same bits.
// The split plan (``split_plan`` in ../ops.py) depends on S, b, hkv and the
// SM count only, never on the lengths, so no host sync is needed.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream
// and returns cudaGetLastError() so a refused launch is reported.

#include "../../csrc/attention_walk.cuh"  // type conversions, warp_sum
#include "../../csrc/hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMergeThreads = 128;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

using attn::from_float;
using attn::to_float;
using attn::warp_sum;

// q . (one 16-byte chunk of a key row), q as f32 at the chunk's columns
__device__ __forceinline__ float dot16(uint4 raw, const float* qv, float) {
  const float4 qf = *reinterpret_cast<const float4*>(qv);
  return __uint_as_float(raw.x) * qf.x + __uint_as_float(raw.y) * qf.y +
         __uint_as_float(raw.z) * qf.z + __uint_as_float(raw.w) * qf.w;
}
__device__ __forceinline__ float dot16(uint4 raw, const float* qv,
                                       __nv_bfloat16) {
  const float4 q0 = *reinterpret_cast<const float4*>(qv);
  const float4 q1 = *reinterpret_cast<const float4*>(qv + 4);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  const float2 c = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.z));
  const float2 e = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.w));
  return a.x * q0.x + a.y * q0.y + b.x * q0.z + b.y * q0.w + c.x * q1.x +
         c.y * q1.y + e.x * q1.z + e.y * q1.w;
}

// Shared memory of pass 1, in bytes from the start: K rows of kcs 16-byte
// chunks, V rows of dv elements, q of the g heads as f32, the g x split
// scores (then probabilities), each head's (m, l), and kThreads x 8 floats
// of P.V partial sums where several threads share one output chunk.
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

// acc[0..kPer) += p * (one 16-byte chunk of a V row)
__device__ __forceinline__ void axpy16(float (&acc)[8], float p, uint4 raw,
                                       float) {
  acc[0] += p * __uint_as_float(raw.x);
  acc[1] += p * __uint_as_float(raw.y);
  acc[2] += p * __uint_as_float(raw.z);
  acc[3] += p * __uint_as_float(raw.w);
}
__device__ __forceinline__ void axpy16(float (&acc)[8], float p, uint4 raw,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[u]));
    acc[2 * u] += p * f.x;
    acc[2 * u + 1] += p * f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_lens,
                    int kv_len_all, float* __restrict__ ws_o,
                    float* __restrict__ ws_ml, int hq, int hkv, int d, int dv,
                    int S, int split, float scale, int g_major) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_split = gridDim.x;
  const int g = hq / hkv;
  const int tid = threadIdx.x;
  const int len = max(min(kv_lens ? kv_lens[b] : kv_len_all, S), 0);
  const int k0 = sp * split;
  const int n = min(split, len - k0);  // keys of the range below the length
  auto head = [&](int gi) { return g_major ? gi * hkv + kvh : kvh * g + gi; };
  auto part = [&](int gi) {
    return ((size_t)b * hq + head(gi)) * n_split + sp;
  };
  if (n <= 0) {
    for (int gi = tid; gi < g; gi += kThreads) {
      ws_ml[2 * part(gi)] = -INFINITY;
      ws_ml[2 * part(gi) + 1] = 0.f;
    }
    return;
  }
  const Layout lay(split, g, d, dv, (int)sizeof(T));
  unsigned char* sK = smem_raw;
  const uint4* sV = reinterpret_cast<const uint4*>(smem_raw + lay.k_bytes);
  float* sQ = reinterpret_cast<float*>(smem_raw + lay.q_off);
  float* sS = reinterpret_cast<float*>(smem_raw + lay.s_off);
  float* sML = reinterpret_cast<float*>(smem_raw + lay.ml_off);
  float* sPart = reinterpret_cast<float*>(smem_raw + lay.part_off);

  // stage the n rows: cache row (b, t, kvh) sits at ((b * S + t) * hkv + kvh)
  const int kc = d * (int)sizeof(T) / 16;
  const int vc = dv * (int)sizeof(T) / 16;
  const size_t row0 = ((size_t)b * S + k0) * hkv + kvh;
  const char* kg = reinterpret_cast<const char*>(k + row0 * d);
  const char* vg = reinterpret_cast<const char*>(v + row0 * dv);
  const size_t k_step = (size_t)hkv * d * sizeof(T);
  const size_t v_step = (size_t)hkv * dv * sizeof(T);
  for (int x = tid; x < n * kc; x += kThreads) {
    const int t = x / kc;
    const int c = x - t * kc;
    hop::cp16(sK + (t * lay.kcs + c) * 16, kg + t * k_step + c * 16, true);
  }
  for (int x = tid; x < n * vc; x += kThreads) {
    const int t = x / vc;
    const int c = x - t * vc;
    hop::cp16(smem_raw + lay.k_bytes + (size_t)x * 16,
              vg + t * v_step + c * 16, true);
  }
  hop::cp_commit();
  for (int x = tid; x < g * d; x += kThreads) {
    const int gi = x / d;
    sQ[x] = to_float(q[((size_t)b * hq + head(gi)) * d + (x - gi * d)]);
  }
  hop::cp_wait<0>();
  __syncthreads();

  // scores: one (head, key) per thread, keys on neighbouring lanes; four
  // partial sums in a fixed order keep loads in flight
  constexpr int kPer = 16 / (int)sizeof(T);  // elements per chunk
  for (int x = tid; x < g * n; x += kThreads) {
    const int gi = x / n;
    const int t = x - gi * n;
    const uint4* kr = reinterpret_cast<const uint4*>(sK + t * lay.kcs * 16);
    const float* qv = sQ + gi * d;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int c = 0;
    for (; c + 4 <= kc; c += 4) {
      a0 += dot16(kr[c], qv + c * kPer, T());
      a1 += dot16(kr[c + 1], qv + (c + 1) * kPer, T());
      a2 += dot16(kr[c + 2], qv + (c + 2) * kPer, T());
      a3 += dot16(kr[c + 3], qv + (c + 3) * kPer, T());
    }
    for (; c < kc; ++c) a0 += dot16(kr[c], qv + c * kPer, T());
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
    l = warp_sum(l);
    if (lane == 0) {
      sML[2 * gi] = m;
      sML[2 * gi + 1] = l;
    }
  }
  __syncthreads();

  // o = p . V over the range: a thread owns one 16-byte chunk of one head's
  // output; where there are fewer chunks than threads, kq threads share a
  // chunk, each taking every kq-th key, and their sums are added in order
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
    for (int t = gr; t < n; t += kq) axpy16(acc, pr[t], sV[t * vc + c], T());
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

// One block per (row b, q-head h): the partials' weights exp(m_s - M) in
// shared memory (zero for empty ranges), then each output column summed
// over the ranges in order.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ ws_o,
                    const float* __restrict__ ws_ml, T* __restrict__ out,
                    int hq, int dv, int n_split) {
  extern __shared__ float sW[];  // n_split weights, then n_split sums
  __shared__ float sRed[kMergeThreads / 32];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t p0 = ((size_t)b * hq + h) * n_split;
  const float* ml = ws_ml + 2 * p0;
  float* sL = sW + n_split;
  float M = -INFINITY;
  for (int s = tid; s < n_split; s += kMergeThreads) {
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
  for (int s = tid; s < n_split; s += kMergeThreads)
    sW[s] = sL[s] > 0.f ? expf(sW[s] - M) : 0.f;  // empty ranges wrote no o
  __syncthreads();
  float L = 0.f;
  for (int s = 0; s < n_split; ++s) L += sW[s] * sL[s];
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int e = tid; e < dv; e += kMergeThreads) {
    float acc = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float o = ws_o[(p0 + s) * dv + e];  // any bits where w = 0
      const float w = sW[s];
      acc += w != 0.f ? w * o : 0.f;
    }
    out[((size_t)b * hq + h) * dv + e] = from_float<T>(acc * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_lens, void* out, float* ws_o, float* ws_ml,
                   int b, int hq, int hkv, int d, int dv, int S, int split,
                   int kv_len_all, float scale, int g_major,
                   cudaStream_t stream) {
  const int g = hq / hkv;
  const int n_split = (S + split - 1) / split;
  const Layout lay(split, g, d, dv, (int)sizeof(T));
  cudaError_t e = hop::launch(
      decode_split_kernel<T>, dim3(n_split, hkv, b), kThreads,
      (size_t)lay.total, stream, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), kv_lens, kv_len_all,
      ws_o, ws_ml, hq, hkv, d, dv, S, split, scale, g_major);
  if (e != cudaSuccess) return e;
  return hop::launch(decode_merge_kernel<T>, dim3(hq, b), kMergeThreads,
                     2 * (size_t)n_split * sizeof(float), stream,
                     static_cast<const float*>(ws_o),
                     static_cast<const float*>(ws_ml), static_cast<T*>(out),
                     hq, dv, n_split);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_lens: a (b,) int32 vector, or null
// for one length kv_len_all on every row. ws_o: b * hq * n_split * dv
// floats, ws_ml: b * hq * n_split * 2 floats, n_split = ceil(S / split).
// Sizes are checked by the caller: hq % hkv == 0, d and dv <= 256 and rows
// of whole 16-byte chunks, k and v 16-byte aligned, b, S, split >= 1.
// Returns a cudaError_t as int (0 = success).
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, const void* kv_lens,
                                void* out, void* ws_o, void* ws_ml, int b,
                                int hq, int hkv, int d, int dv, int S,
                                int split, int kv_len_all, float scale,
                                int g_major, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* kl = static_cast<const int*>(kv_lens);
  float* wo = static_cast<float*>(ws_o);
  float* wml = static_cast<float*>(ws_ml);
  cudaError_t e;
  if (dtype == 0) {
    e = launch<float>(q, k, v, kl, out, wo, wml, b, hq, hkv, d, dv, S, split,
                      kv_len_all, scale, g_major, st);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(q, k, v, kl, out, wo, wml, b, hq, hkv, d, dv, S,
                              split, kv_len_all, scale, g_major, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
