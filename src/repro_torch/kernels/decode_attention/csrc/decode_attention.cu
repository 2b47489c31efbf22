// Decode attention over a contiguous KV cache for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py::
// decode_attention_bhd (body _kernel). One query per (b, q-head), q
// (b, hq, d), against the cache in the model's own layout, k (b, S, hkv, d)
// and v (b, S, hkv, dv): no transpose and no padding to block multiples.
// Row b sees keys k < kv_lens[b] (clamped to S). The lengths are a (b,)
// vector, so the lockstep decode (one scalar length, passed filled) and the
// dense engine's per-slot lengths are the same call.
//
// It is the walk of ../../csrc/attention_walk.cuh (the design and what
// bounds it are described there) with tiles of 16 cache rows: a block owns
// (row b, kv head, up to 8 of the g q-heads sharing that kv head), and walks
// the tiles holding keys below the row's length. The Pallas kernel split
// the cache into a sequential grid axis with the softmax state in VMEM
// scratch; here the same walk is a loop inside the block.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream
// and returns cudaGetLastError() so a refused launch is reported.

#include "../../csrc/attention_walk.cuh"

namespace {

using attn::kThreads;
using attn::kWarps;

constexpr int kTile = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_lens,
              T* __restrict__ out, int hq, int hkv, int d, int dv, int S,
              float scale, int g_major) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int g = hq / hkv;
  const int gi = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int h = g_major ? gi * hkv + kvh : kvh * g + gi;
  const int kv_len = max(min(kv_lens[b], S), 0);
  // cache element (b, t, kvh, e) sits at ((b * S + t) * hkv + kvh) * d
  auto tile = [&](int j, const T*& kp, const T*& vp, int& n) {
    const size_t base = ((size_t)b * S + j * kTile) * hkv + kvh;
    kp = k + base * d;
    vp = v + base * dv;
    n = min(kTile, S - j * kTile);
  };
  const size_t row = (size_t)b * hq + h;
  attn::attend<T, kTile>(q + row * d, out + row * dv, gi < g, kv_len - 1,
                         kv_len, (kv_len + kTile - 1) / kTile, hkv * d,
                         hkv * dv, d, dv, scale, tile,
                         reinterpret_cast<T*>(smem_raw));
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_lens, void* out, int b, int hq, int hkv,
                   int d, int dv, int S, float scale, int g_major,
                   cudaStream_t stream) {
  const int g = hq / hkv;
  const dim3 grid((g + kWarps - 1) / kWarps, hkv, b);
  const size_t smem = 2 * (size_t)kTile * (d + dv) * sizeof(T);
  return attn::launch(decode_kernel<T>, grid, smem, stream,
                      static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), kv_lens, static_cast<T*>(out),
                      hq, hkv, d, dv, S, scale, g_major);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Sizes are checked by the caller:
// hq % hkv == 0, d and dv <= 256 and rows of whole 16-byte chunks, k and v
// 16-byte aligned, b, S >= 1. Returns a cudaError_t as int (0 = success).
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, const void* kv_lens,
                                void* out, int b, int hq, int hkv, int d,
                                int dv, int S, float scale, int g_major,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* kl = static_cast<const int*>(kv_lens);
  cudaError_t e;
  if (dtype == 0) {
    e = launch<float>(q, k, v, kl, out, b, hq, hkv, d, dv, S, scale, g_major,
                      st);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(q, k, v, kl, out, b, hq, hkv, d, dv, S, scale,
                              g_major, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
