// Decode attention over a contiguous KV cache for NVIDIA Hopper (sm_90a),
// split over keys.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py:59
// (decode_attention_bhd, its pallas_call at :71, body _kernel). One query
// per (b, q-head), q (b, hq, d), against the cache in the model's own
// layout, k (b, S, hkv, d) and v (b, S, hkv, dv): no transpose and no
// padding to block multiples. Row b sees keys k < its length (kv_lens[b],
// or one length for every row), clamped to [0, S]. Float32 math from bf16
// or f32 inputs, output in q's dtype, denominator floored at 1e-30. The
// cache may be e4m3 (an fp8 KV cache: kv_cache_dtype = float8_e4m3fn)
// under either q: its rows are staged as bytes and each element widened
// exactly in registers, in the units and order of the same call on the
// cache upcast to q's dtype, whose bits it gives (split_k.cuh); the
// Pallas kernel likewise upcasts its K/V blocks in the body (kernel.py:37,
// :47).
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
// SM count only, never on the lengths, so no host sync is needed. The two
// passes' bodies are splitk::partial and splitk::merge in
// ../../csrc/split_k.cuh, which the paged decode (K2) shares.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream
// and returns cudaGetLastError() so a refused launch is reported.

#include "../../csrc/split_k.cuh"

namespace {

using splitk::kMergeThreads;
using splitk::kThreads;

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const int* __restrict__ kv_lens,
                    int kv_len_all, float* __restrict__ ws_o,
                    float* __restrict__ ws_ml, int hq, int hkv, int d, int dv,
                    int S, int split, float scale, int g_major) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_split = gridDim.x;
  const int g = hq / hkv;
  const int len = max(min(kv_lens ? kv_lens[b] : kv_len_all, S), 0);
  const int k0 = sp * split;
  const int n = min(split, len - k0);  // keys of the range below the length
  auto head = [&](int gi) { return g_major ? gi * hkv + kvh : kvh * g + gi; };
  auto part = [&](int gi) {
    return ((size_t)b * hq + head(gi)) * n_split + sp;
  };
  if (n <= 0) {
    splitk::empty_partial(ws_ml, g, part);
    return;
  }
  // cache row (b, t, kvh) sits at ((b * S + t) * hkv + kvh)
  const size_t row0 = ((size_t)b * S + k0) * hkv + kvh;
  auto rows = [&](int t, const KV*& kp, const KV*& vp) {
    kp = k + (row0 + (size_t)t * hkv) * d;
    vp = v + (row0 + (size_t)t * hkv) * dv;
  };
  splitk::partial<T, KV>(q + (size_t)b * hq * d, n, split, g, d, dv, scale, rows,
                     head, part, ws_o, ws_ml, smem_raw);
}

// One block per (row b, q-head h), see splitk::merge.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ ws_o,
                    const float* __restrict__ ws_ml, T* __restrict__ out,
                    int hq, int dv, int n_split) {
  extern __shared__ float sW[];  // n_split weights, then n_split sums
  splitk::merge<T, false>(ws_o, ws_ml, out, hq, dv, n_split, sW);
}

template <typename T, typename KV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_lens, void* out, float* ws_o, float* ws_ml,
                   int b, int hq, int hkv, int d, int dv, int S, int split,
                   int kv_len_all, float scale, int g_major,
                   cudaStream_t stream) {
  const int g = hq / hkv;
  const int n_split = (S + split - 1) / split;
  const splitk::Layout lay(split, g, d, dv, (int)sizeof(KV));
  cudaError_t e = hop::launch(
      decode_split_kernel<T, KV>, dim3(n_split, hkv, b), kThreads,
      (size_t)lay.total, stream, static_cast<const T*>(q),
      static_cast<const KV*>(k), static_cast<const KV*>(v), kv_lens,
      kv_len_all, ws_o, ws_ml, hq, hkv, d, dv, S, split, scale, g_major);
  if (e != cudaSuccess) return e;
  return hop::launch(decode_merge_kernel<T>, dim3(hq, b), kMergeThreads,
                     2 * (size_t)n_split * sizeof(float), stream,
                     static_cast<const float*>(ws_o),
                     static_cast<const float*>(ws_ml), static_cast<T*>(out),
                     hq, dv, n_split);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out and the cache), plus 2 where
// the cache is e4m3 (float8_e4m3fn). kv_lens: a (b,) int32 vector, or null
// for one length kv_len_all on every row. ws_o: b * hq * n_split * dv
// floats, ws_ml: b * hq * n_split * 2 floats, n_split = ceil(S / split).
// Sizes are checked by the caller: hq % hkv == 0, d and dv <= 256 and rows
// of whole 16-byte chunks (of the cache's elements), k and v 16-byte
// aligned, b, S, split >= 1.
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
  using bf16 = __nv_bfloat16;
  using fp8 = splitk::fp8;
#define DECODE(T, KV)                                                     \
  launch<T, KV>(q, k, v, kl, out, wo, wml, b, hq, hkv, d, dv, S, split,   \
                kv_len_all, scale, g_major, st)
  cudaError_t e;
  switch (dtype) {
    case 0: e = DECODE(float, float); break;
    case 1: e = DECODE(bf16, bf16); break;
    case 2: e = DECODE(float, fp8); break;
    case 3: e = DECODE(bf16, fp8); break;
    default: e = cudaErrorInvalidValue;
  }
#undef DECODE
  return static_cast<int>(e);
}
