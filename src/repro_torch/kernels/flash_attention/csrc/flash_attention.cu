// Flash attention (forward) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_bhsd (body _kernel): q (b, sq, hq, d) against k
// (b, skv, hkv, d) and v (b, skv, hkv, dv), read in the model's (b, s, h, d)
// layout with no transpose; dv may differ from d. Causal, query i sees keys
// k <= i (positions from 0 on both sides); otherwise every key. Float32
// math from bf16 or f32 inputs, output in q's dtype. Any sq and skv: the
// last key tile is partial and read only as far as skv (the Pallas wrapper
// asserted sq % blk_q == 0 instead).
//
// It is the walk of ../../csrc/attention_walk.cuh (the design and what
// bounds it are described there) with tiles of 16 key rows. A block owns
// (row b, kv head, 8 query rows over positions x the g q-heads of that kv
// head), so each staged tile serves g heads, and stops after the tile
// holding its last position's diagonal when causal. The Pallas kernel
// walked KV tiles as a sequential grid axis with the softmax state in VMEM
// scratch; here that walk is a loop inside the block.
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
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
             int hq, int hkv, int d, int dv, float scale, int causal,
             int g_major) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int g = hq / hkv;
  const int rows = sq * g;
  const int tile0 = blockIdx.x * kWarps;
  const int r = tile0 + (threadIdx.x >> 5);
  const int i = r / g;                // query position
  const int gi = r - i * g;           // head within the kv group
  const int h = g_major ? gi * hkv + kvh : kvh * g + gi;
  const int last_row = min(tile0 + kWarps, rows) - 1;
  const int kv_hi = causal ? min(skv, last_row / g + 1) : skv;
  // element (b, t, kvh, e) sits at ((b * skv + t) * hkv + kvh) * d
  auto tile = [&](int j, const T*& kp, const T*& vp, int& n) {
    const size_t base = ((size_t)b * skv + j * kTile) * hkv + kvh;
    kp = k + base * d;
    vp = v + base * dv;
    n = min(kTile, skv - j * kTile);
  };
  const size_t row = (size_t)(b * sq + i) * hq + h;
  attn::attend<T, kTile>(q + row * d, out + row * dv, r < rows,
                         causal ? i : skv - 1, skv,
                         (kv_hi + kTile - 1) / kTile, hkv * d, hkv * dv, d,
                         dv, scale, tile, reinterpret_cast<T*>(smem_raw));
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int sq, int skv, int hq, int hkv, int d, int dv,
                   float scale, int causal, int g_major,
                   cudaStream_t stream) {
  const int g = hq / hkv;
  const dim3 grid((sq * g + kWarps - 1) / kWarps, hkv, b);
  const size_t smem = 2 * (size_t)kTile * (d + dv) * sizeof(T);
  return attn::launch(flash_kernel<T>, grid, smem, stream,
                      static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), static_cast<T*>(out), sq, skv,
                      hq, hkv, d, dv, scale, causal, g_major);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Sizes are checked by the caller:
// hq % hkv == 0, d and dv <= 256 and rows of whole 16-byte chunks, k and v
// 16-byte aligned, b, sq, skv >= 1. Returns a cudaError_t as int.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int b, int sq,
                               int skv, int hq, int hkv, int d, int dv,
                               float scale, int causal, int g_major,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = launch<float>(q, k, v, out, b, sq, skv, hq, hkv, d, dv, scale,
                      causal, g_major, st);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(q, k, v, out, b, sq, skv, hq, hkv, d, dv,
                              scale, causal, g_major, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
