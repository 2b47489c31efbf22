// Paged attention for NVIDIA Hopper (sm_90a): chunked prefill (K1) and
// decode (K2), two entry points over one kernel template.
//
// K1, paged_prefill_attention, replaces the TPU kernel
// repro/kernels/paged_attention/kernel.py::paged_prefill_attention_bcd
// (body _prefill_kernel, grid built in _prefill_call). For q (b, C, hq, d)
// and pooled K/V (nb, blk, hkv, d|dv) reached through page tables
// (b, npages), position i of row b sees key k iff
//     k <= cache_lens[b] + i   and   k < max(cache_lens[b] + valids[b], 1).
//
// K2, paged_decode_attention, replaces repro/kernels/paged_attention/
// kernel.py::paged_attention_bhd (body _kernel): one query per (b, q-head),
// q (b, hq, d), over the same pools; row b sees keys k < lens[b]. That is
// K1 with C = 1 at position lens[b] - 1, read straight from lens, so the
// legacy decode loop needs no valids vector and a row with lens 0 sees no
// key (it writes zeros, as the Pallas kernel does).
//
// Both are the walk of ../../csrc/attention_walk.cuh (the design and what
// bounds it are described there), with one page as the key tile. A block
// owns (row b, kv head, a tile of query rows over chunk positions x the g
// q-heads sharing that kv head). Pages past the tile's last visible
// position are skipped; that changes no bit of the result, because the
// running max is finite after the first visible key.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream
// and returns cudaGetLastError() so a refused launch is reported.

#include "../../csrc/attention_walk.cuh"

namespace {

using attn::kThreads;
using attn::kWarps;

// BLK (the pool's block size) is a template constant so the per-key loops
// unroll without guards and the warp reductions of a page interleave.
// DECODE: lens_a holds lens (one query at lens - 1); otherwise lens_a holds
// cache_lens and valids the rows' real widths.
template <typename T, int BLK, bool DECODE>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
             const T* __restrict__ v_pool, const int* __restrict__ lens_a,
             const int* __restrict__ valids,
             const int* __restrict__ page_tables, T* __restrict__ out,
             int C, int hq, int hkv, int d, int dv, int npages, float scale,
             int g_major) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int g = hq / hkv;
  const int rows = C * g;
  const int tile0 = blockIdx.x * kWarps;
  const int r = tile0 + (threadIdx.x >> 5);
  const int i = r / g;                // chunk position
  const int gi = r - i * g;           // head within the kv group
  const int h = g_major ? gi * hkv + kvh : kvh * g + gi;

  int off, kv_len;
  if (DECODE) {
    kv_len = lens_a[b];
    off = kv_len - 1;
  } else {
    off = lens_a[b];
    kv_len = max(off + valids[b], 1);
  }
  const int last_row = min(tile0 + kWarps, rows) - 1;
  const int kv_hi = min(kv_len, off + last_row / g + 1);
  const int n_pages = min(npages, max(kv_hi + BLK - 1, 0) / BLK);

  const int* pt = page_tables + (size_t)b * npages;
  // pool element (bid, t, kvh, e) sits at ((bid * blk + t) * hkv + kvh) * d
  auto page = [&](int j, const T*& kp, const T*& vp, int& n) {
    const size_t base = (size_t)pt[j] * BLK * hkv + kvh;
    kp = k_pool + base * d;
    vp = v_pool + base * dv;
    n = BLK;
  };
  const size_t row = (size_t)(b * C + i) * hq + h;
  attn::attend<T, BLK>(q + row * d, out + row * dv, r < rows, off + i,
                       kv_len, n_pages, hkv * d, hkv * dv, d, dv, scale,
                       page, reinterpret_cast<T*>(smem_raw));
}

template <typename T, int BLK, bool DECODE>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* lens_a, const int* valids,
                   const int* page_tables, void* out, int b, int C, int hq,
                   int hkv, int d, int dv, int npages, float scale,
                   int g_major, cudaStream_t stream) {
  const int g = hq / hkv;
  const dim3 grid((C * g + kWarps - 1) / kWarps, hkv, b);
  const size_t smem = 2 * (size_t)BLK * (d + dv) * sizeof(T);
  return attn::launch(paged_kernel<T, BLK, DECODE>, grid, smem, stream,
                      static_cast<const T*>(q), static_cast<const T*>(k_pool),
                      static_cast<const T*>(v_pool), lens_a, valids,
                      page_tables, static_cast<T*>(out), C, hq, hkv, d, dv,
                      npages, scale, g_major);
}

template <bool DECODE>
cudaError_t dispatch(int dtype, int blk, const void* q, const void* k_pool,
                     const void* v_pool, const void* lens_a,
                     const void* valids, const void* page_tables, void* out,
                     int b, int C, int hq, int hkv, int d, int dv, int npages,
                     float scale, int g_major, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* la = static_cast<const int*>(lens_a);
  const int* va = static_cast<const int*>(valids);
  const int* pt = static_cast<const int*>(page_tables);
#define PAGED_LAUNCH(T, BLK)                                                 \
  return launch<T, BLK, DECODE>(q, k_pool, v_pool, la, va, pt, out, b, C,    \
                                hq, hkv, d, dv, npages, scale, g_major, st)
  if (dtype == 0 && blk == 8) PAGED_LAUNCH(float, 8);
  if (dtype == 0 && blk == 16) PAGED_LAUNCH(float, 16);
  if (dtype == 1 && blk == 8) PAGED_LAUNCH(__nv_bfloat16, 8);
  if (dtype == 1 && blk == 16) PAGED_LAUNCH(__nv_bfloat16, 16);
#undef PAGED_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Sizes are checked by the caller:
// hq % hkv == 0, d and dv <= 256 and rows of whole 16-byte chunks, pools
// 16-byte aligned, blk in {8, 16}, b, C, npages >= 1, every page table
// entry a valid block id. Each returns a cudaError_t as int (0 = success).
extern "C" int paged_prefill_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* cache_lens, const void* valids, const void* page_tables,
    void* out, int b, int C, int hq, int hkv, int d, int dv, int blk,
    int npages, float scale, int g_major, void* stream) {
  return static_cast<int>(dispatch<false>(
      dtype, blk, q, k_pool, v_pool, cache_lens, valids, page_tables, out, b,
      C, hq, hkv, d, dv, npages, scale, g_major, stream));
}

// q (b, hq, d), out (b, hq, dv), lens (b,) int32 keys visible per row.
extern "C" int paged_decode_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* lens, const void* page_tables, void* out, int b, int hq,
    int hkv, int d, int dv, int blk, int npages, float scale, int g_major,
    void* stream) {
  return static_cast<int>(dispatch<true>(
      dtype, blk, q, k_pool, v_pool, lens, nullptr, page_tables, out, b, 1,
      hq, hkv, d, dv, npages, scale, g_major, stream));
}
