// Paged attention for NVIDIA Hopper (sm_90a): chunked prefill (K1) and
// decode (K2).
//
// K1, paged_prefill_attention, replaces the TPU kernel
// src/repro/kernels/paged_attention/kernel.py:180
// (paged_prefill_attention_bcd, body _prefill_kernel, pallas_call at :150).
// For q (b, C, hq, d) and pooled K/V (nb, blk, hkv, d|dv) reached through
// page tables (b, npages), position i of row b sees key k iff
//     k <= cache_lens[b] + i   and   k < max(cache_lens[b] + valids[b], 1).
//
// K2, paged_decode_attention, replaces src/repro/kernels/paged_attention/
// kernel.py:227 (paged_attention_bhd, body _kernel, pallas_call at :241):
// one query per (b, q-head), q (b, 1, hq, d), over the same pools; row b
// sees keys k < lens[b]. A row with lens 0 sees no key and writes zeros,
// as the Pallas kernel does.
//
// What bounds them on an H100 is the bytes of the visible K/V pages,
// against 3.35 TB/s: a few MB at the paths' shapes, a few microseconds.
// Their products are a few GFLOP at most, against 989 TFLOP/s of bf16
// tensor cores. So every SM must be busy, K/V pages must be read about
// once rather than once per query row, and the products must not run as
// per-key warp reductions on the CUDA cores. Three kernels, chosen by shape:
//
//   - C = 1 (K2 always; K1 at C = 1, every decode step of the megastep),
//     split-K over the pages (paged_split_kernel, paged_merge_kernel): the
//     passes of ../../csrc/split_k.cuh, as K4 runs them over a contiguous
//     cache. Pass 1's grid is (n_split, hkv, b): a block owns one range of
//     whole pages for the g q-heads of one kv head, reads the range's page
//     ids once into shared memory, stages the rows below the row's length
//     with 16-byte cp.async, and writes an f32 partial (m, l, o[dv]) per
//     head; a range at or past the length writes m = -inf, l = 0. Pass 2
//     merges the partials in range order, with no atomics. K1 at C = 1 is
//     the same call with length max(cache_lens + valids, 1) (position 0
//     sees k <= cache_lens, and that length never exceeds cache_lens + 1),
//     so with lens = cache_lens + 1 K2 equals K1 bit for bit on every row
//     with valids = 1.
//   - C > 1, bf16 (paged_tc_kernel): K3's FlashAttention-2 tiles
//     (flash_attention.cu) over pool pages. A block is one warpgroup owning
//     a 64-row M tile of one (row b, kv head): chunk positions x the g
//     q-heads of that kv head, so each staged K/V tile serves g heads.
//     S = Q.K^T and O += P.V are mma.sync m16n8k16 bf16 products with f32
//     accumulators fed by ldmatrix; Q stays in registers up to 128-wide
//     heads and is re-read from shared memory above that (gemma-2b's 256:
//     32-key tiles); (m, l, O) in f32 registers, P rounded to bf16 for
//     P.V. A key tile is a whole number of pages (32 keys = 2 pages of 16),
//     its page ids read from shared memory, where the block loaded its
//     range's ids once; tiles go in by 16-byte cp.async into a two-stage
//     ring. Each row masks by select to -inf before its max
//     (kpos <= cache_lens + i, kpos < kv_len); key and value rows at or
//     past the tile's last visible key are zero-filled by the copy, so the
//     stale pool data or the null block 0 there never meets a product
//     (0 x NaN in P.V would poison the row). A block stops at its last
//     position's last visible key. Where b * hkv * ceil(C g / 64) blocks
//     fill less than one wave of the card, each M tile's key range is split
//     into ranges of whole key tiles (``prefill_plan`` in ../ops.py, from
//     the shapes only), each writing f32 partials that pass 2 merges with
//     the M tile's rows as its rows, loading only non-empty partials (most
//     rows leave most ranges empty). A range per block when the tiles fill
//     the card (C = 256: 256 blocks at b 8): the longest tile then walks
//     every key of its row, but splitting it costs more partial traffic
//     than the shorter walk saves (PERF.md §6).
//   - C > 1, float32 (paged_walk_kernel): the warp-per-row walk of
//     ../../csrc/attention_walk.cuh with one page as the key tile, exact
//     float32 on the CUDA cores. It serves the f32 parity runs only.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream
// and returns cudaGetLastError() so a refused launch is reported.

#include <algorithm>

#include "../../csrc/attention_walk.cuh"
#include "../../csrc/hopper.cuh"
#include "../../csrc/split_k.cuh"

namespace {

// ------------------------------------------------- float32, C > 1: walk

// BLK (the pool's block size) is a template constant so the per-key loops
// unroll without guards and the warp reductions of a page interleave. Pages
// past the tile's last visible position are skipped; that changes no bit
// of the result, because the running max is finite after the first
// visible key.
template <typename T, int BLK>
__global__ void __launch_bounds__(attn::kThreads)
paged_walk_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int* __restrict__ cache_lens,
                  const int* __restrict__ valids,
                  const int* __restrict__ page_tables, T* __restrict__ out,
                  int C, int hq, int hkv, int d, int dv, int npages,
                  float scale, int g_major) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int g = hq / hkv;
  const int rows = C * g;
  const int tile0 = blockIdx.x * attn::kWarps;
  const int r = tile0 + (threadIdx.x >> 5);
  const int i = r / g;                // chunk position
  const int gi = r - i * g;           // head within the kv group
  const int h = g_major ? gi * hkv + kvh : kvh * g + gi;

  const int off = cache_lens[b];
  const int kv_len = max(off + valids[b], 1);
  const int last_row = min(tile0 + attn::kWarps, rows) - 1;
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

template <int BLK>
cudaError_t launch_walk(const float* q, const float* k_pool,
                        const float* v_pool, const int* cache_lens,
                        const int* valids, const int* page_tables,
                        float* out, int b, int C, int hq, int hkv, int d,
                        int dv, int npages, float scale, int g_major,
                        cudaStream_t stream) {
  const int g = hq / hkv;
  const dim3 grid((C * g + attn::kWarps - 1) / attn::kWarps, hkv, b);
  const size_t smem = 2 * (size_t)BLK * (d + dv) * sizeof(float);
  return attn::launch(paged_walk_kernel<float, BLK>, grid, smem, stream, q,
                      k_pool, v_pool, cache_lens, valids, page_tables, out,
                      C, hq, hkv, d, dv, npages, scale, g_major);
}

// ----------------------------------------- C = 1: split-K over the pages

// Bytes of pass 1's shared memory: splitk::Layout, then the range's page
// ids (split / blk of them).
int split_smem(int split, int g, int d, int dv, int es, int blk_shift) {
  return splitk::Layout(split, g, d, dv, es).total +
         ((((split >> blk_shift) * 4) + 15) & ~15);
}

// lens: the rows' lengths (K2), or cache_lens when valids is given (K1 at
// C = 1: length max(cache_lens + valids, 1)). split is a multiple of blk.
template <typename T>
__global__ void __launch_bounds__(splitk::kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool, const int* __restrict__ lens,
                   const int* __restrict__ valids,
                   const int* __restrict__ page_tables,
                   float* __restrict__ ws_o, float* __restrict__ ws_ml,
                   int hq, int hkv, int d, int dv, int npages, int blk_shift,
                   int split, float scale, int g_major) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_split = gridDim.x;
  const int g = hq / hkv;
  const int S = npages << blk_shift;
  const int want = valids ? max(lens[b] + valids[b], 1) : lens[b];
  const int len = max(min(want, S), 0);
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
  // the range's page ids, read once (k0 is a multiple of blk)
  int* sPid = reinterpret_cast<int*>(
      smem_raw + splitk::Layout(split, g, d, dv, (int)sizeof(T)).total);
  const int* pt = page_tables + (size_t)b * npages + (k0 >> blk_shift);
  const int n_pg = ((n - 1) >> blk_shift) + 1;
  for (int x = threadIdx.x; x < n_pg; x += splitk::kThreads) sPid[x] = pt[x];
  __syncthreads();
  // pool row (bid, t, kvh) sits at ((bid * blk + t) * hkv + kvh)
  const int blk_mask = (1 << blk_shift) - 1;
  auto rows = [&](int t, const T*& kp, const T*& vp) {
    const size_t row =
        (((size_t)sPid[t >> blk_shift] << blk_shift) | (t & blk_mask)) *
            hkv + kvh;
    kp = k_pool + row * d;
    vp = v_pool + row * dv;
  };
  splitk::partial<T>(q + (size_t)b * hq * d, n, split, g, d, dv, scale, rows,
                     head, part, ws_o, ws_ml, smem_raw);
}

// One block per (row b, output row h of R): merge the n_split partials;
// PREFILL: the tensor-core prefill's (log2 units, sparse loads), else the
// split decode's.
template <typename T, bool PREFILL>
__global__ void __launch_bounds__(splitk::kMergeThreads)
paged_merge_kernel(const float* __restrict__ ws_o,
                   const float* __restrict__ ws_ml, T* __restrict__ out,
                   int R, int dv, int n_split) {
  extern __shared__ float sW[];  // n_split weights, then n_split sums
  splitk::merge<T, PREFILL, PREFILL>(ws_o, ws_ml, out, R, dv, n_split, sW);
}

template <typename T, bool PREFILL>
cudaError_t launch_merge(const float* ws_o, const float* ws_ml, void* out,
                         int b, int R, int dv, int n_split,
                         cudaStream_t stream) {
  return hop::launch(paged_merge_kernel<T, PREFILL>, dim3(R, b),
                     splitk::kMergeThreads,
                     2 * (size_t)n_split * sizeof(float), stream, ws_o,
                     ws_ml, static_cast<T*>(out), R, dv, n_split);
}

template <typename T>
cudaError_t launch_split(const void* q, const void* k_pool,
                         const void* v_pool, const int* lens,
                         const int* valids, const int* page_tables,
                         void* out, float* ws_o, float* ws_ml, int b, int hq,
                         int hkv, int d, int dv, int blk_shift, int npages,
                         int split, float scale, int g_major,
                         cudaStream_t stream) {
  const int g = hq / hkv;
  const int n_split = ((npages << blk_shift) + split - 1) / split;
  cudaError_t e = hop::launch(
      paged_split_kernel<T>, dim3(n_split, hkv, b), splitk::kThreads,
      (size_t)split_smem(split, g, d, dv, (int)sizeof(T), blk_shift), stream,
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), lens, valids, page_tables, ws_o, ws_ml,
      hq, hkv, d, dv, npages, blk_shift, split, scale, g_major);
  if (e != cudaSuccess) return e;
  return launch_merge<T, false>(ws_o, ws_ml, out, b, hq, dv, n_split,
                                stream);
}

// ------------------------------------ bf16, C > 1: tensor-core M tiles

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kM = 64;           // query rows per block, 16 per warp

// Register budget by the widest head dim W (d and dv padded to 16,
// whichever is larger): 64, 128 or 256, as K3's. The kernel is built for
// the exact head dims DK = d = DV = dv = 256 of gemma-2b, the one paged
// shape measured on the card, so loop counts, strides and the copies' chunk
// indices are compile-time constants (the copy loops otherwise spend more
// instructions on run-time division and addresses than the tile's products
// take), and with DK = DV = 0 for any other shape (bounded at run time).
template <int W>
struct Tc {
  static constexpr int kN = W > 128 ? 32 : 64;  // keys per tile
  static constexpr int kKSteps = W / 16;        // k16 steps over d at most
  static constexpr int kVTiles = W / 8;         // n8 tiles over dv at most
  static constexpr int kSTiles = kN / 8;        // n8 tiles over a key tile
  static constexpr bool kQRegs = W <= 128;      // Q held in registers
};

// Grid (n_mt * n_split, hkv, b): M tile (longest first) x key range. With
// n_split = 1 the block writes its rows' outputs; otherwise f32 partials
// (m in log2 units, l, unnormalised o) per (output row, range) for
// paged_merge_kernel<bf16, true>.
template <int W, int DK, int DV>
__global__ void __launch_bounds__(kTcThreads)
paged_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                const bf16* __restrict__ v_pool,
                const int* __restrict__ cache_lens,
                const int* __restrict__ valids,
                const int* __restrict__ page_tables, bf16* __restrict__ out,
                float* __restrict__ ws_o, float* __restrict__ ws_ml, int C,
                int hq, int hkv, int d, int dv, int npages, int blk_shift,
                int split, int n_split, float scale_log2, int g_major) {
  using Cfg = Tc<W>;
  constexpr int kN = Cfg::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (DK) d = DK;  // an exact build: the dims fold into constants
  if (DV) dv = DV;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int g = hq / hkv;
  const int rows = C * g;
  const int n_mt = gridDim.x / n_split;
  const int sp = blockIdx.x % n_split;
  const int tile0 = (n_mt - 1 - blockIdx.x / n_split) * kM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int d16 = DK ? DK : (d + 15) & ~15;
  const int dv16 = DV ? DV : (dv + 15) & ~15;
  const int qs = max(d16, dv16) + 8;  // row strides in elements: +16 bytes
  const int ks = d16 + 8;
  const int vs = dv16 + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // Q, then O
  bf16* sK = sQ + kM * qs;                        // two stages
  bf16* sV = sK + 2 * kN * ks;                    // two stages
  int* sPid = reinterpret_cast<int*>(sV + 2 * kN * vs);

  auto head = [&](int gi) { return g_major ? gi * hkv + kvh : kvh * g + gi; };
  // output row of tile row R: (b, position R / g, head R % g of the group)
  auto orow = [&](int R) {
    const int i = R / g;
    return ((size_t)b * C + i) * hq + head(R - i * g);
  };
  const int off = cache_lens[b];
  const int kv_len = max(off + valids[b], 1);
  const int last_row = min(tile0 + kM, rows) - 1;
  // keys some row of the tile sees: below kv_len (and the table's end),
  // at most its last position; then this block's range of them
  const int kv_hi = min(min(kv_len, npages << blk_shift),
                        off + last_row / g + 1);
  const int k_lo = sp * split;
  const int k_hi = min(k_lo + split, kv_hi);
  if (k_hi <= k_lo) {  // a range past every key the tile sees
    for (int r = tid; r < kM; r += kTcThreads) {
      if (tile0 + r >= rows) break;
      float* ml = ws_ml + 2 * (orow(tile0 + r) * n_split + sp);
      ml[0] = -INFINITY;
      ml[1] = 0.f;
    }
    return;
  }
  const int n_tiles = (k_hi - k_lo + kN - 1) / kN;

  // zero the 16-byte chunk that pads a row to a multiple of 16 elements
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (d & 15) {
    for (int r = tid; r < kM + 2 * kN; r += kTcThreads) {
      bf16* row = r < kM ? sQ + r * qs : sK + (r - kM) * ks;
      *reinterpret_cast<uint4*>(row + d) = zero;
    }
  }
  if (dv & 15) {
    for (int r = tid; r < 2 * kN; r += kTcThreads)
      *reinterpret_cast<uint4*>(sV + r * vs + dv) = zero;
  }

  // Q rows of the tile (row r: position (tile0 + r) / g), zeros past rows
  const int qc = d >> 3;  // 16-byte chunks per row
  for (int x = tid; x < kM * qc; x += kTcThreads) {
    const int r = x / qc;
    const int c = x - r * qc;
    const int R = tile0 + r;
    const bool ok = R < rows;
    hop::cp16(sQ + r * qs + c * 8, q + (ok ? orow(R) : 0) * d + c * 8, ok);
  }
  // the page ids of the range's keys below k_hi, read once
  const int p0 = k_lo >> blk_shift;
  const int n_pg = ((k_hi - 1) >> blk_shift) - p0 + 1;
  const int* pt = page_tables + (size_t)b * npages + p0;
  for (int x = tid; x < n_pg; x += kTcThreads) sPid[x] = pt[x];
  __syncthreads();

  // key tile j of the range into stage st: pool row of key ``key`` is
  // ((page id << blk_shift | key % blk) * hkv + kvh); zeros at k_hi and
  // past it (never read: src is then the pool's first row)
  const int blk_mask = (1 << blk_shift) - 1;
  auto pool_row = [&](int key) {
    return (((size_t)sPid[(key >> blk_shift) - p0] << blk_shift) |
            (key & blk_mask)) * hkv + kvh;
  };
  auto stage = [&](int j, int st) {
    bf16* dk = sK + st * kN * ks;
    bf16* dvp = sV + st * kN * vs;
    const int kb = k_lo + j * kN;
    const int kc = d >> 3;
    const int vc = dv >> 3;
    for (int x = tid; x < kN * kc; x += kTcThreads) {
      const int t = x / kc;
      const int c = x - t * kc;
      const bool ok = kb + t < k_hi;
      hop::cp16(dk + t * ks + c * 8,
                k_pool + (ok ? pool_row(kb + t) * d : 0) + c * 8, ok);
    }
    for (int x = tid; x < kN * vc; x += kTcThreads) {
      const int t = x / vc;
      const int c = x - t * vc;
      const bool ok = kb + t < k_hi;
      hop::cp16(dvp + t * vs + c * 8,
                v_pool + (ok ? pool_row(kb + t) * dv : 0) + c * 8, ok);
    }
  };
  stage(0, 0);
  hop::cp_commit();  // group 0: Q and tile 0
  if (n_tiles > 1) {
    stage(1, 1);
    hop::cp_commit();
    hop::cp_wait<1>();
  } else {
    hop::cp_wait<0>();
  }
  __syncthreads();

  const int nks = d16 >> 4;   // k16 steps of this head
  const int nvt = dv16 >> 3;  // n8 tiles of the output
  // A-operand address of this lane in a 16x16 tile: rows lane & 15, the
  // upper 8 columns for lanes 16-31
  const bf16* qa = sQ + (warp * 16 + (lane & 15)) * qs + ((lane >> 4) << 3);
  uint32_t qf[Cfg::kQRegs ? Cfg::kKSteps : 1][4];
  if constexpr (Cfg::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < Cfg::kKSteps; ++kk)
      if (kk < nks) hop::ldsm4(qf[kk], qa + kk * 16);
  }

  float o[Cfg::kVTiles][4];
#pragma unroll
  for (int vt = 0; vt < Cfg::kVTiles; ++vt)
    o[vt][0] = o[vt][1] = o[vt][2] = o[vt][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l_r[2] = {0.f, 0.f};              // this lane's part of the sum
  const int gq = lane >> 2;               // rows gq and gq + 8 of the warp
  const int tq = lane & 3;                // columns 2 tq, 2 tq + 1 of an n8
  const int R0 = tile0 + warp * 16 + gq;
  const int qpos0 = off + R0 / g;
  const int qpos1 = off + (R0 + 8) / g;
  const int qpos_min = off + tile0 / g;   // the tile's first position
  // B-operand addresses: K rows (keys) for S, V rows (keys) for P.V
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * ks +
                    (((lane >> 3) & 1) << 3);
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * vs +
                    ((lane >> 4) << 3);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    const bf16* tK = sK + st * kN * ks;
    const bf16* tV = sV + st * kN * vs;
    float s[Cfg::kSTiles][4];
#pragma unroll
    for (int nt = 0; nt < Cfg::kSTiles; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Cfg::kKSteps; ++kk) {
      if (kk < nks) {
        uint32_t a[4];
        if constexpr (Cfg::kQRegs) {
          a[0] = qf[kk][0];
          a[1] = qf[kk][1];
          a[2] = qf[kk][2];
          a[3] = qf[kk][3];
        } else {
          hop::ldsm4(a, qa + kk * 16);
        }
#pragma unroll
        for (int nt = 0; nt < Cfg::kSTiles; nt += 2) {
          uint32_t bk[4];
          hop::ldsm4(bk, tK + nt * 8 * ks + k_off + kk * 16);
          hop::mma_bf16(s[nt], a, bk[0], bk[1]);
          hop::mma_bf16(s[nt + 1], a, bk[2], bk[3]);
        }
      }
    }

    // scale to log2 units, mask by select where the tile reaches past the
    // first position or k_hi (kpos <= qpos and kpos < kv_len: every key at
    // or past k_hi is past kv_len or past every row's position), and take
    // the row maxima
    const int kbase = k_lo + j * kN;
    const bool edge = kbase + kN > k_hi || kbase + kN - 1 > qpos_min;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < Cfg::kSTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge) {
          const int kpos = kbase + nt * 8 + 2 * tq + (e & 1);
          const int qp = e < 2 ? qpos0 : qpos1;
          if (!(kpos < k_hi && kpos <= qp)) x = -INFINITY;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row seeing nothing
      const float corr = exp2f(m_r[r] - base[r]);
      m_r[r] = mx[r];
      l_r[r] *= corr;
#pragma unroll
      for (int vt = 0; vt < Cfg::kVTiles; ++vt) {
        o[vt][2 * r] *= corr;
        o[vt][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < Cfg::kSTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - base[e >> 1]);
        l_r[e >> 1] += s[nt][e];
      }
    }

    // O += P.V: the S accumulators of two n8 key tiles are the A operand
    // of one k16 step, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const float(&s0)[4] = s[2 * kk];
      const float(&s1)[4] = s[2 * kk + 1];
      const uint32_t a[4] = {
          hop::pack_bf16(s0[0], s0[1]), hop::pack_bf16(s0[2], s0[3]),
          hop::pack_bf16(s1[0], s1[1]), hop::pack_bf16(s1[2], s1[3])};
#pragma unroll
      for (int vt = 0; vt < Cfg::kVTiles; vt += 2) {
        if (vt < nvt) {
          uint32_t bv[4];
          hop::ldsm4_t(bv, tV + kk * 16 * vs + v_off + vt * 8);
          hop::mma_bf16(o[vt], a, bv[0], bv[1]);
          hop::mma_bf16(o[vt + 1], a, bv[2], bv[3]);
        }
      }
    }

    __syncthreads();  // every warp is done with stage st
    if (j + 2 < n_tiles) {
      stage(j + 2, st);
      hop::cp_commit();
    }
    if (j + 1 < n_tiles) {
      if (j + 2 < n_tiles) {
        hop::cp_wait<1>();
      } else {
        hop::cp_wait<0>();
      }
      __syncthreads();
    }
  }

  float l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[r] = l;
  }
  if (n_split > 1) {
    // this range's partial per row: (m, l) and o, unnormalised, in f32
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int R = R0 + 8 * r;
      if (R >= rows) continue;
      const size_t p = orow(R) * n_split + sp;
      if (tq == 0) {
        ws_ml[2 * p] = m_r[r];
        ws_ml[2 * p + 1] = l_row[r];
      }
      float* po = ws_o + p * dv + 2 * tq;
#pragma unroll
      for (int vt = 0; vt < Cfg::kVTiles; ++vt) {
        if (vt < nvt && vt * 8 < dv)
          *reinterpret_cast<float2*>(po + vt * 8) =
              make_float2(o[vt][2 * r], o[vt][2 * r + 1]);
      }
    }
    return;
  }

  // one range: normalise, stage O as bf16 over Q's rows, then write whole
  // rows out
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(l_row[r], 1e-30f);
  bf16* srow = sQ + (warp * 16 + gq) * qs + 2 * tq;
#pragma unroll
  for (int vt = 0; vt < Cfg::kVTiles; ++vt) {
    if (vt < nvt) {
      *reinterpret_cast<uint32_t*>(srow + vt * 8) =
          hop::pack_bf16(o[vt][0] * inv[0], o[vt][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(srow + 8 * qs + vt * 8) =
          hop::pack_bf16(o[vt][2] * inv[1], o[vt][3] * inv[1]);
    }
  }
  __syncthreads();
  const int oc = dv >> 3;
  for (int x = tid; x < kM * oc; x += kTcThreads) {
    const int r = x / oc;
    const int c = x - r * oc;
    const int R = tile0 + r;
    if (R >= rows) continue;
    *reinterpret_cast<uint4*>(out + orow(R) * dv + c * 8) =
        *reinterpret_cast<const uint4*>(sQ + r * qs + c * 8);
  }
}

template <int W, int DK = 0, int DV = 0>
cudaError_t launch_tc(const void* q, const void* k_pool, const void* v_pool,
                      const int* cache_lens, const int* valids,
                      const int* page_tables, void* out, float* ws_o,
                      float* ws_ml, int b, int C, int hq, int hkv, int d,
                      int dv, int blk_shift, int npages, int split,
                      float scale, int g_major, cudaStream_t stream) {
  constexpr int kN = Tc<W>::kN;
  const int g = hq / hkv;
  const int d16 = (d + 15) & ~15;
  const int dv16 = (dv + 15) & ~15;
  const int n_mt = (C * g + kM - 1) / kM;
  const int n_split = ((npages << blk_shift) + split - 1) / split;
  const int pages = (split + (1 << blk_shift) - 1) >> blk_shift;
  const size_t smem = ((size_t)kM * (std::max(d16, dv16) + 8) +
                       2 * (size_t)kN * (d16 + 8) +
                       2 * (size_t)kN * (dv16 + 8)) *
                          sizeof(bf16) +
                      (size_t)pages * sizeof(int);
  cudaError_t e = hop::launch(
      paged_tc_kernel<W, DK, DV>, dim3(n_mt * n_split, hkv, b), kTcThreads,
      smem, stream, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k_pool), static_cast<const bf16*>(v_pool),
      cache_lens, valids, page_tables, static_cast<bf16*>(out), ws_o, ws_ml,
      C, hq, hkv, d, dv, npages, blk_shift, split, n_split,
      scale * 1.4426950408889634f, g_major);
  if (e != cudaSuccess || n_split == 1) return e;
  return launch_merge<bf16, true>(ws_o, ws_ml, out, b, C * hq, dv, n_split,
                                  stream);
}

cudaError_t dispatch_tc(const void* q, const void* k_pool,
                        const void* v_pool, const int* cache_lens,
                        const int* valids, const int* page_tables, void* out,
                        float* ws_o, float* ws_ml, int b, int C, int hq,
                        int hkv, int d, int dv, int blk_shift, int npages,
                        int split, float scale, int g_major,
                        cudaStream_t st) {
  const int d16 = (d + 15) & ~15;
  const int dv16 = (dv + 15) & ~15;
  const int w = std::max(d16, dv16);
#define PAGED_TC(...)                                                        \
  return launch_tc<__VA_ARGS__>(q, k_pool, v_pool, cache_lens, valids,       \
                                page_tables, out, ws_o, ws_ml, b, C, hq, hkv, \
                                d, dv, blk_shift, npages, split, scale,       \
                                g_major, st)
  if (d == dv && d == 256) PAGED_TC(256, 256, 256);  // gemma-2b
  if (w <= 64) PAGED_TC(64);
  if (w <= 128) PAGED_TC(128);
  PAGED_TC(256);
#undef PAGED_TC
}

int log2_blk(int blk) { return blk == 8 ? 3 : blk == 16 ? 4 : -1; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Sizes are checked by the caller:
// hq % hkv == 0, d and dv <= 256 and rows of whole 16-byte chunks, pools
// and q 16-byte aligned, blk in {8, 16}, b, npages >= 1, C >= 2, every
// page table entry a valid block id. bf16 (tensor cores): split is a
// multiple of the key tile (32 keys above 128-wide heads, else 64) or
// npages * blk; ws_o: b * C * hq * n_split * dv floats and ws_ml
// b * C * hq * n_split * 2, n_split = ceil(npages * blk / split), unused
// (may be null) when n_split = 1. float32 (the walk): split and ws unused.
// Returns a cudaError_t as int (0 = success).
extern "C" int paged_prefill_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* cache_lens, const void* valids, const void* page_tables,
    void* out, void* ws_o, void* ws_ml, int b, int C, int hq, int hkv, int d,
    int dv, int blk, int npages, int split, float scale, int g_major,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cl = static_cast<const int*>(cache_lens);
  const int* va = static_cast<const int*>(valids);
  const int* pt = static_cast<const int*>(page_tables);
  const int blk_shift = log2_blk(blk);
  cudaError_t e = cudaErrorInvalidValue;
  if (blk_shift < 0 || C < 2) return static_cast<int>(e);
  if (dtype == 0) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k_pool);
    const float* vf = static_cast<const float*>(v_pool);
    float* of = static_cast<float*>(out);
    e = blk == 8 ? launch_walk<8>(qf, kf, vf, cl, va, pt, of, b, C, hq, hkv,
                                  d, dv, npages, scale, g_major, st)
                 : launch_walk<16>(qf, kf, vf, cl, va, pt, of, b, C, hq,
                                   hkv, d, dv, npages, scale, g_major, st);
  } else if (dtype == 1) {
    e = dispatch_tc(q, k_pool, v_pool, cl, va, pt, out,
                    static_cast<float*>(ws_o), static_cast<float*>(ws_ml), b,
                    C, hq, hkv, d, dv, blk_shift, npages, split, scale,
                    g_major, st);
  }
  return static_cast<int>(e);
}

// q (b, 1, hq, d), out (b, 1, hq, dv). lens (b,) int32: the rows' lengths
// (K2), or cache_lens when valids is not null (K1 at C = 1: length
// max(cache_lens + valids, 1)). split is a multiple of blk; ws_o:
// b * hq * n_split * dv floats, ws_ml: b * hq * n_split * 2 floats,
// n_split = ceil(npages * blk / split). Other sizes as above.
extern "C" int paged_decode_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* lens, const void* valids, const void* page_tables, void* out,
    void* ws_o, void* ws_ml, int b, int hq, int hkv, int d, int dv, int blk,
    int npages, int split, float scale, int g_major, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  const int* va = static_cast<const int*>(valids);
  const int* pt = static_cast<const int*>(page_tables);
  float* wo = static_cast<float*>(ws_o);
  float* wml = static_cast<float*>(ws_ml);
  const int blk_shift = log2_blk(blk);
  cudaError_t e = cudaErrorInvalidValue;
  if (blk_shift < 0 || split % blk) return static_cast<int>(e);
  if (dtype == 0) {
    e = launch_split<float>(q, k_pool, v_pool, ln, va, pt, out, wo, wml, b,
                            hq, hkv, d, dv, blk_shift, npages, split, scale,
                            g_major, st);
  } else if (dtype == 1) {
    e = launch_split<bf16>(q, k_pool, v_pool, ln, va, pt, out, wo, wml, b,
                           hq, hkv, d, dv, blk_shift, npages, split, scale,
                           g_major, st);
  }
  return static_cast<int>(e);
}
