// Flash attention (forward) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:71
// (flash_attention_bhsd, its pallas_call at :87, body _kernel): q
// (b, sq, hq, d) against k (b, skv, hkv, d) and v (b, skv, hkv, dv), read in
// the model's (b, s, h, d) layout with no transpose; dv may differ from d.
// Causal, query i sees keys k <= i (positions from 0 on both sides);
// otherwise every key. Float32 softmax from bf16 or f32 inputs, output in
// q's dtype, denominator floored at 1e-30. Any sq and skv (the Pallas
// wrapper asserted sq % blk_q == 0 instead).
//
// bf16 (flash_tc_kernel), a FlashAttention-2 forward on the tensor cores.
// What bounds it on an H100 is the bytes of q, K, V and the output against
// 3.35 TB/s; its products are a few GFLOP against 989 TFLOP/s of bf16
// tensor cores, so they must run there, and K/V must be read from device
// memory about once, not once per query row. So:
//   - A block is one warpgroup (4 warps) owning a 64-row M tile of one
//     (row b, kv head): the rows are query positions x the g q-heads of that
//     kv head, so each staged K/V tile serves g heads (gemma-2b: 8 positions
//     x 8 heads; zamba2-7b: 64 positions of one head). Causal blocks stop at
//     the tile holding their last position's diagonal, and the grid hands
//     out the latest (longest) M tiles first.
//   - S = Q.K^T and O += P.V are mma.sync m16n8k16 bf16 products with f32
//     accumulators, fed by ldmatrix (.trans for V) from shared memory whose
//     rows are padded by 16 bytes, so the eight rows of an 8x8 matrix fall
//     on distinct banks. Each warp owns 16 rows; Q stays in registers for
//     the whole walk where the head fits (<= 128 wide) and is re-read from
//     shared memory per tile above that, where registers are short. The
//     online softmax (m, l) and O stay in f32 registers; P is rounded to
//     bf16 in registers as the A operand of P.V, as FlashAttention-2 does.
//   - K/V tiles of 64 keys (32 above a 128-wide head) go in by 16-byte
//     cp.async into a two-stage ring: tile j+1 loads while tile j computes.
//   - Masking is a select to -inf before the max, so a masked score never
//     enters a sum; rows past skv (and past sq for Q) are zero-filled by the
//     copy, and a head width that is not a multiple of 16 has its padding
//     zeroed once, so no stale value reaches a product.
//
// float32 (flash_kernel): the warp-per-row walk of
// ../../csrc/attention_walk.cuh with tiles of 16 keys, exact float32
// products on the CUDA cores (no TF32). It serves the f32 parity checks.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream
// and returns cudaGetLastError() so a refused launch is reported.

#include <algorithm>

#include "../../csrc/attention_walk.cuh"
#include "../../csrc/hopper.cuh"

namespace {

// ------------------------------------------------------------ float32

constexpr int kTile = 16;

template <typename T>
__global__ void __launch_bounds__(attn::kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
             int hq, int hkv, int d, int dv, float scale, int causal,
             int g_major) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int g = hq / hkv;
  const int rows = sq * g;
  const int tile0 = blockIdx.x * attn::kWarps;
  const int r = tile0 + (threadIdx.x >> 5);
  const int i = r / g;                // query position
  const int gi = r - i * g;           // head within the kv group
  const int h = g_major ? gi * hkv + kvh : kvh * g + gi;
  const int last_row = min(tile0 + attn::kWarps, rows) - 1;
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

// --------------------------------------------------------------- bf16

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kM = 64;           // query rows per block, 16 per warp

// Register budget by the widest head dim C (d and dv padded to 16,
// whichever is larger): 64, 128 or 256. The kernel is built for exact
// padded dims DK, DV of the model heads (fixed loop counts), and with
// DK = DV = 0 for any other shape (loops bounded at run time).
template <int C>
struct Tc {
  static constexpr int kN = C > 128 ? 32 : 64;  // keys per tile
  static constexpr int kKSteps = C / 16;        // k16 steps over d at most
  static constexpr int kVTiles = C / 8;         // n8 tiles over dv at most
  static constexpr int kSTiles = kN / 8;        // n8 tiles over a key tile
  static constexpr bool kQRegs = C <= 128;      // Q held in registers
};

template <int C, int DK, int DV>
__global__ void __launch_bounds__(kTcThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int sq,
                int skv, int hq, int hkv, int d, int dv, float scale_log2,
                int causal, int g_major) {
  using Cfg = Tc<C>;
  constexpr int kN = Cfg::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int g = hq / hkv;
  const int rows = sq * g;
  const int tile0 = (gridDim.x - 1 - blockIdx.x) * kM;  // longest first
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

  const int last_row = min(tile0 + kM, rows) - 1;
  const int kv_hi = causal ? min(skv, last_row / g + 1) : skv;
  const int n_tiles = (kv_hi + kN - 1) / kN;

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

  auto head = [&](int gi) { return g_major ? gi * hkv + kvh : kvh * g + gi; };
  // Q rows of the tile (row r: position (tile0 + r) / g), zeros past rows
  const int qc = d >> 3;  // 16-byte chunks per row
  for (int x = tid; x < kM * qc; x += kTcThreads) {
    const int r = x / qc;
    const int c = x - r * qc;
    const int R = tile0 + r;
    const bool ok = R < rows;
    const int i = ok ? R / g : 0;
    const int gi = ok ? R - i * g : 0;
    hop::cp16(sQ + r * qs + c * 8,
              q + (((size_t)b * sq + i) * hq + head(gi)) * d + c * 8, ok);
  }
  // key tile j into stage st, zeros past skv
  auto stage = [&](int j, int st) {
    bf16* dk = sK + st * kN * ks;
    bf16* dvp = sV + st * kN * vs;
    const int kc = d >> 3;
    const int vc = dv >> 3;
    for (int x = tid; x < kN * kc; x += kTcThreads) {
      const int t = x / kc;
      const int c = x - t * kc;
      const int key = j * kN + t;
      const bool ok = key < skv;
      hop::cp16(dk + t * ks + c * 8,
                k + (((size_t)b * skv + (ok ? key : 0)) * hkv + kvh) * d +
                    c * 8,
                ok);
    }
    for (int x = tid; x < kN * vc; x += kTcThreads) {
      const int t = x / vc;
      const int c = x - t * vc;
      const int key = j * kN + t;
      const bool ok = key < skv;
      hop::cp16(dvp + t * vs + c * 8,
                v + (((size_t)b * skv + (ok ? key : 0)) * hkv + kvh) * dv +
                    c * 8,
                ok);
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

  const int nks = d16 >> 4;  // k16 steps of this head
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
  const int qpos0 = causal ? R0 / g : skv;
  const int qpos1 = causal ? (R0 + 8) / g : skv;
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

    // scale to log2 units, mask by select where the tile crosses the
    // diagonal or skv, and take the row maxima
    const int kbase = j * kN;
    const bool edge =
        kbase + kN > skv || (causal && kbase + kN - 1 > tile0 / g);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < Cfg::kSTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge) {
          const int kpos = kbase + nt * 8 + 2 * tq + (e & 1);
          const int qp = e < 2 ? qpos0 : qpos1;
          if (!(kpos < skv && kpos <= qp)) x = -INFINITY;
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

  // normalise, stage O as bf16 over Q's rows, then write whole rows out
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
  bf16* orow = sQ + (warp * 16 + gq) * qs + 2 * tq;
#pragma unroll
  for (int vt = 0; vt < Cfg::kVTiles; ++vt) {
    if (vt < nvt) {
      *reinterpret_cast<uint32_t*>(orow + vt * 8) =
          hop::pack_bf16(o[vt][0] * inv[0], o[vt][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(orow + 8 * qs + vt * 8) =
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
    const int i = R / g;
    const int gi = R - i * g;
    *reinterpret_cast<uint4*>(
        out + (((size_t)b * sq + i) * hq + head(gi)) * dv + c * 8) =
        *reinterpret_cast<const uint4*>(sQ + r * qs + c * 8);
  }
}

template <int C, int DK = 0, int DV = 0>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int b, int sq, int skv, int hq, int hkv, int d, int dv,
                      float scale, int causal, int g_major,
                      cudaStream_t stream) {
  constexpr int kN = Tc<C>::kN;
  const int g = hq / hkv;
  const int d16 = (d + 15) & ~15;
  const int dv16 = (dv + 15) & ~15;
  const size_t smem = ((size_t)kM * (std::max(d16, dv16) + 8) +
                       2 * (size_t)kN * (d16 + 8) +
                       2 * (size_t)kN * (dv16 + 8)) *
                      sizeof(bf16);
  const dim3 grid((sq * g + kM - 1) / kM, hkv, b);
  return hop::launch(flash_tc_kernel<C, DK, DV>, grid, kTcThreads, smem,
                     stream, static_cast<const bf16*>(q),
                     static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<bf16*>(out), sq,
                     skv, hq, hkv, d, dv, scale * 1.4426950408889634f, causal,
                     g_major);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int b, int sq, int skv, int hq, int hkv,
                       int d, int dv, float scale, int causal, int g_major,
                       cudaStream_t stream) {
  const int g = hq / hkv;
  const dim3 grid((sq * g + attn::kWarps - 1) / attn::kWarps, hkv, b);
  const size_t smem = 2 * (size_t)kTile * (d + dv) * sizeof(float);
  return attn::launch(flash_kernel<float>, grid, smem, stream,
                      static_cast<const float*>(q),
                      static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(out),
                      sq, skv, hq, hkv, d, dv, scale, causal, g_major);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Sizes are checked by the caller:
// hq % hkv == 0, d and dv <= 256 and rows of whole 16-byte chunks, q, k, v
// and out 16-byte aligned, b, sq, skv >= 1. Returns a cudaError_t as int.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int b, int sq,
                               int skv, int hq, int hkv, int d, int dv,
                               float scale, int causal, int g_major,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = launch_f32(q, k, v, out, b, sq, skv, hq, hkv, d, dv, scale, causal,
                   g_major, st);
  } else if (dtype == 1) {
    const int d16 = (d + 15) & ~15;
    const int dv16 = (dv + 15) & ~15;
    const int c = std::max(d16, dv16);
    if (d16 == dv16 && d16 == 256) {         // gemma-2b
      e = launch_tc<256, 256, 256>(q, k, v, out, b, sq, skv, hq, hkv, d, dv,
                                   scale, causal, g_major, st);
    } else if (d16 == dv16 && d16 == 128) {  // chatglm3-6b, llama
      e = launch_tc<128, 128, 128>(q, k, v, out, b, sq, skv, hq, hkv, d, dv,
                                   scale, causal, g_major, st);
    } else if (d16 == dv16 && d16 == 112) {  // zamba2-7b
      e = launch_tc<128, 112, 112>(q, k, v, out, b, sq, skv, hq, hkv, d, dv,
                                   scale, causal, g_major, st);
    } else if (d16 == dv16 && d16 == 64) {
      e = launch_tc<64, 64, 64>(q, k, v, out, b, sq, skv, hq, hkv, d, dv,
                                scale, causal, g_major, st);
    } else if (c <= 64) {
      e = launch_tc<64>(q, k, v, out, b, sq, skv, hq, hkv, d, dv, scale,
                        causal, g_major, st);
    } else if (c <= 128) {
      e = launch_tc<128>(q, k, v, out, b, sq, skv, hq, hkv, d, dv, scale,
                         causal, g_major, st);
    } else {
      e = launch_tc<256>(q, k, v, out, b, sq, skv, hq, hkv, d, dv, scale,
                         causal, g_major, st);
    }
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
