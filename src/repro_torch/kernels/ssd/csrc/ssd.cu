// Mamba-2 SSD chunked scan for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py::ssd_bhsd (body
// _kernel), and computes what repro/models/ssd.py::ssd_chunked computes, the
// form every Mamba-2 layer of the reference runs. For one (batch row b,
// head h) and each chunk of L positions, with cum the inclusive prefix sum
// of dt * A over the chunk:
//
//   intra:  y_diag = round(M) @ x,  M[l, m] = (C_l . B_m) exp(cum_l - cum_m)
//                                             dt_m   for l >= m, else 0
//   inter:  y_off  = exp(cum_l) (C_l @ S)
//   out:    y      = round(round(y_diag) + y_off)
//   carry:  S      = exp(cum_L) S + B^T (w x),  w = round(exp(cum_L - cum) dt)
//
// where round() is a rounding to x's dtype: the points at which ssd_chunked
// rounds (the Pallas body is all float32 and does not). Everything else is
// float32. S starts from the optional initial state (zeros for a null
// pointer; the Pallas kernel has none) and the final S is written out.
//
// Layout: the model's own, read in place. x (b, s, h, p), B and C
// (b, s, g, n) with any batch and sequence strides (they arrive as slices of
// one conv output) and their last two dims contiguous; dt (b, s, h) float32
// contiguous; A (h,) float32. y (b, s, h, p) contiguous in x's dtype; the
// state (b, g, h/g, n, p) float32, which is (b, h, n, p). Head h reads B/C
// group h / (h/g), as both reference forms do.
//
// bf16: two kernels on the tensor cores. What bounds the scan on an H100
// is its bytes (x, B, C, y once each: 0.0067 ms at mamba2-370m's b 4,
// s 512); its products are a few GFLOP, so they run as mma.sync m16n8k16
// bf16 products with f32 accumulators, cut so the grid fills the card:
//
//   1. ssd_chunk_kernel, two kinds of block in one launch:
//      - the state walk, per (row, head, 32-column slice of the state):
//        walks the chunks in order; per chunk, cum by a warp scan (written
//        to scratch), w, h_prev of the chunk (the state so far) written as
//        three bf16 pieces (hi, mid, lo: 24 bits, exact), then state =
//        state exp(cum_L) + B^T (w x), the state held in the mma
//        accumulators. B and x come in 64-row tiles by 16-byte cp.async
//        through a two-stage ring that runs on across chunk boundaries.
//        w x of two bf16 values is exact in f32 (16 bits); it is split into
//        hi = bf16(w x) and lo = bf16(w x - hi), both exact, so two
//        products give the plain version's f32 triple products exactly.
//        B^T comes by ldmatrix.trans, w x is formed on the B fragments in
//        registers. The last state is the final state.
//      - C.B^T per (row, chunk, group, 64 x 64 tile at or below the
//        diagonal), once for all the group's heads, into f32 scratch.
//   2. ssd_out_kernel, per (row, chunk, 64-row query tile, head), the
//      longest tiles first, 4 warps of 16 rows: M from the f32 C.B^T
//      fragments (masked entries selected to 0 before any product: the
//      exp of a masked difference may be inf; the n8 tiles and k16 steps
//      past a warp's last row on the diagonal tile skipped), rounded to
//      bf16 as the A operand of M @ x (as K3 repacks P); y_diag rounded;
//      then C @ h_prev over its three pieces, staged through two slots of
//      32 rows of n where the x tiles were (skipped where h_prev is 0: the
//      first chunk without an initial state), and y written. Rows past a
//      ragged L are zero-filled by the copies and written nowhere.
//   No atomics: two calls give equal bits.
//
// float32 (ssd_f32_kernel): one block per (row, head) walks its chunks in
// order on the CUDA cores in full f32 (no TF32); the state lives in shared
// memory (n x p float32). A full (L, L) score tile is over the 227 KB a
// block may use, so the intra-chunk product is tiled: 64-row query tiles of
// C, and for each the 64-row key tiles of B and x at or below it. It
// serves the f32 parity checks.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream
// and returns cudaGetLastError() so a refused launch is reported.

#include "../../csrc/hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;        // rows of a query or key tile
constexpr int kMs = kT + 1;   // padded row stride of the M tile
constexpr unsigned kFull = 0xffffffffu;

// v rounded to bf16 and widened again (round to nearest even)
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ------------------------------------------------------------- float32

// Rows [0, rows) of a tile of kT rows, each of `cols` elements, row_stride
// apart in global memory, into shared memory rows dst_stride apart; rows
// [rows, kT) are zero-filled.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int rows,
                                          int cols, int dst_stride) {
  for (int i = threadIdx.x; i < kT * cols; i += kThreads) {
    const int r = i / cols;
    const int c = i - r * cols;
    dst[r * dst_stride + c] = r < rows ? src[r * row_stride + c] : 0.f;
  }
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* init;  // may be null: the scan starts from zeros
  void* y;
  float* state;
  int s, h, p, g, n, L;
  long long x_sb, x_st, b_sb, b_st, c_sb, c_st;  // element strides
};

// PC = p / 16 output columns per thread.
template <int PC>
__global__ void __launch_bounds__(kThreads) ssd_f32_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const int n = a.n, L = a.L, h = a.h;
  constexpr int p = PC * 16;
  const int gi = hi / (h / a.g);
  const int ns = n + 1;  // padded row stride of the C and B tiles
  float* S = sm;                    // n x p, the carried state
  float* Cq = S + n * p;            // kT x ns, query tile of C
  float* Bk = Cq + kT * ns;         // kT x ns, key tile of B
  float* xk = Bk + kT * ns;         // kT x p, key tile of x
  float* M = xk + kT * p;           // kT x kMs
  float* dts = M + kT * kMs;        // L: dt over the chunk
  float* cum = dts + L;             // L: inclusive prefix sum of dt * A
  float* w = cum + L;               // L: exp(cum_L - cum) * dt

  const int tid = threadIdx.x;
  const int ti = tid >> 4;
  const int tj = tid & 15;
  const float A = a.A[hi];
  const float* xb = static_cast<const float*>(a.x) + bi * a.x_sb + hi * p;
  const float* Bb = static_cast<const float*>(a.B) + bi * a.b_sb + gi * n;
  const float* Cb = static_cast<const float*>(a.C) + bi * a.c_sb + gi * n;
  const float* dtb = a.dt + (size_t)bi * a.s * h + hi;
  float* yb = static_cast<float*>(a.y) + (size_t)bi * a.s * h * p + hi * p;
  const size_t st_off = ((size_t)bi * h + hi) * n * p;

  for (int i = tid; i < n * p; i += kThreads)
    S[i] = a.init ? a.init[st_off + i] : 0.f;

  const int ntile = (L + kT - 1) / kT;
  for (int c0 = 0; c0 < a.s; c0 += L) {
    __syncthreads();  // the previous chunk is done with dts, cum, w and S
    for (int l = tid; l < L; l += kThreads)
      dts[l] = dtb[(size_t)(c0 + l) * h];
    __syncthreads();
    if (tid < 32) {  // one warp scans dt * A, 32 positions at a time
      float carry = 0.f;
      for (int base = 0; base < L; base += 32) {
        const int l = base + tid;
        float v = l < L ? dts[l] * A : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(kFull, v, o);
          if (tid >= o) v += u;
        }
        v += carry;
        if (l < L) cum[l] = v;
        carry = __shfl_sync(kFull, v, 31);
      }
    }
    __syncthreads();
    const float cum_last = cum[L - 1];
    for (int l = tid; l < L; l += kThreads)
      w[l] = expf(cum_last - cum[l]) * dts[l];
    const float chunk_decay = expf(cum_last);

    for (int qt = 0; qt < ntile; ++qt) {
      const int l0 = qt * kT;
      const bool last = qt == ntile - 1;
      __syncthreads();  // the previous query tile is done with Cq
      load_tile(Cq, Cb + (long long)(c0 + l0) * a.c_st, a.c_st,
                   min(kT, L - l0), n, ns);
      __syncthreads();

      // inter-chunk: y_off = C_l @ S (scaled by exp(cum_l) at the end)
      float yd[4][PC], yo[4][PC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < PC; ++c) yd[r][c] = yo[r][c] = 0.f;
      }
      for (int k = 0; k < n; ++k) {
        float cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cq[(ti + 16 * r) * ns + k];
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const float sv = S[k * p + tj + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) yo[r][c] += cv[r] * sv;
        }
      }
      if (last) {
        __syncthreads();  // every thread has read the old state
        // S <- exp(cum_L) S, over the entries this thread carries below
        for (int k = ti; k < n; k += 16) {
#pragma unroll
          for (int c = 0; c < PC; ++c) S[k * p + tj + 16 * c] *= chunk_decay;
        }
      }

      for (int kt = 0; kt <= qt; ++kt) {
        const int m0 = kt * kT;
        const int mrows = min(kT, L - m0);
        __syncthreads();  // the previous key tile is done with Bk, xk, M
        load_tile(Bk, Bb + (long long)(c0 + m0) * a.b_st, a.b_st, mrows,
                     n, ns);
        load_tile(xk, xb + (long long)(c0 + m0) * a.x_st, a.x_st, mrows,
                     p, p);
        __syncthreads();

        // M = round((C.B^T) * decay * dt) where l >= m, 0 elsewhere
        float cb[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) cb[r][c] = 0.f;
        }
        for (int k = 0; k < n; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            cv[r] = Cq[(ti + 16 * r) * ns + k];
            bv[r] = Bk[(tj + 16 * r) * ns + k];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int c = 0; c < 4; ++c) cb[r][c] += cv[r] * bv[c];
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ti + 16 * r;
          const int l = l0 + i;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = tj + 16 * c;
            const int m = m0 + j;
            float v = 0.f;
            if (l >= m && l < L && j < mrows)
              v = cb[r][c] * expf(cum[l] - cum[m]) * dts[m];
            M[i * kMs + j] = v;
          }
        }
        __syncthreads();

        // y_diag += M @ x
        for (int j = 0; j < mrows; ++j) {
          float mv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) mv[r] = M[(ti + 16 * r) * kMs + j];
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            const float xv = xk[j * p + tj + 16 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r) yd[r][c] += mv[r] * xv;
          }
        }

        if (last) {
          // S += B^T (w x) over this key tile, four state rows at a time
          for (int k0 = ti; k0 < n; k0 += 64) {
            float up[4][PC];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
#pragma unroll
              for (int c = 0; c < PC; ++c) up[q][c] = 0.f;
            }
            for (int j = 0; j < mrows; ++j) {
              const float wj = w[m0 + j];
              float bv[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int k = k0 + 16 * q;
                bv[q] = k < n ? Bk[j * ns + k] : 0.f;
              }
#pragma unroll
              for (int c = 0; c < PC; ++c) {
                const float xw = wj * xk[j * p + tj + 16 * c];
#pragma unroll
                for (int q = 0; q < 4; ++q) up[q][c] += bv[q] * xw;
              }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int k = k0 + 16 * q;
              if (k < n) {
#pragma unroll
                for (int c = 0; c < PC; ++c) S[k * p + tj + 16 * c] += up[q][c];
              }
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = l0 + ti + 16 * r;
        if (l < L) {
          const float ec = expf(cum[l]);
#pragma unroll
          for (int c = 0; c < PC; ++c)
            yb[(size_t)(c0 + l) * h * p + tj + 16 * c] =
                yd[r][c] + yo[r][c] * ec;
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n * p; i += kThreads) a.state[st_off + i] = S[i];
}

size_t f32_smem_bytes(int n, int p, int L) {
  return sizeof(float) * ((size_t)n * p + 2 * (size_t)kT * (n + 1) +
                          (size_t)kT * p + (size_t)kT * kMs + 3 * (size_t)L);
}

// ---------------------------------------------------------------- bf16

using bf16 = __nv_bfloat16;

constexpr int kChunkThreads = 256;  // the chunk kernel: 8 warps
constexpr int kOutThreads = 128;    // the out kernel: 4 warps, 16 rows each
constexpr int kStateStages = 3;     // ring depth of a state walk's tiles
constexpr int kSRows = 32;          // rows of n per h_prev stage
constexpr int kPad = 8;             // elements padding a shared row (16 B)

// Wait until at most n of this thread's copy groups are pending; above 4,
// until at most 4 are.
__device__ __forceinline__ void cp_wait_upto(int n) {
  switch (n) {
    case 0: hop::cp_wait<0>(); break;
    case 1: hop::cp_wait<1>(); break;
    case 2: hop::cp_wait<2>(); break;
    case 3: hop::cp_wait<3>(); break;
    default: hop::cp_wait<4>(); break;
  }
}

struct TcArgs {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* B;
  const bf16* C;
  const float* init;  // may be null
  bf16* y;
  float* state;
  float* cum;    // scratch (b, h, s): cum of each position in its chunk
  float* cb;     // scratch (b, nc, g, Lt, Lt): C.B^T, Lt = nt * 64
  bf16* hprev;   // scratch (3, b, nc, h, n, p): pieces of h_prev
  int b, s, h, p, g, n, L, nc, nt;
  long long x_sb, x_st, b_sb, b_st, c_sb, c_st;  // element strides
};

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// Rows [0, kT) of a bf16 matrix whose row r starts at src + r * stride,
// `cols` wide (a multiple of 8), into shared rows ds apart by 16-byte
// cp.async; rows at or past `rows` are zero-filled.
__device__ __forceinline__ void stage(bf16* dst, int ds, const bf16* src,
                                      long long stride, int rows, int cols) {
  const int cc = cols >> 3;
  for (int i = threadIdx.x; i < kT * cc; i += blockDim.x) {
    const int r = i / cc;
    const int c = i - r * cc;
    const bool ok = r < rows;
    hop::cp16(dst + r * ds + c * 8, src + (ok ? r : 0) * stride + c * 8, ok);
  }
}

// The block's inclusive scan of v[0, L) * A into cum (shared), in the
// order ref.scan_cum follows: each warp scans steps of 32 positions
// (Hillis-Steele), then every step adds the total of the steps before it,
// summed one step after another; tot holds each step's own total. Called
// by every thread; ends synchronised.
__device__ void block_scan(const float* v, float A, float* cum, float* tot,
                           int L) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5, steps = (L + 31) / 32;
  for (int i = warp; i < steps; i += warps) {
    const int l = i * 32 + lane;
    float u = l < L ? v[l] * A : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(kFull, u, o);
      if (lane >= o) u += t;
    }
    if (l < L) cum[l] = u;
    if (lane == 31) tot[i] = u;
  }
  __syncthreads();
  for (int i = warp; i < steps; i += warps) {
    float carry = 0.f;
    for (int j = 0; j < i; ++j) carry = tot[j] + carry;
    const int l = i * 32 + lane;
    if (l < L) cum[l] += carry;
  }
  __syncthreads();
}

// The 8 warps of the state product (n x PC outputs of one column slice):
// kCG column groups of kCPW 16-wide column pairs, kRS row groups of at
// most kMT m16 tiles of n (n <= 128).
template <int PC>
struct StateTiles {
  static constexpr int kCP = PC / 16;
  static constexpr int kCG = kCP < 4 ? kCP : 4;
  static constexpr int kCPW = kCP / kCG;
  static constexpr int kRS = 8 / kCG;
  static constexpr int kMT = 8 / kRS;
};

// Columns of a head's state one block carries: two blocks a head at
// p = 64, so the grid fills the card at one batch row.
template <int P>
struct StateSlice {
  static constexpr int kPC = P < 32 ? P : 32;
  static constexpr int kSlices = P / kPC;
};

// The state role, per (row, head, column slice): walks the chunks in
// order. For chunk c: cum by a warp scan (written to scratch), w, then
// h_prev = the state so far, written as three bf16 pieces for the out
// kernel (skipped for the first chunk without an initial state), then
// state = state exp(cum_L) + B^T (w x) over the chunk's 64-row tiles,
// streamed by cp.async through a two-stage ring that runs on across chunk
// boundaries. The state lives in the mma accumulators; the last one is the
// final state.
template <int P>
__device__ void chunk_state(const TcArgs& a, int idx, unsigned char* smem) {
  constexpr int PC = StateSlice<P>::kPC;
  using T = StateTiles<PC>;
  const int ps = idx % StateSlice<P>::kSlices;
  const int hi = (idx / StateSlice<P>::kSlices) % a.h;
  const int bi = idx / (StateSlice<P>::kSlices * a.h);
  const int n = a.n, L = a.L, nt = a.nt, Lt = nt * kT;
  const int gi = hi / (a.h / a.g);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bs = n + kPad, xs = PC + kPad;
  float* dts = reinterpret_cast<float*>(smem);
  float* cum = dts + Lt;
  float* w = cum + Lt;
  float* tot = w + Lt;  // the scan's step totals
  bf16* ring = reinterpret_cast<bf16*>(tot + Lt);  // stages of B then x
  const int stage_elems = kT * bs + kT * xs;
  const bf16* Bb = a.B + bi * a.b_sb + gi * n;
  const bf16* xb = a.x + bi * a.x_sb + hi * P + ps * PC;
  const int n_tiles = a.nc * nt;  // (chunk, key tile) pairs, in order
  auto load = [&](int t) {
    const int c = t / nt, kt = t - c * nt;
    bf16* d = ring + (t % kStateStages) * stage_elems;
    const long long r0 = (long long)c * L + kt * kT;
    const int rows = min(kT, L - kt * kT);
    stage(d, bs, Bb + r0 * a.b_st, a.b_st, rows, n);
    stage(d + kT * bs, xs, xb + r0 * a.x_st, a.x_st, rows, PC);
    hop::cp_commit();
  };
  const float A = a.A[hi];
  const float* dtb = a.dt + (size_t)bi * a.s * a.h + hi;
  // dt of chunk 0 before the tiles' copies, so the scan does not wait
  // behind them
  float dt_next = tid < L ? dtb[(size_t)tid * a.h] : 0.f;
  for (int t = 0; t < min(n_tiles, kStateStages - 1); ++t) load(t);

  const int wc = warp % T::kCG;  // this warp's column group
  const int wr = warp / T::kCG;  // and row group
  const int nmt = n >> 4;
  const size_t head = (size_t)bi * a.h + hi;
  const int col0 = ps * PC + wc * T::kCPW * 16 + 2 * (lane & 3);
  // the accumulators' (row, column) of element e of n8 tile j of m tile i
  auto at = [&](int i, int j, int e) {
    return (size_t)((wr + T::kRS * i) * 16 + (lane >> 2) + (e >> 1) * 8) * P +
           col0 + j * 8 + (e & 1);
  };
  float acc[T::kMT][2 * T::kCPW][4];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < 2 * T::kCPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][j][e] = a.init && wr + T::kRS * i < nmt
                           ? a.init[head * n * P + at(i, j, e)]
                           : 0.f;
  // ldmatrix rows of this lane: B^T (A operand) from B rows, x (B
  // operand) from x rows, both transposed
  const int a_row = (lane & 7) + ((lane >> 4) << 3);
  const int a_col = ((lane >> 3) & 1) << 3;
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_col = (lane >> 4) << 3;
  const size_t piece = (size_t)a.b * a.nc * a.h * n * P;

  for (int c = 0; c < a.nc; ++c) {
    const size_t row0 = (size_t)c * L;
    __syncthreads();  // the previous chunk is done with dts, cum and w
    if (tid < Lt) dts[tid] = dt_next;
    for (int l = tid + kChunkThreads; l < Lt; l += kChunkThreads)
      dts[l] = l < L ? dtb[(row0 + l) * a.h] : 0.f;
    __syncthreads();
    block_scan(dts, A, cum, tot, L);
    const float cum_last = cum[L - 1];
    float* cum_out = a.cum + head * a.s + row0;
    for (int l = tid; l < Lt; l += kChunkThreads) {
      if (l < L && ps == 0) cum_out[l] = cum[l];
      w[l] = l < L ? round_bf16(expf(cum_last - cum[l]) * dts[l]) : 0.f;
    }
    if (c + 1 < a.nc)  // the next chunk's dt, in flight over this chunk
      dt_next = tid < L ? dtb[(row0 + L + tid) * a.h] : 0.f;

    // h_prev of chunk c, then the decay of the carried state
    const float decay = expf(cum_last);
    const bool carry = c > 0 || a.init != nullptr;
    bf16* hp = a.hprev + ((size_t)bi * a.nc + c) * a.h * n * P +
               (size_t)hi * n * P;
#pragma unroll
    for (int i = 0; i < T::kMT; ++i) {
      if (wr + T::kRS * i < nmt) {
#pragma unroll
        for (int j = 0; j < 2 * T::kCPW; ++j) {
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            if (carry) {
              float r0 = acc[i][j][e], r1 = acc[i][j][e + 1];
              for (int k = 0; k < 3; ++k) {
                const uint32_t pk = hop::pack_bf16(r0, r1);
                const float2 f = unpack_bf16(pk);
                r0 -= f.x;
                r1 -= f.y;
                *reinterpret_cast<uint32_t*>(hp + k * piece + at(i, j, e)) =
                    pk;
              }
            }
            acc[i][j][e] *= decay;
            acc[i][j][e + 1] *= decay;
          }
        }
      }
    }

    for (int kt = 0; kt < nt; ++kt) {
      const int t = c * nt + kt;
      cp_wait_upto(min(kStateStages - 2, n_tiles - 1 - t));
      // tile t and w are in shared memory, and every warp is done with
      // tile t - 1, whose slot takes tile t + kStateStages - 1
      __syncthreads();
      if (t + kStateStages - 1 < n_tiles) load(t + kStateStages - 1);
      const bf16* sB = ring + (t % kStateStages) * stage_elems;
      const bf16* sX = sB + kT * bs;
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        const int k0 = kt * kT + kk * 16 + 2 * (lane & 3);
        const float w0 = w[k0], w1 = w[k0 + 1], w8 = w[k0 + 8],
                    w9 = w[k0 + 9];
        uint32_t hib[T::kCPW][4], lob[T::kCPW][4];
#pragma unroll
        for (int j = 0; j < T::kCPW; ++j) {
          uint32_t xr[4];
          hop::ldsm4_t(xr, sX + (kk * 16 + b_row) * xs +
                               (wc * T::kCPW + j) * 16 + b_col);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 v = unpack_bf16(xr[r]);
            const float p0 = (r & 1 ? w8 : w0) * v.x;
            const float p1 = (r & 1 ? w9 : w1) * v.y;
            hib[j][r] = hop::pack_bf16(p0, p1);
            const float2 hv = unpack_bf16(hib[j][r]);
            lob[j][r] = hop::pack_bf16(p0 - hv.x, p1 - hv.y);
          }
        }
        uint32_t af[T::kMT][4];
#pragma unroll
        for (int i = 0; i < T::kMT; ++i) {
          const int mt = wr + T::kRS * i;
          if (mt < nmt)
            hop::ldsm4_t(af[i],
                         sB + (kk * 16 + a_row) * bs + mt * 16 + a_col);
        }
        // the hi products of every accumulator, then the lo ones: no mma
        // waits on the one just before it
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
          for (int i = 0; i < T::kMT; ++i) {
            if (wr + T::kRS * i < nmt) {
#pragma unroll
              for (int j = 0; j < T::kCPW; ++j) {
                const uint32_t(&f)[4] = q ? lob[j] : hib[j];
                hop::mma_bf16(acc[i][2 * j], af[i], f[0], f[1]);
                hop::mma_bf16(acc[i][2 * j + 1], af[i], f[2], f[3]);
              }
            }
          }
        }
      }
    }
  }

  float* out = a.state + head * n * P;
#pragma unroll
  for (int i = 0; i < T::kMT; ++i) {
    if (wr + T::kRS * i < nmt) {
#pragma unroll
      for (int j = 0; j < 2 * T::kCPW; ++j) {
        *reinterpret_cast<float2*>(out + at(i, j, 0)) =
            make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(out + at(i, j, 2)) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
    }
  }
}

__device__ void chunk_cb(const TcArgs& a, int idx, unsigned char* smem) {
  const int pairs = a.nt * (a.nt + 1) / 2;
  int pi = idx % pairs;
  const int gi = (idx / pairs) % a.g;
  const int c = (idx / (pairs * a.g)) % a.nc;
  const int bi = idx / (pairs * a.g * a.nc);
  int qt = 0;
  while (pi > qt) pi -= ++qt;
  const int kt = pi;
  const int n = a.n, L = a.L, Lt = a.nt * kT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = n + kPad;
  bf16* sC = reinterpret_cast<bf16*>(smem);
  bf16* sB = sC + kT * cs;
  const long long row0 = (long long)c * L;
  stage(sC, cs, a.C + bi * a.c_sb + (row0 + qt * kT) * a.c_st + gi * n,
        a.c_st, min(kT, L - qt * kT), n);
  stage(sB, cs, a.B + bi * a.b_sb + (row0 + kt * kT) * a.b_st + gi * n,
        a.b_st, min(kT, L - kt * kT), n);
  hop::cp_commit();
  hop::cp_wait<0>();
  __syncthreads();

  // warp w: rows 16 (w & 3) of the query tile, keys 32 (w >> 2) on
  float s[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const int wrow = (warp & 3) * 16, wkey = (warp >> 2) * 32;
  const bf16* qa = sC + (wrow + (lane & 15)) * cs + ((lane >> 4) << 3);
  const bf16* kb = sB + wkey * cs + ((lane & 7) + ((lane >> 4) << 3)) * cs +
                   (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk < (n >> 4)) {
      uint32_t af[4];
      hop::ldsm4(af, qa + kk * 16);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t bk[4];
        hop::ldsm4(bk, kb + j * 8 * cs + kk * 16);
        hop::mma_bf16(s[j], af, bk[0], bk[1]);
        hop::mma_bf16(s[j + 1], af, bk[2], bk[3]);
      }
    }
  }
  float* out = a.cb + (((size_t)bi * a.nc + c) * a.g + gi) * Lt * Lt +
               (size_t)(qt * kT + wrow + (lane >> 2)) * Lt + kt * kT + wkey +
               2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float2*>(out + j * 8) = make_float2(s[j][0], s[j][1]);
    *reinterpret_cast<float2*>(out + 8 * Lt + j * 8) =
        make_float2(s[j][2], s[j][3]);
  }
}

template <int P>
__global__ void __launch_bounds__(kChunkThreads) ssd_chunk_kernel(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_state = a.b * a.h * StateSlice<P>::kSlices;
  if ((int)blockIdx.x < n_state) {
    chunk_state<P>(a, blockIdx.x, smem);
  } else {
    chunk_cb(a, blockIdx.x - n_state, smem);
  }
}

// The out kernel, per (row, chunk, 64-row query tile, head), the longest
// tiles first; 4 warps, 16 query rows each.
template <int P>
__global__ void __launch_bounds__(kOutThreads, P <= 64 ? 4 : 2)
ssd_out_kernel(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVT = P / 8;  // n8 tiles of a head's columns
  const int per_qt = a.b * a.nc * a.h;
  const int qt = a.nt - 1 - blockIdx.x / per_qt;
  const int rest = blockIdx.x % per_qt;
  const int hi = rest % a.h;
  const int c = (rest / a.h) % a.nc;
  const int bi = rest / (a.h * a.nc);
  const int n = a.n, L = a.L, Lt = a.nt * kT;
  const int gi = hi / (a.h / a.g);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = n + kPad, xs = P + kPad;
  const bool carry = c > 0 || a.init != nullptr;
  bf16* sC = reinterpret_cast<bf16*>(smem);
  bf16* sR = sC + kT * cs;  // the x tiles, then the h_prev stages
  float* cum = reinterpret_cast<float*>(sR + max(Lt, 6 * kSRows) * xs);
  float* dts = cum + Lt;
  const long long row0 = (long long)c * L;
  const int q0 = qt * kT;

  // cum and dt first; then one copy group per x tile, so key tile kt is
  // multiplied while the later ones arrive, and C last (only y_off needs
  // it)
  const int hi_pos = min(L, q0 + kT);
  const float* cum_in = a.cum + ((size_t)bi * a.h + hi) * a.s + row0;
  const float* dtb = a.dt + ((size_t)bi * a.s + row0) * a.h + hi;
  for (int l = tid; l < hi_pos; l += kOutThreads) {
    cum[l] = cum_in[l];
    dts[l] = dtb[(size_t)l * a.h];
  }
  const bf16* xb = a.x + bi * a.x_sb + row0 * a.x_st + hi * P;
  for (int kt = 0; kt <= qt; ++kt) {
    stage(sR + kt * kT * xs, xs, xb + kt * kT * a.x_st, a.x_st,
          min(kT, L - kt * kT), P);
    hop::cp_commit();
  }
  if (carry)
    stage(sC, cs, a.C + bi * a.c_sb + (row0 + q0) * a.c_st + gi * n, a.c_st,
          min(kT, L - q0), n);
  hop::cp_commit();

  // y_diag = round(M) @ x over the key tiles at or below the diagonal
  float yd[kVT][4];
#pragma unroll
  for (int v = 0; v < kVT; ++v) yd[v][0] = yd[v][1] = yd[v][2] = yd[v][3] = 0.f;
  const int r0 = q0 + warp * 16 + (lane >> 2);  // rows r0 and r0 + 8
  const float* cbp = a.cb + (((size_t)bi * a.nc + c) * a.g + gi) * Lt * Lt +
                     (size_t)r0 * Lt + 2 * (lane & 3);
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_col = (lane >> 4) << 3;
  // below the diagonal tile, with every row of the tile inside L, no
  // entry is masked
  const bool full = q0 + kT <= L;
  float cum_r[2];
  for (int kt = 0; kt <= qt; ++kt) {
    // on the diagonal tile, the keys past this warp's last row are all
    // masked: their n8 tiles and k16 steps are skipped
    const int jn = kt == qt ? 2 * warp + 2 : 8;
    const bool plain = kt < qt && full;
    float cb[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (t < jn) {
        const float2 u =
            *reinterpret_cast<const float2*>(cbp + kt * kT + t * 8);
        const float2 d =
            *reinterpret_cast<const float2*>(cbp + 8 * Lt + kt * kT + t * 8);
        cb[t][0] = u.x;
        cb[t][1] = u.y;
        cb[t][2] = d.x;
        cb[t][3] = d.y;
      }
    }
    cp_wait_upto(qt - kt + 1);  // x tile kt is in
    __syncthreads();
    if (kt == 0) {
      cum_r[0] = r0 < L ? cum[r0] : 0.f;
      cum_r[1] = r0 + 8 < L ? cum[r0 + 8] : 0.f;
    }
    const bf16* tX = sR + kt * kT * xs;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      if (2 * kk >= jn) break;
      float m[2][4];  // M over n8 tiles 2 kk and 2 kk + 1
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = kt * kT + (2 * kk + u) * 8 + 2 * (lane & 3);
        const float2 ck = *reinterpret_cast<const float2*>(cum + k);
        const float2 dk = *reinterpret_cast<const float2*>(dts + k);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = r0 + ((e >> 1) << 3);
          m[u][e] = plain || (k + (e & 1) <= l && l < L)
                        ? cb[2 * kk + u][e] *
                              expf(cum_r[e >> 1] - (e & 1 ? ck.y : ck.x)) *
                              (e & 1 ? dk.y : dk.x)
                        : 0.f;
        }
      }
      const uint32_t af[4] = {hop::pack_bf16(m[0][0], m[0][1]),
                              hop::pack_bf16(m[0][2], m[0][3]),
                              hop::pack_bf16(m[1][0], m[1][1]),
                              hop::pack_bf16(m[1][2], m[1][3])};
#pragma unroll
      for (int v = 0; v < kVT; v += 2) {
        uint32_t bx[4];
        hop::ldsm4_t(bx, tX + (kk * 16 + b_row) * xs + v * 8 + b_col);
        hop::mma_bf16(yd[v], af, bx[0], bx[1]);
        hop::mma_bf16(yd[v + 1], af, bx[2], bx[3]);
      }
    }
  }
  // round(y_diag), packed
  uint32_t ydr[kVT][2];
#pragma unroll
  for (int v = 0; v < kVT; ++v) {
    ydr[v][0] = hop::pack_bf16(yd[v][0], yd[v][1]);
    ydr[v][1] = hop::pack_bf16(yd[v][2], yd[v][3]);
  }

  // y_off = C @ h_prev, its three pieces staged through two slots of
  // kSRows rows of n each where the x tiles were
  float yo[kVT][4];
#pragma unroll
  for (int v = 0; v < kVT; ++v) yo[v][0] = yo[v][1] = yo[v][2] = yo[v][3] = 0.f;
  if (carry) {
    const size_t piece = (size_t)a.b * a.nc * a.h * n * P;
    const bf16* hp = a.hprev + (((size_t)bi * a.nc + c) * a.h + hi) * n * P;
    const int nst = (n + kSRows - 1) / kSRows;
    auto load = [&](int st) {
      bf16* d = sR + (st & 1) * 3 * kSRows * xs;
      const int rows = min(kSRows, n - st * kSRows);
      const int cc = P >> 3;
      for (int i = tid; i < 3 * rows * cc; i += kOutThreads) {
        const int r = i / cc;  // row of the three pieces' rows stacked
        const int k = r / rows;
        const int rr = r - k * rows;
        hop::cp16(d + (k * kSRows + rr) * xs + (i - r * cc) * 8,
                  hp + k * piece + (size_t)(st * kSRows + rr) * P +
                      (i - r * cc) * 8,
                  true);
      }
      hop::cp_commit();
    };
    __syncthreads();  // every warp is done with the x tiles
    load(0);
    if (nst > 1) load(1);
    const bf16* qa = sC + (warp * 16 + (lane & 15)) * cs + ((lane >> 4) << 3);
    for (int st = 0; st < nst; ++st) {
      cp_wait_upto(st + 1 < nst ? 1 : 0);
      __syncthreads();  // stage st (and the C tile) is in shared memory
      const bf16* slot = sR + (st & 1) * 3 * kSRows * xs;
#pragma unroll
      for (int kk = 0; kk < kSRows / 16; ++kk) {
        if (st * kSRows + kk * 16 < n) {
          uint32_t af[4];
          hop::ldsm4(af, qa + st * kSRows + kk * 16);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const bf16* tS = slot + (k * kSRows + kk * 16 + b_row) * xs + b_col;
#pragma unroll
            for (int v = 0; v < kVT; v += 2) {
              uint32_t bs[4];
              hop::ldsm4_t(bs, tS + v * 8);
              hop::mma_bf16(yo[v], af, bs[0], bs[1]);
              hop::mma_bf16(yo[v + 1], af, bs[2], bs[3]);
            }
          }
        }
      }
      __syncthreads();  // every warp is done with slot st & 1
      if (st + 2 < nst) load(st + 2);
    }
  }

  // y = round(round(y_diag) + exp(cum_l) y_off)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int l = r0 + 8 * half;
    if (l < L) {
      const float ec = expf(cum_r[half]);
      bf16* yrow = a.y + (((size_t)bi * a.s + row0 + l) * a.h + hi) * P +
                   2 * (lane & 3);
#pragma unroll
      for (int v = 0; v < kVT; ++v) {
        const float2 d = unpack_bf16(ydr[v][half]);
        *reinterpret_cast<uint32_t*>(yrow + v * 8) =
            hop::pack_bf16(d.x + yo[v][2 * half] * ec,
                           d.y + yo[v][2 * half + 1] * ec);
      }
    }
  }
}

size_t chunk_smem_bytes(int n, int p, int L) {
  const size_t Lt = (size_t)((L + kT - 1) / kT) * kT;
  const int pc = p < 32 ? p : 32;  // StateSlice<p>::kPC
  const size_t state =
      4 * Lt * sizeof(float) +
      kStateStages * (size_t)kT * (n + kPad + pc + kPad) * sizeof(bf16);
  const size_t cb = 2 * (size_t)kT * (n + kPad) * sizeof(bf16);
  return state > cb ? state : cb;
}

size_t out_smem_bytes(int n, int p, int L) {
  const size_t Lt = (size_t)((L + kT - 1) / kT) * kT;
  const size_t region = Lt > 6 * kSRows ? Lt : 6 * kSRows;
  return ((size_t)kT * (n + kPad) + region * (p + kPad)) * sizeof(bf16) +
         2 * Lt * sizeof(float);
}

template <int P>
cudaError_t launch_tc(const TcArgs& a, cudaStream_t st) {
  const int n_state = a.b * a.h * StateSlice<P>::kSlices;
  const int n_cb = a.b * a.nc * a.g * a.nt * (a.nt + 1) / 2;
  const cudaError_t e = hop::launch(
      ssd_chunk_kernel<P>, dim3(n_state + n_cb), kChunkThreads,
      chunk_smem_bytes(a.n, P, a.L), st, a);
  if (e != cudaSuccess) return e;
  return hop::launch(ssd_out_kernel<P>, dim3(a.nt * a.b * a.nc * a.h),
                     kOutThreads, out_smem_bytes(a.n, P, a.L), st, a);
}

template <int PC>
cudaError_t launch_f32_pc(const Args& a, int b, cudaStream_t stream) {
  return hop::launch(ssd_f32_kernel<PC>, dim3(a.h, b), kThreads,
                     f32_smem_bytes(a.n, a.p, a.L), stream, a);
}

}  // namespace

// Bytes of dynamic shared memory a kernel asks for at (n, p, L): which 0 =
// the float32 walk, 1 = the chunk kernel, 2 = the out kernel. The wrapper
// refuses shapes above the 227 KB a block may use.
extern "C" long long ssd_smem_bytes(int which, int n, int p, int L) {
  switch (which) {
    case 0: return (long long)f32_smem_bytes(n, p, L);
    case 1: return (long long)chunk_smem_bytes(n, p, L);
    case 2: return (long long)out_smem_bytes(n, p, L);
    default: return -1;
  }
}

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16. Sizes are checked by
// the caller: p in {16, 32, 64, 128}, h % g == 0, 1 <= L, s % L == 0,
// b, s >= 1; for bfloat16 also n % 16 == 0, n <= 128, x/B/C rows and
// pointers 16-byte aligned, and the scratch buffers (cum, cb, hprev)
// allocated as TcArgs lays them out (unused, may be null, for float32).
// init may be null. Returns a cudaError_t as int (0 = success).
extern "C" int ssd_chunked(int dtype, const void* x, const void* dt,
                           const void* A, const void* B, const void* C,
                           const void* init, void* y, void* state, void* cum,
                           void* cb, void* hprev, int b, int s,
                           int h, int p, int g, int n, int L, long long x_sb,
                           long long x_st, long long b_sb, long long b_st,
                           long long c_sb, long long c_st, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
    Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
           B, C, static_cast<const float*>(init), y,
           static_cast<float*>(state), s, h, p, g, n, L,
           x_sb, x_st, b_sb, b_st, c_sb, c_st};
    switch (p) {
      case 16: e = launch_f32_pc<1>(a, b, st); break;
      case 32: e = launch_f32_pc<2>(a, b, st); break;
      case 64: e = launch_f32_pc<4>(a, b, st); break;
      case 128: e = launch_f32_pc<8>(a, b, st); break;
    }
  } else if (dtype == 1) {
    TcArgs a{static_cast<const bf16*>(x), static_cast<const float*>(dt),
             static_cast<const float*>(A), static_cast<const bf16*>(B),
             static_cast<const bf16*>(C), static_cast<const float*>(init),
             static_cast<bf16*>(y), static_cast<float*>(state),
             static_cast<float*>(cum), static_cast<float*>(cb),
             static_cast<bf16*>(hprev),
             b, s, h, p, g, n, L, s / L, (L + kT - 1) / kT,
             x_sb, x_st, b_sb, b_st, c_sb, c_st};
    switch (p) {
      case 16: e = launch_tc<16>(a, st); break;
      case 32: e = launch_tc<32>(a, st); break;
      case 64: e = launch_tc<64>(a, st); break;
      case 128: e = launch_tc<128>(a, st); break;
    }
  }
  return static_cast<int>(e);
}
