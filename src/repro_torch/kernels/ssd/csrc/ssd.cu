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
// Design. The chunks of one (b, h) are a recurrence, so one block owns one
// (b, h) and walks its chunks in order; the TPU kernel's sequential grid
// axis becomes this loop, and its VMEM scratch state lives in shared memory
// (n x p float32: 32 KB at mamba2-370m's n = 128, p = 64). A full (L, L)
// score tile is 256 KB at L = 256, over the 227 KB a block may use, so the
// intra-chunk product is tiled: 64-row query tiles of C, and for each the
// 64-row key tiles of B and x at or below it (the causal half). Each thread
// holds a 4 x p/16 block of the query tile's outputs (rows t/16 + 16r,
// columns t%16 + 16c) in registers, and computes the matching 4 x 4 block of
// C.B^T. Masked entries of M are selected to 0, never multiplied, so the
// exp of the masked region enters no sum; rows past a ragged L are zero-
// filled and written nowhere. The carry is accumulated while the last query
// tile walks all key tiles, after that tile has read the old state.
//
// What bounds it on the card: at mamba2-370m's shapes the bytes (x, B, C, y
// once each) against 3.35 TB/s, about 0.007 ms at b = 4, s = 512, bf16. This
// first kernel is far from that: its products run on the CUDA cores from
// shared memory, C.B^T is recomputed for every head of a group, and every
// block reloads the key tiles for each query tile (from L2). wgmma, TMA and
// sharing C.B^T across a group's heads are later work.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream
// and returns cudaGetLastError() so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;        // rows of a query or key tile
constexpr int kMs = kT + 1;   // padded row stride of the M tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded to T and widened again (round to nearest even)
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Rows [0, rows) of a tile of kT rows, each of `cols` elements, row_stride
// apart in global memory, into shared memory as float32 rows dst_stride
// apart; rows [rows, kT) are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int rows,
                                          int cols, int dst_stride) {
  for (int i = threadIdx.x; i < kT * cols; i += kThreads) {
    const int r = i / cols;
    const int c = i - r * cols;
    dst[r * dst_stride + c] =
        r < rows ? to_float(src[r * row_stride + c]) : 0.f;
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
template <typename T, int PC>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Args a) {
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
  float* w = cum + L;               // L: round(exp(cum_L - cum) * dt)

  const int tid = threadIdx.x;
  const int ti = tid >> 4;
  const int tj = tid & 15;
  const float A = a.A[hi];
  const T* xb = static_cast<const T*>(a.x) + bi * a.x_sb + hi * p;
  const T* Bb = static_cast<const T*>(a.B) + bi * a.b_sb + gi * n;
  const T* Cb = static_cast<const T*>(a.C) + bi * a.c_sb + gi * n;
  const float* dtb = a.dt + (size_t)bi * a.s * h + hi;
  T* yb = static_cast<T*>(a.y) + (size_t)bi * a.s * h * p + hi * p;
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
      w[l] = round_to<T>(expf(cum_last - cum[l]) * dts[l]);
    const float chunk_decay = expf(cum_last);

    for (int qt = 0; qt < ntile; ++qt) {
      const int l0 = qt * kT;
      const bool last = qt == ntile - 1;
      __syncthreads();  // the previous query tile is done with Cq
      load_tile<T>(Cq, Cb + (long long)(c0 + l0) * a.c_st, a.c_st,
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
        load_tile<T>(Bk, Bb + (long long)(c0 + m0) * a.b_st, a.b_st, mrows,
                     n, ns);
        load_tile<T>(xk, xb + (long long)(c0 + m0) * a.x_st, a.x_st, mrows,
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
              v = round_to<T>(cb[r][c] * expf(cum[l] - cum[m]) * dts[m]);
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
                from_float<T>(round_to<T>(yd[r][c]) + yo[r][c] * ec);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n * p; i += kThreads) a.state[st_off + i] = S[i];
}

size_t smem_bytes(int n, int p, int L) {
  return sizeof(float) * ((size_t)n * p + 2 * (size_t)kT * (n + 1) +
                          (size_t)kT * p + (size_t)kT * kMs + 3 * (size_t)L);
}

template <typename T, int PC>
cudaError_t launch_pc(const Args& a, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.n, a.p, a.L);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T, PC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  ssd_kernel<T, PC><<<dim3(a.h, b), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  switch (a.p) {
    case 16: return launch_pc<T, 1>(a, b, stream);
    case 32: return launch_pc<T, 2>(a, b, stream);
    case 64: return launch_pc<T, 4>(a, b, stream);
    case 128: return launch_pc<T, 8>(a, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of dynamic shared memory a launch at (n, p, L) asks for; the
// wrapper refuses shapes above the 227 KB a block may use.
extern "C" long long ssd_smem_bytes(int n, int p, int L) {
  return (long long)smem_bytes(n, p, L);
}

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16. Sizes are checked by
// the caller: p in {16, 32, 64, 128}, h % g == 0, 1 <= L, s % L == 0,
// b, s >= 1. init may be null. Returns a cudaError_t as int (0 = success).
extern "C" int ssd_chunked(int dtype, const void* x, const void* dt,
                           const void* A, const void* B, const void* C,
                           const void* init, void* y, void* state, int b,
                           int s, int h, int p, int g, int n, int L,
                           long long x_sb, long long x_st, long long b_sb,
                           long long b_st, long long c_sb, long long c_st,
                           void* stream) {
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
         B, C, static_cast<const float*>(init), y,
         static_cast<float*>(state), s, h, p, g, n, L,
         x_sb, x_st, b_sb, b_st, c_sb, c_st};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = launch<float>(a, b, st);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(a, b, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
