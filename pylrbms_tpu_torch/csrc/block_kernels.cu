// Hand-written Hopper (sm_90a) kernels for the PCG body of the online step.
//
// Replaces the two Pallas TPU kernels of pylrbms_tpu/ops/pallas_kernels.py:
//
//  * pylrbms_block_matvec  <- block_matvec_pallas / _block_matvec_kernel
//      y[b,k,i] = sum_g coef[b,g] * sum_j A[g,k,i,j] * x[b,k,j]
//      A [G,K,N,N] (f64 | f32 | bf16), x/y [B,K,N], coef [B,G] or NULL (G=1).
//      Serves the assembled diagonal-block apply (G=1), the affine-stack
//      apply (G=Q, coef = per-lane theta) and the harvest filter's
//      block-Jacobi apply (G=1, one lane per harvested vector).
//  * pylrbms_precond_dot   <- precond_dot_pallas / _precond_dot_kernel
//      z[b,k,:] = F[k] @ r[b,k,:],  rz[b,k] = r[b,k,:] . z[b,k,:]
//      F [K,N,N] (f64 | f32 | bf16), r/z [B,K,N], rz [B,K].  rz is [B,K],
//      not the Pallas 1-D (K,) block, and one block owns all N rows of its
//      (k, lane tile): the per-subdomain dot is reduced in shared memory in
//      a fixed order, deterministic, without atomics.
//
// Accumulation is in the vector's type: f64 for f64 vectors, f32 otherwise
// (bf16 matrix elements widen exactly to f32/f64).  SIMT FMA only: no
// tensor cores (TF32 would cost the digits CG needs; bf16 matrices are
// widened, not multiplied in bf16).
//
// What bounds them on an H100.  Every A (F) element is used once per lane.
//  * Few lanes (B <= 8, the single query): the kernels stream the matrix
//    stack once per call and are bound by device-memory bandwidth
//    (G K N^2 elements).  Design ("rows"): one warp per matrix row, the 32
//    threads walk the row with coalesced loads, each keeps one partial sum
//    per lane (up to 8 lanes in registers) and a butterfly shuffle reduces
//    them in a fixed order.  block_matvec runs one block per (k, 8 rows),
//    thousands of blocks; precond_dot one 16-warp block per k, which owns
//    all rows of k and reduces rz across its warps in shared memory.
//  * Many lanes (B > 8, the serving batch B=256): each element serves B
//    lanes and the work is FMA-bound (2 G K N^2 B flops).  Design ("tiles"):
//    a block owns one subdomain k, TI rows and LB lanes and walks the j axis
//    in steps of TJ, staging the A tile and the x tile of its lanes in
//    shared memory (each A element read from device memory once per lane
//    tile); each thread keeps an RPT x LPT register tile of (row, lane)
//    accumulators, so a shared-memory load feeds LPT (or RPT) FMAs.
// Any N (masked tail), any B >= 1.
//
// Plain C interface (loaded with ctypes); each entry point launches on the
// given stream and returns cudaGetLastError() of the launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr int TJ = 32;      // j-tile (reduction axis) width of the tiled kernels
constexpr int MAXB = 8;     // lanes held in registers by the row kernels

__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }

template <typename TA>
__device__ __forceinline__ TA warp_sum(TA v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ----------------------------------------------------------------------------
// rows: few lanes, one warp per matrix row
// ----------------------------------------------------------------------------

// acc[b] = sum_j A_row[j] * x[b,k,j] over this thread's j = lane, lane+32, ...
template <typename TS, typename TA>
__device__ __forceinline__ void row_partials(const TS* __restrict__ Arow,
                                             const TA* __restrict__ x, int K,
                                             int N, int B, int k, int lane,
                                             TA (&acc)[MAXB]) {
#pragma unroll
  for (int b = 0; b < MAXB; ++b) acc[b] = TA(0);
#pragma unroll 4
  for (int j = lane; j < N; j += 32) {
    const TA a = TA(widen(Arow[j]));
#pragma unroll
    for (int b = 0; b < MAXB; ++b)
      if (b < B) acc[b] = madd(a, x[((size_t)b * K + k) * N + j], acc[b]);
  }
}

template <typename TS, typename TA, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
block_matvec_rows(const TS* __restrict__ A, const TA* __restrict__ x,
                  const TA* __restrict__ coef, TA* __restrict__ y,
                  int G, int K, int N, int B) {
  const int k = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.y * WARPS + threadIdx.x / 32;
  if (i >= N) return;                      // whole warps only; no block sync
  TA part[MAXB];
#pragma unroll
  for (int b = 0; b < MAXB; ++b) part[b] = TA(0);
  for (int g = 0; g < G; ++g) {
    TA acc[MAXB];
    row_partials(A + (((size_t)g * K + k) * N + i) * N, x, K, N, B, k, lane, acc);
#pragma unroll
    for (int b = 0; b < MAXB; ++b)
      if (b < B) part[b] += (coef != nullptr ? coef[(size_t)b * G + g] : TA(1)) * acc[b];
  }
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    if (b < B) {
      const TA v = warp_sum(part[b]);
      if (lane == 0) y[((size_t)b * K + k) * N + i] = v;
    }
  }
}

template <typename TS, typename TA, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
precond_dot_rows(const TS* __restrict__ F, const TA* __restrict__ r,
                 TA* __restrict__ z, TA* __restrict__ rz, int K, int N, int B) {
  __shared__ TA red[WARPS][MAXB];
  const int k = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  TA part[MAXB];
#pragma unroll
  for (int b = 0; b < MAXB; ++b) part[b] = TA(0);
  for (int i = warp; i < N; i += WARPS) {
    TA acc[MAXB];
    row_partials(F + ((size_t)k * N + i) * N, r, K, N, B, k, lane, acc);
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b < B) {
        const size_t o = ((size_t)b * K + k) * N + i;
        const TA v = warp_sum(acc[b]);     // every lane holds the row's z
        if (lane == 0) z[o] = v;
        part[b] = madd(r[o], v, part[b]);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < MAXB; ++b) red[warp][b] = part[b];
  }
  __syncthreads();
  if (threadIdx.x < B) {
    TA s = TA(0);
    for (int w = 0; w < WARPS; ++w) s += red[w][threadIdx.x];
    rz[(size_t)threadIdx.x * K + k] = s;
  }
}

// ----------------------------------------------------------------------------
// tiles: many lanes, shared-memory tiles and register tiles
// ----------------------------------------------------------------------------

// out[q][l] = sum_g coef[b,g] sum_j A[g,k,i,j] x[b,k,j] for this thread's
// rows i = i0 + grp + q*NG and lanes b = b0 + lg + l*NL.  Every thread of
// the block must call it (it synchronizes).
template <typename TS, typename TA, int LB, int TI, int RPT, int LPT>
__device__ __forceinline__ void tile_matvec(
    const TS* __restrict__ A, const TA* __restrict__ x,
    const TA* __restrict__ coef, int G, int K, int N, int B,
    int k, int i0, int b0, TA (&As)[TI][TJ + 1], TA (&Xs)[TJ][LB + 1],
    TA (&out)[RPT][LPT]) {
  constexpr int NL = LB / LPT;     // lane groups
  constexpr int NG = TI / RPT;     // row groups
  constexpr int NT = NL * NG;      // threads
  const int t = threadIdx.x;
  const int lg = t % NL, grp = t / NL;
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int l = 0; l < LPT; ++l) out[q][l] = TA(0);
  for (int g = 0; g < G; ++g) {
    TA acc[RPT][LPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int l = 0; l < LPT; ++l) acc[q][l] = TA(0);
    const TS* Ag = A + ((size_t)g * K + k) * (size_t)N * N;
    for (int j0 = 0; j0 < N; j0 += TJ) {
      for (int e = t; e < TI * TJ; e += NT) {
        const int q = e / TJ, c = e - q * TJ;
        const int i = i0 + q, j = j0 + c;
        As[q][c] = (i < N && j < N) ? TA(widen(Ag[(size_t)i * N + j])) : TA(0);
      }
      for (int e = t; e < LB * TJ; e += NT) {
        const int l = e / TJ, c = e - l * TJ;
        const int b = b0 + l, j = j0 + c;
        Xs[c][l] = (b < B && j < N) ? x[((size_t)b * K + k) * N + j] : TA(0);
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < TJ; ++c) {
        TA av[RPT], xv[LPT];
#pragma unroll
        for (int q = 0; q < RPT; ++q) av[q] = As[grp + q * NG][c];
#pragma unroll
        for (int l = 0; l < LPT; ++l) xv[l] = Xs[c][lg + l * NL];
#pragma unroll
        for (int q = 0; q < RPT; ++q)
#pragma unroll
          for (int l = 0; l < LPT; ++l) acc[q][l] = madd(av[q], xv[l], acc[q][l]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int b = b0 + lg + l * NL;
      const TA cg = (coef != nullptr && b < B) ? coef[(size_t)b * G + g] : TA(1);
#pragma unroll
      for (int q = 0; q < RPT; ++q) out[q][l] += cg * acc[q][l];
    }
  }
}

template <typename TS, typename TA, int LB, int TI, int RPT, int LPT>
__global__ void __launch_bounds__((LB / LPT) * (TI / RPT))
block_matvec_tiles(const TS* __restrict__ A, const TA* __restrict__ x,
                   const TA* __restrict__ coef, TA* __restrict__ y,
                   int G, int K, int N, int B) {
  constexpr int NL = LB / LPT, NG = TI / RPT;
  __shared__ TA As[TI][TJ + 1];
  __shared__ TA Xs[TJ][LB + 1];
  const int k = blockIdx.x, i0 = blockIdx.y * TI, b0 = blockIdx.z * LB;
  TA out[RPT][LPT];
  tile_matvec<TS, TA, LB, TI, RPT, LPT>(A, x, coef, G, K, N, B, k, i0, b0, As, Xs, out);
  const int lg = threadIdx.x % NL, grp = threadIdx.x / NL;
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int b = b0 + lg + l * NL;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int i = i0 + grp + q * NG;
      if (b < B && i < N) y[((size_t)b * K + k) * N + i] = out[q][l];
    }
  }
}

template <typename TS, typename TA, int LB, int TI, int RPT, int LPT>
__global__ void __launch_bounds__((LB / LPT) * (TI / RPT))
precond_dot_tiles(const TS* __restrict__ F, const TA* __restrict__ r,
                  TA* __restrict__ z, TA* __restrict__ rz, int K, int N, int B) {
  constexpr int NL = LB / LPT, NG = TI / RPT;
  __shared__ TA As[TI][TJ + 1];
  __shared__ TA Xs[TJ][LB + 1];
  __shared__ TA red[NG][LB];
  const int k = blockIdx.x, b0 = blockIdx.y * LB;
  const int lg = threadIdx.x % NL, grp = threadIdx.x / NL;
  TA part[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) part[l] = TA(0);
  for (int i0 = 0; i0 < N; i0 += TI) {
    TA out[RPT][LPT];
    tile_matvec<TS, TA, LB, TI, RPT, LPT>(F, r, nullptr, 1, K, N, B, k, i0, b0, As, Xs, out);
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int b = b0 + lg + l * NL;
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int i = i0 + grp + q * NG;
        if (b < B && i < N) {
          const size_t o = ((size_t)b * K + k) * N + i;
          z[o] = out[q][l];
          part[l] = madd(r[o], out[q][l], part[l]);
        }
      }
    }
  }
#pragma unroll
  for (int l = 0; l < LPT; ++l) red[grp][lg + l * NL] = part[l];
  __syncthreads();
  for (int l = threadIdx.x; l < LB; l += NL * NG) {
    const int b = b0 + l;
    if (b < B) {
      TA s = TA(0);
      for (int g = 0; g < NG; ++g) s += red[g][l];
      rz[(size_t)b * K + k] = s;
    }
  }
}

enum { kF64 = 0, kF32 = 1, kBF16 = 2 };

template <typename TS, typename TA>
int launch_block_matvec(const void* A, const void* x, const void* coef, void* y,
                        int G, int K, int N, int B, cudaStream_t s) {
  const TS* a = static_cast<const TS*>(A);
  const TA* xv = static_cast<const TA*>(x);
  const TA* c = static_cast<const TA*>(coef);
  TA* yv = static_cast<TA*>(y);
  if (B <= MAXB) {
    constexpr int WARPS = 8;
    dim3 grid(K, (N + WARPS - 1) / WARPS);
    block_matvec_rows<TS, TA, WARPS><<<grid, 32 * WARPS, 0, s>>>(a, xv, c, yv, G, K, N, B);
  } else {
    // 64 rows x 64 lanes per block, 4 x 4 (row, lane) accumulators a thread
    dim3 grid(K, (N + 63) / 64, (B + 63) / 64);
    block_matvec_tiles<TS, TA, 64, 64, 4, 4><<<grid, 256, 0, s>>>(a, xv, c, yv, G, K, N, B);
  }
  return (int)cudaGetLastError();
}

template <typename TS, typename TA>
int launch_precond_dot(const void* F, const void* r, void* z, void* rz,
                       int K, int N, int B, cudaStream_t s) {
  const TS* f = static_cast<const TS*>(F);
  const TA* rv = static_cast<const TA*>(r);
  TA* zv = static_cast<TA*>(z);
  TA* rzv = static_cast<TA*>(rz);
  if (B <= MAXB) {
    constexpr int WARPS = 16;
    precond_dot_rows<TS, TA, WARPS><<<K, 32 * WARPS, 0, s>>>(f, rv, zv, rzv, K, N, B);
  } else {
    // 64 rows x 32 lanes per step, 4 x 2 accumulators a thread; a block
    // walks all row tiles of its subdomain
    dim3 grid(K, (B + 31) / 32);
    precond_dot_tiles<TS, TA, 32, 64, 4, 2><<<grid, 256, 0, s>>>(f, rv, zv, rzv, K, N, B);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pylrbms_block_matvec(int a_dtype, int x_dtype, const void* A,
                                    const void* x, const void* coef, void* y,
                                    int G, int K, int N, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF64 && a_dtype == kF64)
    return launch_block_matvec<double, double>(A, x, coef, y, G, K, N, B, s);
  if (x_dtype == kF64 && a_dtype == kBF16)
    return launch_block_matvec<__nv_bfloat16, double>(A, x, coef, y, G, K, N, B, s);
  if (x_dtype == kF32 && a_dtype == kF32)
    return launch_block_matvec<float, float>(A, x, coef, y, G, K, N, B, s);
  if (x_dtype == kF32 && a_dtype == kBF16)
    return launch_block_matvec<__nv_bfloat16, float>(A, x, coef, y, G, K, N, B, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pylrbms_precond_dot(int f_dtype, int r_dtype, const void* F,
                                   const void* r, void* z, void* rz,
                                   int K, int N, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r_dtype == kF64 && f_dtype == kF64)
    return launch_precond_dot<double, double>(F, r, z, rz, K, N, B, s);
  if (r_dtype == kF64 && f_dtype == kBF16)
    return launch_precond_dot<__nv_bfloat16, double>(F, r, z, rz, K, N, B, s);
  if (r_dtype == kF32 && f_dtype == kF32)
    return launch_precond_dot<float, float>(F, r, z, rz, K, N, B, s);
  if (r_dtype == kF32 && f_dtype == kBF16)
    return launch_precond_dot<__nv_bfloat16, float>(F, r, z, rz, K, N, B, s);
  return (int)cudaErrorInvalidValue;
}
