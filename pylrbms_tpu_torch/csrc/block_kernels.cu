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
//      F [K,N,N] (f64 | f32 | bf16), r/z [B,K,N], rz [B,K] (not the Pallas
//      1-D (K,) block).  rz is deterministic on every route: summed in a
//      fixed order, without float atomics, in one launch.
//
// and adds two kernels that replace none (their notes are at their code):
//
//  * pylrbms_stencil3_apply: the lane-batched 3D hex Q1 stencil apply
//      y[b,k,c,:] = sum_q theta[b,q] sum_j S[q,k,c,j] @ x[b,nbr_j(k,c),:]
//      S [Q,K,s,s,s,7,8,8], theta [B,Q], x/y [B,K,8 s^3] (f32 | f64).
//  * pylrbms_stencil2_apply: the same on the 2D tri P1 stencil
//      S [Q,K,s,s,2,4,3,3], theta [B,Q], x/y [B,K,6 s^2] (f32 | f64).
//
// Every matrix element is used once per lane, so the work is 2 G K N^2 B
// operations on G K N^2 matrix elements: below ~20 operations per byte
// (f32; ~10 for f64) the card's memory bounds it, above it the arithmetic.
// The wrapper (ops/hopper_kernels.py: plan) picks the route by that
// intensity and the lane count and passes it here as an int:
//
//  * stream (memory-bound: few lanes, B <= 16).  Goal: enough bytes in
//    flight on all 132 SMs.  A block owns C chunks of 32 rows of one
//    subdomain (>= 2 waves of blocks at K=64, N >= 384); each warp owns 4
//    rows and its threads walk them with 16-byte streaming loads (double2,
//    float4, 8 x bf16 as uint4), 4-8 independent loads per thread in
//    flight.  x (times coef[b,g]: the G-sum folds into the reduction) is
//    staged in shared memory once per block where all of it fits (else per
//    column chunk) and read back as 16-byte vectors; each thread keeps 4 x LB
//    (row, lane) accumulators, reduced by a xor butterfly (every lane ends
//    with the same bits).  precond_dot writes one rz partial per (lane, k,
//    block) to a wrapper-allocated scratch; the last block of each k
//    (found with an integer ticket, which it resets) sums them in block
//    order.  Rows whose byte length is not a multiple of 16 (or a
//    misaligned matrix) take scalar loads.  At 16 lanes the accumulators
//    (128 registers in f64) leave 8 warps an SM and one load a row in
//    flight (a third of the bound, PERF.md), so the f64 and f32 pairs of
//    both kernels take the ring form there; at 16 lanes the register stream
//    keeps bf16 matrices (bf16 x f64 up to its ridge, where dmma takes
//    over), rows that are no 16-byte multiple and misaligned operands:
//  * ring (the stream route's form for 5-16 lanes of block_matvec and
//    precond_dot, f64 x f64 and f32 x f32, any N with 16-byte rows: the
//    copy zero-fills the last stage's columns past N).  A block owns 64
//    rows x 16 lanes; tiles of A and x stream through a 3- or 4-stage
//    cp.async ring in shared memory (no register holds a row's lane
//    accumulators), and the product runs on the tensor cores:
//    f64 as DMMA (IEEE f64 multiply-adds), f32 as 3xTF32 (below) with each
//    stage's sums added to the running sum by an IEEE f32 add.
//    precond_dot's rz goes through per-row-tile partials and a ticket per
//    k, as on the stream route.
//  * tensor (many lanes: the serving batch, 3D serving and the truth
//    harvest filter; N % 32 == 0).  The f32 operand is split so the products
//    stay f32-accurate (no product may lose the digits CG needs), with
//    integer and f32 ops only (the cvt instructions issue at a quarter
//    rate):
//      - precond_dot, bf16 F x f32 r: r = r1 + r2 + r3, each the bf16
//        truncation of what the terms before left (exact: 3 x 8 bits hold
//        f32's 24), three bf16 products with f32 accumulation, small terms
//        first; each F r_i is exact in f32;
//      - block_matvec, f32 A x f32 x: 3xTF32 (big = round-to-nearest-away
//        TF32 as cvt.rna, small = the remainder truncated to TF32, for A and
//        coef*x; a_small x_big + a_big x_small + a_big x_big), the G-sum
//        folded into a reduction of depth G N.
//    Warp-specialised tiled GEMMs on wgmma: a block owns 128 rows x 32 or
//    128 lanes of one subdomain (plan() picks the lanes: no empty lanes at
//    32); one producer warp keeps a ring of TMA box copies in flight
//    (mbarriers count the bytes, consumers release the stages), two
//    consumer warpgroups split each vector stage
//    once into shared-memory planes (A's fragments in registers) and issue
//    m64 wgmmas on them, one stage in flight while the next is split; the
//    epilogue writes 16-byte rows through shared memory.  One
//    accumulation chain over the depth: the tensor cores' f32 sums drop low
//    bits, so the error grows with N (PERF.md; within the f32 tolerance at
//    the harvest's N=1728).  precond_dot's rz goes through per-row-tile
//    partials and a ticket per (k, lane tile), r's rows kept in registers
//    from the stages that hold them.
//  * dmma (every f64-vector launch the stream does not take: f64 x f64 and
//    bf16 x f64, any N, any B).  Tiled GEMMs per subdomain on the f64
//    tensor cores: a block owns 64 or 32 rows x 64 or 32 lanes of one k
//    (grid: lane tiles, row tiles, K), 4 warps; 16-column tiles of A (bf16
//    as raw bytes, widened exactly when the fragment is built) and x reach
//    shared memory by TMA (one thread issues two tensor-map box copies a
//    stage, an mbarrier counts the bytes, the hardware zero-fills the tails)
//    in a 4-stage ring, and the product runs as mma.sync m16n8k8 f64 (IEEE
//    f64 multiply-adds) into f64 accumulators in registers.  The G-sum
//    folds into a reduction of depth G N; precond_dot's rz goes through
//    per-row-tile partials and a ticket per (k, lane tile).  Unaligned rows
//    take scalar loads into the same layout.  It is bound by the copy into
//    shared memory (HBM for A, L2 for the tiles read again), PERF.md.
//  * tiles (the first port's SIMT kernels, unchanged: the f32-vector pairs with no
//    tensor route at many lanes, f32 x f32 in precond_dot and bf16 x f32 in
//    block_matvec, and the f32 launches the tensor route refuses, N % 32 != 0
//    or misaligned; no main path launches them).  SIMT FMA with
//    shared-memory tiles, a block owns one subdomain k, TI rows and LB
//    lanes, each thread an RPT x LPT register tile.
//
// Accumulation is in the vector's type (f64 for f64 vectors, f32
// otherwise); bf16 matrix elements widen exactly.  Any N (masked tails) on
// the stream, dmma and tiles routes, N with 16-byte rows on the ring, any
// B >= 1 (at most 16 on the ring).
//
// Plain C interface (loaded with ctypes); each entry point launches on the
// given stream and returns cudaGetLastError() of the launch.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum { kStream = 0, kTensor = 1, kTiles = 2, kRing = 3, kDmma = 4 };
enum { kF64 = 0, kF32 = 1, kBF16 = 2 };

constexpr int ROWS_PER_BLOCK = 32;   // stream route: rows of one k per block chunk
constexpr int STREAM_WARPS = 8;      // stream route: warps per block (4 rows each)
constexpr int XS_WHOLE = 200 * 1024; // stream route: most shared memory for all of x
constexpr int XS_CHUNK = 32768;      // stream route: x chunk when all of x does not fit
constexpr int TJ = 32;               // tiles route: j-tile width

__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }

// xor butterfly: every lane ends with the same bits (IEEE addition commutes)
template <typename TA>
__device__ __forceinline__ TA warp_sum(TA v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ----------------------------------------------------------------------------
// stream route
// ----------------------------------------------------------------------------

// 16-byte loads per row and step: 8 bf16 or one scalar each take fewer in
// flight; 16 lanes of accumulators leave room for only one
__host__ __device__ constexpr int stream_unroll(int vec, int lb) {
  return (vec == 8 || lb == 16) ? 1 : vec == 1 ? 4 : 2;
}

__device__ __forceinline__ uint32_t word(const uint4& r, int w) {
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

// element e of a 16-byte vector of matrix elements, widened
__device__ __forceinline__ double elem(const uint4& r, int e, const double*) {
  return e == 0 ? __hiloint2double((int)r.y, (int)r.x) : __hiloint2double((int)r.w, (int)r.z);
}
__device__ __forceinline__ float elem(const uint4& r, int e, const float*) {
  return __uint_as_float(word(r, e));
}
__device__ __forceinline__ float elem(const uint4& r, int e, const __nv_bfloat16*) {
  const uint32_t w = word(r, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}
// scalar-load fallback: the element itself
template <typename TS>
__device__ __forceinline__ auto elem(const TS& r, int, const TS*) { return widen(r); }

__device__ __forceinline__ void load_raw(uint4& r, const void* p) {
  r = __ldcs(static_cast<const uint4*>(p));           // streamed once: evict first
}
template <typename TS>
__device__ __forceinline__ void load_raw(TS& r, const TS* p) { r = *p; }

// VEC consecutive x values from shared memory (16-byte reads where they fit)
template <typename TA, int VEC>
__device__ __forceinline__ void load_xs(const TA* p, TA (&v)[VEC]) {
  if constexpr ((VEC * sizeof(TA)) % 16 == 0) {
#pragma unroll
    for (int q = 0; q < (int)(VEC * sizeof(TA) / 16); ++q)
      reinterpret_cast<uint4*>(v)[q] = reinterpret_cast<const uint4*>(p)[q];
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = p[e];
  }
}

// Stream kernel: block (blockIdx.x, k = blockIdx.y) owns C chunks of 32 rows
// (8 warps x R = 4 rows).  Whole mode (XJ >= N): all G coef-scaled copies of
// x[:, k, :] are staged once, xs[(g LB + b) XJ + c], and the block walks its
// C chunks; chunked mode (C = 1): x is staged per (g, column chunk of XJ).
// PD: precond_dot (G = 1, no coef, rz through partials + tickets).
template <typename TS, typename TA, bool VECL, int LB, bool PD>
__global__ void __launch_bounds__(32 * STREAM_WARPS)
stream_kernel(const TS* __restrict__ A, const TA* __restrict__ x,
              const TA* __restrict__ coef, TA* __restrict__ y,
              TA* __restrict__ rz, TA* __restrict__ partials,
              unsigned* __restrict__ tickets, int G, int K, int N, int B, int XJ, int C) {
  constexpr int R = ROWS_PER_BLOCK / STREAM_WARPS;     // rows per warp
  constexpr int WARPS = STREAM_WARPS;
  constexpr int VEC = VECL ? 16 / (int)sizeof(TS) : 1;
  constexpr int U = stream_unroll(VEC, LB);            // loads per row and step
  constexpr int S = 32 * VEC * U;                     // columns per step
  using Raw = typename std::conditional<VECL, uint4, TS>::type;

  extern __shared__ __align__(16) unsigned char smem[];
  TA* xs = reinterpret_cast<TA*>(smem);
  const int k = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool whole = XJ >= N;

  auto stage = [&](int g0, int ng, int j0, int jn) {   // xs <- coef * x, zero-padded
    for (int e = threadIdx.x; e < ng * LB * XJ; e += 32 * WARPS) {
      const int gb = e / XJ, c = e - gb * XJ;
      const int g = g0 + gb / LB, b = gb % LB;
      TA v = TA(0);
      if (b < B && c < jn) {
        v = x[((size_t)b * K + k) * N + j0 + c];
        if (coef != nullptr) v *= coef[(size_t)b * G + g];
      }
      xs[e] = v;
    }
    __syncthreads();
  };
  if (whole) stage(0, G, 0, N);

  TA rzp[LB];
#pragma unroll
  for (int b = 0; b < LB; ++b) rzp[b] = TA(0);
  for (int rc = 0; rc < C; ++rc) {
    const int rbase = (blockIdx.x * C + rc) * ROWS_PER_BLOCK;
    if (rbase >= N) break;                            // uniform over the block
    const int row0 = rbase + warp * R;
    TA acc[R][LB];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int b = 0; b < LB; ++b) acc[r][b] = TA(0);

    for (int g = 0; g < G; ++g) {
      const TS* Ag = A + ((size_t)g * K + k) * N * N;
      for (int j0 = 0; j0 < N; j0 += XJ) {
        const int jn = min(XJ, N - j0);
        if (!whole) stage(g, 1, j0, jn);
        const TA* xg = xs + (whole ? g * LB * XJ : 0);
        for (int c0 = 0; c0 < jn; c0 += S) {
          Raw a[R][U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int c = c0 + (u * 32 + lane) * VEC;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (row0 + r < N && c < jn)
                load_raw(a[r][u], Ag + (size_t)(row0 + r) * N + j0 + c);
              else
                a[r][u] = Raw{};
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int c = c0 + (u * 32 + lane) * VEC;  // < XJ: XJ % S == 0
            if (c >= jn) continue;
#pragma unroll
            for (int b = 0; b < LB; ++b) {
              if (b < B) {
                TA xv[VEC];
                load_xs<TA, VEC>(xg + b * XJ + c, xv);
#pragma unroll
                for (int v = 0; v < VEC; ++v)
#pragma unroll
                  for (int r = 0; r < R; ++r)
                    acc[r][b] = madd(TA(elem(a[r][u], v, (const TS*)nullptr)), xv[v], acc[r][b]);
              }
            }
          }
        }
        if (!whole) __syncthreads();
      }
    }

#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int b = 0; b < LB; ++b)
        if (b < B) acc[r][b] = warp_sum(acc[r][b]);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int b = 0; b < LB; ++b)
        if (b < B && row0 + r < N && lane == ((r * LB + b) & 31))
          y[((size_t)b * K + k) * N + row0 + r] = acc[r][b];
    if constexpr (PD) {
#pragma unroll
      for (int b = 0; b < LB; ++b)
        if (b < B)
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (row0 + r < N)
              rzp[b] = madd(x[((size_t)b * K + k) * N + row0 + r], acc[r][b], rzp[b]);
    }
  }

  if constexpr (PD) {
    __shared__ TA red[WARPS][LB];
    __shared__ bool last;
    if (lane == 0) {
#pragma unroll
      for (int b = 0; b < LB; ++b) red[warp][b] = rzp[b];
    }
    __syncthreads();
    const int chunks = gridDim.x;
    if (threadIdx.x < LB && threadIdx.x < B) {
      TA s = TA(0);
      for (int w = 0; w < WARPS; ++w) s += red[w][threadIdx.x];
      partials[((size_t)threadIdx.x * K + k) * chunks + blockIdx.x] = s;
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&tickets[k], 1u) == (unsigned)(chunks - 1);
    __syncthreads();
    if (last) {
      if (threadIdx.x < LB && threadIdx.x < B) {
        const TA* p = partials + ((size_t)threadIdx.x * K + k) * chunks;
        TA s = TA(0);
        for (int c = 0; c < chunks; ++c) s += __ldcg(p + c);
        rz[(size_t)threadIdx.x * K + k] = s;
      }
      if (threadIdx.x == 0) tickets[k] = 0u;       // ready for the next launch
    }
  }
}

template <typename TS, typename TA, bool VECL, int LB, bool PD>
int launch_stream_cfg(const TS* A, const TA* x, const TA* coef, TA* y, TA* rz,
                      TA* partials, unsigned* tickets, int G, int K, int N, int B,
                      int C, cudaStream_t s) {
  constexpr int VEC = VECL ? 16 / (int)sizeof(TS) : 1;
  constexpr int S = 32 * VEC * stream_unroll(VEC, LB);
  const int NS = (N + S - 1) / S * S;
  size_t bytes = (size_t)G * LB * NS * sizeof(TA);
  int XJ = NS;
  if (bytes > (size_t)XS_WHOLE) {                      // chunked mode
    if (C != 1) return (int)cudaErrorInvalidValue;
    XJ = min(NS, (XS_CHUNK / (LB * (int)sizeof(TA))) / S * S);   // >= S
    bytes = (size_t)LB * XJ * sizeof(TA);
  }
  auto kernel = stream_kernel<TS, TA, VECL, LB, PD>;
  // the 48 KB a launch gets without opting in hold static and dynamic
  // shared memory together: precond_dot's red[][] and flag are static
  // (f64, 16 lanes, N = 384 stages exactly 48 KB of x and was refused)
  constexpr size_t fixed = PD ? sizeof(TA) * STREAM_WARPS * LB + 16 : 0;
  if (bytes + fixed > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  dim3 grid((N + ROWS_PER_BLOCK * C - 1) / (ROWS_PER_BLOCK * C), K);
  kernel<<<grid, 32 * STREAM_WARPS, bytes, s>>>(A, x, coef, y, rz, partials, tickets,
                                                G, K, N, B, XJ, C);
  return (int)cudaGetLastError();
}

template <typename TS, typename TA, bool PD>
int launch_stream(int lanes, int C, const TS* A, const TA* x, const TA* coef, TA* y,
                  TA* rz, TA* partials, unsigned* tickets, int G, int K, int N, int B,
                  cudaStream_t s) {
  if (B > lanes || C < 1) return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(A) && ((size_t)N * sizeof(TS)) % 16 == 0;
#define PYLRBMS_STREAM(V, L) \
  return launch_stream_cfg<TS, TA, V, L, PD>(A, x, coef, y, rz, partials, tickets, G, K, N, B, C, s)
  if (vec) {
    if (lanes == 1) PYLRBMS_STREAM(true, 1);
    if (lanes == 4) PYLRBMS_STREAM(true, 4);
    if (lanes == 16) PYLRBMS_STREAM(true, 16);
  } else {
    if (lanes == 1) PYLRBMS_STREAM(false, 1);
    if (lanes == 4) PYLRBMS_STREAM(false, 4);
    if (lanes == 16) PYLRBMS_STREAM(false, 16);
  }
#undef PYLRBMS_STREAM
  return (int)cudaErrorInvalidValue;
}

// ----------------------------------------------------------------------------
// the split operands of the tensor and ring routes
// ----------------------------------------------------------------------------

// The splits use integer and f32 ops only: the conversion instructions
// (cvt.rn.bf16x2, cvt.rna.tf32) issue at a quarter of the ALU rate and
// bounded the first version of these kernels.

// (v0, v1) -> three bf16x2 terms with hi + mid + lo == (v0, v1) exactly:
// each term is its remainder truncated to bf16 (8 significant bits), each
// subtraction is exact, and the third remainder has at most 8 significant
// bits left of f32's 24.  The low half of a word is v0's term.
__device__ __forceinline__ void split_bf16x3(float v0, float v1, uint32_t& hi,
                                             uint32_t& mid, uint32_t& lo) {
  const uint32_t h0 = __float_as_uint(v0) & 0xffff0000u, h1 = __float_as_uint(v1) & 0xffff0000u;
  const float r0 = v0 - __uint_as_float(h0), r1 = v1 - __uint_as_float(h1);
  const uint32_t m0 = __float_as_uint(r0) & 0xffff0000u, m1 = __float_as_uint(r1) & 0xffff0000u;
  const float s0 = r0 - __uint_as_float(m0), s1 = r1 - __uint_as_float(m1);
  hi = __byte_perm(h0, h1, 0x7632);
  mid = __byte_perm(m0, m1, 0x7632);
  lo = __byte_perm(__float_as_uint(s0), __float_as_uint(s1), 0x7632);
}

// v = big + small (the 3xTF32 split): big = v rounded to the nearest TF32,
// ties away from zero (cvt.rna.tf32.f32), small = the remainder truncated
// to TF32; a_small x_small and small's truncation are ~2^-22 of v
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tensor cores' f32 sums are not rounded as IEEE adds are: they drop
// low bits, and the loss grows with the depth of one accumulation chain.
// So each pipeline stage sums into fresh registers, added to the running
// sum with an IEEE f32 add.
__device__ __forceinline__ void add_stage(float (&acc)[4], const float (&part)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += part[q];
}

// Fragment coordinates (PTX ISA, mma.m16n8k8): grp = lane / 4,
// tig = lane % 4; accumulator c[2h + e] is (row grp + 8h, lane col 2 tig + e).
// The reduction index of a fragment may map to any column, as long as the
// matrix and the vector fragments map it alike: a thread takes its pairs
// from adjacent columns (4 tig .. 4 tig + 3 for tf32), so each fragment row
// is one 16-byte shared-memory read.

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// 16 bytes global -> shared, zero-filled when !valid (src must still be mapped)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING));
}

// ----------------------------------------------------------------------------
// ring route (the stream route's form for 5-16 lanes)
// ----------------------------------------------------------------------------

// A block owns 64 rows x 16 lanes of one subdomain (grid: row tiles, K), 4
// warps of 16 rows x 16 lanes.  Tiles of 32 columns of A and x stream
// through a 3-stage (f64) or 4-stage (f32) cp.async ring in shared memory,
// so no register holds a row's accumulators for 16 lanes; the
// product runs on the tensor cores: f64 as DMMA (mma.m8n8k4.f64, IEEE f64
// multiply-adds), f32 as 3xTF32 as on the tensor route.  The G-sum folds
// into a reduction of depth G N, coef[b,g] x applied as x is read.
//
// Any N whose rows are 16-byte multiples (f64: N even; f32: N % 4 == 0):
// the last stage's columns past N are zero-filled by the copy (A and x
// alike, so their products are exact zeros), and rows past N are masked.
//
// PD: precond_dot (G = 1, no coef).  r is x; the epilogue reads r[b,k,i] for
// its rows again from global memory (L2: the stages held r's columns, not
// its rows).  Each thread sums r z over its two rows, a warp over its 8 row
// groups (shuffles), the 4 warps through shared memory in warp order; the
// block writes partials[b, k, row tile], and the last block of each k
// (found with an integer ticket, which it resets) sums them in row-tile
// order: no float atomics, the same bits every launch.
constexpr int RG_BM = 64, RG_BN = 16, RG_BK = 32, RG_WARPS = 4;

// padded row stride (bytes) of one stage: every quarter warp's 16-byte
// reads (rows grp and grp + 1, columns 4 tig ..) fall on distinct banks
template <typename T>
__host__ __device__ constexpr int ring_row() {
  return RG_BK * (int)sizeof(T) + (sizeof(T) == 8 ? 16 : 64);
}
template <typename T>
__host__ __device__ constexpr int ring_stage() { return (RG_BM + RG_BN) * ring_row<T>(); }
// stages of the ring: resident blocks bound it more than stages in flight
// (PERF.md, the stage A/B), so f64 takes 3 (64 KB, three blocks an SM; 4
// stages leave two, 6 one) and f32 4 (60 KB, three blocks an SM)
template <typename T>
__host__ __device__ constexpr int ring_stages() { return sizeof(T) == 8 ? 3 : 4; }

__device__ __forceinline__ void mma_f64(double& c0, double& c1, double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

__device__ __forceinline__ double comp(const double2& v, int c) { return c == 0 ? v.x : v.y; }

template <typename T, bool PD>
__global__ void __launch_bounds__(32 * RG_WARPS)
stream_ring(const T* __restrict__ A, const T* __restrict__ x, const T* __restrict__ coef,
            T* __restrict__ y, T* __restrict__ rz, T* __restrict__ partials,
            unsigned* __restrict__ tickets, int G, int K, int N, int B) {
  constexpr int ROW = ring_row<T>(), STAGE = ring_stage<T>(), STAGES = ring_stages<T>();
  constexpr int EV = 16 / (int)sizeof(T);            // elements per 16-byte copy
  constexpr bool F64 = std::is_same<T, double>::value;
  using V = typename std::conditional<F64, double2, float4>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int i0 = blockIdx.x * RG_BM, k = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int steps = (N + RG_BK - 1) / RG_BK, T_ALL = G * steps;

  // stage rows 0..63: A rows i0 ..; rows 64..79: the 16 lanes of x.  A copy
  // past N (rows or columns) or past B reads a mapped address and fills zeros
  auto load_stage = [&](int t) {
    const int g = t / steps, j0 = (t - g * steps) * RG_BK;
    unsigned char* S = smem + (t % STAGES) * STAGE;
    const T* Ag = A + ((size_t)g * K + k) * N * N;
    for (int e = threadIdx.x; e < (RG_BM + RG_BN) * (RG_BK / EV); e += 32 * RG_WARPS) {
      const int r = e / (RG_BK / EV), c = (e % (RG_BK / EV)) * EV, j = j0 + c;
      const bool in = j < N;
      const int js = in ? j : N - EV;
      if (r < RG_BM) {
        const int i = i0 + r;
        cp_async16(S + r * ROW + c * (int)sizeof(T), Ag + (size_t)min(i, N - 1) * N + js,
                   in && i < N);
      } else {
        const int b = r - RG_BM;
        cp_async16(S + r * ROW + c * (int)sizeof(T),
                   x + ((size_t)min(b, B - 1) * K + k) * N + js, in && b < B);
      }
    }
  };

  // f64: [m8 tile][2 n8 tile + e]; f32 (one m16 tile): [n8 tile][c0..c3]
  T acc[2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = T(0);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < T_ALL) load_stage(s);
    cp_async_commit();
  }
  for (int t = 0; t < T_ALL; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                                   // stage t landed; t - 1 consumed
    if (t + STAGES - 1 < T_ALL) load_stage(t + STAGES - 1);
    cp_async_commit();
    const int g = t / steps;
    const unsigned char* As = smem + (t % STAGES) * STAGE;
    const unsigned char* Xs = As + RG_BM * ROW;
    T cg[2];
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int b = ni * 8 + grp;
      cg[ni] = (coef != nullptr && b < B) ? __ldg(coef + (size_t)b * G + g) : T(1);
    }
    float stage_acc[2][4] = {};                        // f32: this stage's sums
    // a thread reads columns 16 d + 4 tig .. + 3 of its rows (A) and lanes
    // (x); the fragments map their reduction index to those columns alike
#pragma unroll
    for (int d = 0; d < RG_BK / 16; ++d) {
      const int col = (16 * d + 4 * tig) * (int)sizeof(T);
      if constexpr (F64) {
        V a[2][2], xv[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            a[mi][h] = *reinterpret_cast<const V*>(As + (warp * 16 + mi * 8 + grp) * ROW + col + 16 * h);
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
            xv[ni][h] = *reinterpret_cast<const V*>(Xs + (ni * 8 + grp) * ROW + col + 16 * h);
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {                  // four k4 steps
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            const double bx = cg[ni] * comp(xv[ni][s >> 1], s & 1);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              mma_f64(acc[mi][2 * ni], acc[mi][2 * ni + 1], comp(a[mi][s >> 1], s & 1), bx);
          }
        }
      } else {
        V a[2], xv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[h] = *reinterpret_cast<const V*>(As + (warp * 16 + grp + 8 * h) * ROW + col);
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          xv[ni] = *reinterpret_cast<const V*>(Xs + (ni * 8 + grp) * ROW + col);
#pragma unroll
        for (int s = 0; s < 2; ++s) {                  // two k8 steps
          uint32_t ab[4], as[4];
          split_tf32(comp(a[0], 2 * s), ab[0], as[0]);
          split_tf32(comp(a[1], 2 * s), ab[1], as[1]);
          split_tf32(comp(a[0], 2 * s + 1), ab[2], as[2]);
          split_tf32(comp(a[1], 2 * s + 1), ab[3], as[3]);
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            uint32_t xb0, xs0, xb1, xs1;
            split_tf32(cg[ni] * comp(xv[ni], 2 * s), xb0, xs0);
            split_tf32(cg[ni] * comp(xv[ni], 2 * s + 1), xb1, xs1);
            mma_tf32(stage_acc[ni], as, xb0, xb1);     // small terms first
            mma_tf32(stage_acc[ni], ab, xs0, xs1);
            mma_tf32(stage_acc[ni], ab, xb0, xb1);
          }
        }
      }
    }
    if constexpr (!F64) {
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) add_stage(acc[ni], stage_acc[ni]);
    }
  }
  cp_async_wait<0>();

  // f64: c[e] of (mi, ni) is (row 8 mi + grp, lane 8 ni + 2 tig + e);
  // f32: c[2 h + e] of ni is (row grp + 8 h, lane 8 ni + 2 tig + e)
  T part[2][2] = {};                                   // PD: r z over this thread's rows
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + warp * 16 + 8 * p + grp, b = ni * 8 + 2 * tig + e;
        const T v = F64 ? acc[p][2 * ni + e] : acc[ni][2 * p + e];
        if (i < N && b < B) {
          const size_t o = ((size_t)b * K + k) * N + i;
          y[o] = v;
          if constexpr (PD) part[ni][e] = madd(x[o], v, part[ni][e]);
        }
      }
  if constexpr (PD) {
    __shared__ T red[RG_WARPS][RG_BN];
    __shared__ bool last;
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        T v = part[ni][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (grp == 0) red[warp][ni * 8 + 2 * tig + e] = v;
      }
    __syncthreads();
    const int tiles = gridDim.x;
    if (threadIdx.x < RG_BN && (int)threadIdx.x < B) {
      T s = T(0);
#pragma unroll
      for (int w = 0; w < RG_WARPS; ++w) s += red[w][threadIdx.x];
      partials[((size_t)threadIdx.x * K + k) * tiles + blockIdx.x] = s;
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&tickets[k], 1u) == (unsigned)(tiles - 1);
    __syncthreads();
    if (last) {
      if (threadIdx.x < RG_BN && (int)threadIdx.x < B) {
        const T* p = partials + ((size_t)threadIdx.x * K + k) * tiles;
        T s = T(0);
        for (int c = 0; c < tiles; ++c) s += __ldcg(p + c);
        rz[(size_t)threadIdx.x * K + k] = s;
      }
      if (threadIdx.x == 0) tickets[k] = 0u;           // ready for the next launch
    }
  }
}

// refuses (cudaErrorInvalidValue) what the ring does not take: more than 16
// lanes, rows that are no 16-byte multiple, misaligned A or x, and
// precond_dot without its scratch
template <typename T, bool PD>
int launch_ring(const T* A, const T* x, const T* coef, T* y, T* rz, T* partials,
                unsigned* tickets, int G, int K, int N, int B, cudaStream_t s) {
  if (B < 1 || B > RG_BN || ((size_t)N * sizeof(T)) % 16 != 0 || !aligned16(A) ||
      !aligned16(x) || (PD && (partials == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int bytes = ring_stages<T>() * ring_stage<T>();
  auto kernel = stream_ring<T, PD>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  dim3 grid((N + RG_BM - 1) / RG_BM, K);
  kernel<<<grid, 32 * RG_WARPS, bytes, s>>>(A, x, coef, y, rz, partials, tickets, G, K, N, B);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------------
// dmma route (f64 vectors at many lanes: f64 x f64 and bf16 x f64)
// ----------------------------------------------------------------------------

// A block owns BM rows x LB lanes of one subdomain (grid: lane tiles, row
// tiles, K; 64 or 32 rows x 64 or 32 lanes, plan() picks them by the block
// count) with 4 warps of WM rows x WN lanes.  The depth (G N columns of [A_0 |
// A_1 | ...] against [coef_0 x; coef_1 x; ...]) streams through a ring of S
// stages of 16-column tiles of A and x, each filled by two TMA tensor copies
// (a 3-D box of A [g k, rows, columns] and of x [lanes, k, columns]) that
// one thread issues and an mbarrier counts; the hardware zero-fills rows,
// columns and lanes past the ends.  f64 tiles are 128-byte rows with the
// 128-byte swizzle (16-byte fragment reads on distinct banks), bf16 A
// 32-byte rows widened exactly to f64 when the fragment is built.  The
// product runs on the f64 tensor cores (mma.sync: wgmma has no f64 form)
// into f64 accumulators in registers.  Misaligned operands, or rows whose
// byte length is no multiple of 16, fill the same layout with scalar loads.
// precond_dot's rz goes through per-row-tile partials and a ticket per (k,
// lane tile), as on the tensor route.
//
// The f64 mma shape is m16n8k8 (PTX ISA 7.8 adds m16n8k4/k8/k16 on sm_90
// beside the ring's m8n8k4; PERF.md has the A/B: m8n8k4 runs at half the
// f64 tensor rate on the H100, m16n8k16 needs twice the fragment registers).
// A thread's fragments take columns 4 tig .. 4 tig + 3 of the stage, two a
// k8 step (one 16-byte shared-memory read a row).
constexpr int DM_M = 16;                            // rows of one mma
constexpr int DM_BK = 16;                           // columns a stage
constexpr int DM_STAGES = 4, DM_WARPS = 4;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// waits for the phase of the given parity; traps (a launch error, not a
// hang) if it never completes
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (long n = 0; !done; ++n) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (n > (1l << 22)) __trap();
  }
}
// one box of a 3-D tensor map into shared memory, counted on bar
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_u32(bar))
      : "memory");
}

// bytes of one stage row, and the byte offset of element (r, c) of a stage
// tile: f64 rows with the 128-byte swizzle (16-byte chunk c / 2 of row r at
// chunk c / 2 ^ r % 8, as TMA writes it), bf16 rows plain
template <typename T>
__host__ __device__ constexpr int dm_row() { return DM_BK * (int)sizeof(T); }
template <typename T>
__device__ __forceinline__ int dm_off(int r, int c) {
  return sizeof(T) == 8 ? r * 128 + ((c * 8) ^ ((r & 7) << 4)) : r * dm_row<T>() + c * 2;
}
template <typename TS, int BM, int LB>
__host__ __device__ constexpr int dm_stage() { return BM * dm_row<TS>() + LB * dm_row<double>(); }

__device__ __forceinline__ void mma_f64_m16n8k8(double (&c)[4], const double (&a)[4],
                                                double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// elements (r, c) and (r, c + 1) of a stage tile (c even), widened to f64
__device__ __forceinline__ void load_pair(const unsigned char* t, int r, int c, double (&v)[2],
                                          const double*) {
  const double2 w = *reinterpret_cast<const double2*>(t + dm_off<double>(r, c));
  v[0] = w.x, v[1] = w.y;
}
__device__ __forceinline__ void load_pair(const unsigned char* t, int r, int c, double (&v)[2],
                                          const __nv_bfloat16*) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(t + dm_off<__nv_bfloat16>(r, c));
  v[0] = __uint_as_float(w << 16), v[1] = __uint_as_float(w & 0xffff0000u);  // exact
}

template <typename TS, int BM, int LB, bool PD>
__global__ void __launch_bounds__(32 * DM_WARPS)
dmma_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmx,
            const TS* __restrict__ A, const double* __restrict__ x,
            const double* __restrict__ coef, double* __restrict__ y,
            double* __restrict__ rz, double* __restrict__ partials,
            unsigned* __restrict__ tickets, int G, int K, int N, int B, int vec) {
  constexpr int S = DM_STAGES, W = DM_WARPS;
  // warp tile: 32 x 32 at 64 x 64, else 16 rows x 32 or 16 lanes
  constexpr int WN = (LB == 64 || BM == 64) ? 32 : 16;
  constexpr int WC = LB / WN, WR = W / WC, WM = BM / WR;
  constexpr int MT = WM / DM_M, NT = WN / 8;          // m tiles, n8 tiles of a warp
  constexpr int ABYTES = BM * dm_row<TS>(), STAGE = dm_stage<TS, BM, LB>();
  static_assert(WM % DM_M == 0 && WR * WC == W, "dmma warp tiling");
  static_assert(ABYTES % 1024 == 0 && STAGE % 1024 == 0, "swizzled tiles on 1024-byte bounds");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ uint64_t full[S];
  const int n0 = blockIdx.x * LB, i0 = blockIdx.y * BM, k = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wr = warp / WC, wc = warp % WC;
  const int steps = (N + DM_BK - 1) / DM_BK, T_ALL = G * steps;

  // stage t: A rows i0 .. of matrix g, then the LB lanes of x, columns j0 ..
  // j0 + 15, zero past N, past the last row and past B.  TMA: one thread,
  // counted on full[t % S]; scalar: every thread, seen after the next
  // __syncthreads
  auto load_stage = [&](int t) {
    const int g = t / steps, j0 = (t - g * steps) * DM_BK;
    unsigned char* As = smem + (t % S) * STAGE;
    unsigned char* Xs = As + ABYTES;
    if (vec) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(&full[t % S], STAGE);
        tma_3d(As, &tma, j0, i0, g * K + k, &full[t % S]);
        tma_3d(Xs, &tmx, j0, k, n0, &full[t % S]);
      }
      return;
    }
    const TS* Ag = A + ((size_t)g * K + k) * N * N;
    for (int e = threadIdx.x; e < BM * DM_BK; e += 32 * W) {
      const int r = e / DM_BK, c = e % DM_BK, i = i0 + r, j = j0 + c;
      *reinterpret_cast<TS*>(As + dm_off<TS>(r, c)) =
          (i < N && j < N) ? Ag[(size_t)i * N + j] : TS{};
    }
    for (int e = threadIdx.x; e < LB * DM_BK; e += 32 * W) {
      const int l = e / DM_BK, c = e % DM_BK, b = n0 + l, j = j0 + c;
      *reinterpret_cast<double*>(Xs + dm_off<double>(l, c)) =
          (b < B && j < N) ? x[((size_t)b * K + k) * N + j] : 0.0;
    }
  };

  // acc[mt][nt][2 h + e]: row 8 h + grp of m tile mt, lane 2 tig + e of n8 tile nt
  double acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0;

  if (vec && threadIdx.x == 0) {
    for (int q = 0; q < S; ++q) mbar_init(&full[q], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < S - 1 && s < T_ALL; ++s) load_stage(s);
  for (int t = 0; t < T_ALL; ++t) {
    if (vec) mbar_wait(&full[t % S], (t / S) & 1);
    __syncthreads();                                   // stage t landed; t - 1 consumed
    if (t + S - 1 < T_ALL) load_stage(t + S - 1);
    const int g = t / steps;
    const unsigned char* As = smem + (t % S) * STAGE;
    const unsigned char* Xs = As + ABYTES;
    double cg[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int b = n0 + wc * WN + nt * 8 + grp;
      cg[nt] = (coef != nullptr && b < B) ? __ldg(coef + (size_t)b * G + g) : 1.0;
    }
    // k8 step f reads columns c0 = 4 tig + 2 f and c0 + 1 of its rows (A)
    // and lanes (x): reduction slots tig and tig + 4 of the mma.  MT x NT
    // independent mmas between two on one accumulator
#pragma unroll
    for (int f = 0; f < DM_BK / 8; ++f) {
      const int col = 4 * tig + 2 * f;
      double a[MT][2][2], bx[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          load_pair(As, wr * WM + mt * DM_M + 8 * h + grp, col, a[mt][h], (const TS*)nullptr);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        load_pair(Xs, wc * WN + nt * 8 + grp, col, bx[nt], (const double*)nullptr);
        if (coef != nullptr) bx[nt][0] *= cg[nt], bx[nt][1] *= cg[nt];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const double af[4] = {a[mt][0][0], a[mt][1][0], a[mt][0][1], a[mt][1][1]};
          mma_f64_m16n8k8(acc[mt][nt], af, bx[nt][0], bx[nt][1]);
        }
    }
  }

  double part[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) part[nt][0] = part[nt][1] = 0.0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + wr * WM + mt * DM_M + 8 * (q >> 1) + grp;
        const int b = n0 + wc * WN + nt * 8 + 2 * tig + (q & 1);
        if (i < N && b < B) {
          const size_t o = ((size_t)b * K + k) * N + i;
          y[o] = acc[mt][nt][q];
          if constexpr (PD) part[nt][q & 1] = fma(x[o], acc[mt][nt][q], part[nt][q & 1]);
        }
      }
  if constexpr (PD) {
    // over the 8 row groups of a warp (lanes of equal tig), the row warps,
    // then the row tiles
    __shared__ double red[W][WN];
    __shared__ bool last;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        double v = part[nt][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (grp == 0) red[warp][nt * 8 + 2 * tig + e] = v;
      }
    __syncthreads();
    const int tiles = gridDim.y;
    const unsigned ticket = blockIdx.x * K + k;
    if (threadIdx.x < LB) {
      const int l = threadIdx.x, b = n0 + l;
      if (b < B) {
        double s = 0.0;
        for (int w = 0; w < WR; ++w) s += red[w * WC + l / WN][l % WN];
        partials[((size_t)b * K + k) * tiles + blockIdx.y] = s;
        __threadfence();
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&tickets[ticket], 1u) == (unsigned)(tiles - 1);
    __syncthreads();
    if (last) {
      if (threadIdx.x < LB && n0 + (int)threadIdx.x < B) {
        const int b = n0 + threadIdx.x;
        const double* p = partials + ((size_t)b * K + k) * tiles;
        double s = 0.0;
        for (int c = 0; c < tiles; ++c) s += __ldcg(p + c);
        rz[(size_t)b * K + k] = s;
      }
      if (threadIdx.x == 0) tickets[ticket] = 0u;       // ready for the next launch
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link to libcuda)
typedef CUresult (*TmapEncode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                               const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                               const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                               CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
TmapEncode tmap_encode() {
  static const TmapEncode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<TmapEncode>(p);
  }();
  return fn;
}

// a 3-D tensor map: dims {d0 (contiguous), d1, d2}, byte strides of d1 and
// d2, box {b0, b1, b2}; elements past the dims read as zero
bool tmap_3d(CUtensorMap* m, const void* base, CUtensorMapDataType dt, cuuint64_t d0,
             cuuint64_t d1, cuuint64_t d2, cuuint64_t s1, cuuint64_t s2, cuuint32_t b0,
             cuuint32_t b1, cuuint32_t b2, bool swizzle) {
  const TmapEncode enc = tmap_encode();
  const cuuint64_t dims[3] = {d0, d1, d2}, strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, b2}, one[3] = {1, 1, 1};
  return enc != nullptr &&
         enc(m, dt, 3, const_cast<void*>(base), dims, strides, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TS, int BM, int LB, bool PD>
int launch_dmma_cfg(const TS* A, const double* x, const double* coef, double* y, double* rz,
                    double* partials, unsigned* tickets, int G, int K, int N, int B,
                    cudaStream_t s) {
  const int vec = aligned16(A) && aligned16(x) && ((size_t)N * sizeof(TS)) % 16 == 0 &&
                  N % 2 == 0;
  CUtensorMap ta{}, tx{};                             // A [G K, N, N], x [B, K, N]
  constexpr bool F64 = sizeof(TS) == 8;
  if (vec && !(tmap_3d(&ta, A, F64 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       N, N, (cuuint64_t)G * K, (cuuint64_t)N * sizeof(TS),
                       (cuuint64_t)N * N * sizeof(TS), DM_BK, BM, 1, F64) &&
               tmap_3d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, N, K, B, (cuuint64_t)N * 8,
                       (cuuint64_t)K * N * 8, DM_BK, 1, LB, true)))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = DM_STAGES * dm_stage<TS, BM, LB>() + 1024;  // + 1024-byte alignment
  auto kernel = dmma_kernel<TS, BM, LB, PD>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  dim3 grid((B + LB - 1) / LB, (N + BM - 1) / BM, K);
  kernel<<<grid, 32 * DM_WARPS, bytes, s>>>(ta, tx, A, x, coef, y, rz, partials, tickets, G, K, N, B,
                                     vec);
  return (int)cudaGetLastError();
}

// lanes: 32 or 64 lanes a block; chunks: 1 or 2 32-row chunks a block
// (plan() in ops/hopper_kernels.py picks them)
template <typename TS, bool PD>
int launch_dmma(int lanes, int chunks, const TS* A, const double* x, const double* coef,
                double* y, double* rz, double* partials, unsigned* tickets, int G, int K, int N,
                int B, cudaStream_t s) {
  if (PD && (partials == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
#define PYLRBMS_DMMA(BM, LB) \
  return launch_dmma_cfg<TS, BM, LB, PD>(A, x, coef, y, rz, partials, tickets, G, K, N, B, s)
  if (chunks == 2 && lanes == 64) PYLRBMS_DMMA(64, 64);
  if (chunks == 2 && lanes == 32) PYLRBMS_DMMA(64, 32);
  if (chunks == 1 && lanes == 64) PYLRBMS_DMMA(32, 64);
  if (chunks == 1 && lanes == 32) PYLRBMS_DMMA(32, 32);
#undef PYLRBMS_DMMA
  return (int)cudaErrorInvalidValue;
}

// ----------------------------------------------------------------------------
// tensor route (f32 vectors at many lanes: bf16 x f32 precond_dot, f32 x f32
// block_matvec; wgmma + TMA)
// ----------------------------------------------------------------------------

// A block owns BM = 128 rows x BN = 32 or 128 lanes of one subdomain
// (grid: lane tiles, row tiles, K): two consumer warpgroups of 64 rows each
// and one producer warp.  The producer's lane 0 keeps a ring of S stages in flight,
// two TMA boxes a stage: 128-byte rows of the matrix (32 f32 columns of A
// or 64 bf16 columns of F, rows i0 .., 128-byte swizzle) and the same
// columns of the BN lanes of the vector (x swizzled alike; r plain,
// 256-byte rows), counted on the stage's full barrier.  The hardware
// zero-fills rows, columns and lanes past the ends, so every product with
// them is an exact zero.  The consumers release a stage on its empty
// barrier once the wgmmas that read it are done.  What bounds the route is
// that ring (PERF.md): with no wgmma issued at all the serving
// shapes take 0.55-0.8 of their time, and neither fewer bytes (a cluster
// multicasting A, x loaded once for both G matrices), nor more in flight (a
// ring of raw tiles released at the split, the planes beside it), nor a
// persistent grid made them faster by more than a few percent.
//
// The consumers split each stage once, element by element, into
// shared-memory planes in the 128-byte swizzled layout the descriptors read
// (block_matvec: coef[b,g] x into big over its raw tile in place and small
// beside it; precond_dot: r into three bf16 planes, hi and mid over r's raw
// tile, lo beside it, after every raw value is read), fence them to the
// async proxy and meet at a named barrier; then each warpgroup issues its
// 64-row products and commits them as one group, and waits for the group
// before it (one stage of wgmmas in flight while the next is split):
//  * block_matvec: wgmma m64nBNk8 tf32, per k8 step a_small x_big, a_big
//    x_small, a_big x_big (small terms first), A's fragment in registers
//    (each thread reads and splits its own);
//  * precond_dot: wgmma m64nBNk16 bf16 with F's tile as TMA left it, per
//    k16 step F r_lo, F r_mid, F r_hi.
// The async wgmma reads register operands after the code that follows has
// run: the fragments of two stages are held and each is kept alive (an
// empty asm that reads and writes it) until the wait that retires its
// wgmmas; without that the next stage reused the registers first (PERF.md:
// wrong rows from the second warp on).  Below TC_A_INFLIGHT_LANES lanes
// each stage's wgmmas are waited for instead (faster there: the products
// are short).  One accumulation chain over the depth (G N for
// block_matvec): summing each stage apart with IEEE f32 adds was slower
// and not needed for the tolerance (PERF.md).  The epilogue stages the
// accumulators through shared memory (the ring is free by then) and writes
// y or z as 16-byte rows, 16 threads a lane's 64 rows; precond_dot's rz takes r's rows of the
// block from the registers each thread kept when it split the stages
// holding them (the same chunks it writes), sums its chunks, then a lane's
// 16 threads (shuffles), into a partial per (lane, k, row tile); the last
// block of each (k, lane tile), found with an integer ticket that it
// resets, sums them in row-tile order.
constexpr int TC_SMEM = 227 * 1024 - 2048;   // dynamic shared memory a block may take
constexpr int TC_MAX_STAGES = 4;             // most stages in the ring
constexpr int TC_A_INFLIGHT_LANES = 128;     // block_matvec: a stage in flight from these lanes
constexpr int TC_NWG = 2;                    // consumer warpgroups a block (64 rows each)
// the consumers' named barrier: 0 is the block-wide one the producer meets
constexpr int TC_CONSUMER_BAR = 1;

template <int BN, bool PD>
struct TcLayout {
  static constexpr int NWG = TC_NWG;
  static constexpr int BM = 64 * NWG;                   // rows a block
  static constexpr int BK = PD ? 64 : 32;               // depth columns a stage (128-byte rows)
  static constexpr int NC = 128 * NWG;                  // consumer threads
  static constexpr int MAT = BM * 128;                  // matrix tile
  static constexpr int VEC = BN * (PD ? 256 : 128);     // vector: x -> x_big | r -> hi, mid
  static constexpr int LOW = BN * 128;                  // x_small | r lo
  static constexpr int STAGE = MAT + VEC + LOW;
  static constexpr int S0 = TC_SMEM / STAGE;
  static constexpr int STAGES = S0 < TC_MAX_STAGES ? S0 : TC_MAX_STAGES;
  static constexpr int OSTRIDE = BM + 4;                // staged outputs: [BN][BM + 4] f32
  static constexpr int PER = BN * 16 / NC;              // 16-byte chunks a thread: [BN][64] f32
  static constexpr int BYTES = STAGES * STAGE + 1024;   // + 1024-byte alignment
  static_assert(STAGES >= 2, "tensor route: two stages must fit");
  static_assert(BN * OSTRIDE * 4 <= STAGES * STAGE, "tensor route: outputs staged in the ring");
  static_assert(STAGE % 1024 == 0 && MAT % 1024 == 0 && VEC % 1024 == 0,
                "swizzled tiles on 1024-byte bounds");
};

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows and
// the 128-byte swizzle: 8-row groups 1024 bytes apart (stride byte offset
// 64 x 16); the leading byte offset is unused for this layout.  A k step
// inside the 128-byte row advances the start address (32 bytes a k8 tf32 or
// k16 bf16 step); the swizzle is a function of the address, as TMA wrote it.
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING) : "memory");
}
// the accumulators are written by the async wgmmas: pin them across
template <int R>
__device__ __forceinline__ void wg_pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
// generic-proxy writes of shared memory (the split planes) before the async
// proxy (wgmma) reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// m64 x BN wgmma (BN = 32, 128): tf32 with A in registers, bf16 with
// both operands by descriptor; d[4 j + q] is row grp + 8 (q >> 1) of the
// warp's 16, lane 8 j + 2 tig + (q & 1)
template <int BN>
struct Wg;

template <>
struct Wg<32> {
  static __device__ __forceinline__ void tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                              int scale) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
        ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
  static __device__ __forceinline__ void bf16(float (&d)[16], uint64_t a, uint64_t b, int scale) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct Wg<128> {
  static __device__ __forceinline__ void tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                              int scale) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63}"
        ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
  static __device__ __forceinline__ void bf16(float (&d)[64], uint64_t a, uint64_t b, int scale) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63}"
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale));
  }
};

// byte offset of element c of a 16-byte chunk row r in a tile of 128-byte
// rows with the 128-byte swizzle (chunk c / (16 / size) at chunk ^ r % 8)
template <int SIZE>
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((((c * SIZE) >> 4) ^ (r & 7)) << 4) + ((c * SIZE) & 15);
}

template <int BN, bool PD>
__global__ void __launch_bounds__(128 * TC_NWG + 32)
tensor_kernel(const __grid_constant__ CUtensorMap tmm, const __grid_constant__ CUtensorMap tmv,
              const float* __restrict__ coef, float* __restrict__ out, float* __restrict__ rz,
              float* __restrict__ partials, unsigned* __restrict__ tickets, int G, int K, int N,
              int B) {
  using L = TcLayout<BN, PD>;
  constexpr int S = L::STAGES, NC = L::NC, BM = L::BM, BK = L::BK, R = BN / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ uint64_t full[S], empty[S];
  __shared__ bool last;
  const int n0 = blockIdx.x * BN, i0 = blockIdx.y * BM, k = blockIdx.z;
  const int steps = (N + BK - 1) / BK, T = G * steps;

  if (threadIdx.x == 0) {
    for (int q = 0; q < S; ++q) mbar_init(&full[q], 1), mbar_init(&empty[q], NC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[R];
#pragma unroll
  for (int q = 0; q < R; ++q) acc[q] = 0.f;
  // precond_dot: r's rows of the block, kept from the stages whose columns
  // they are (thread-owned chunks [lane q / 16][4 (q % 16) ..] of 64 rows)
  float4 rr[PD ? BM / 64 : 1][PD ? L::PER : 1];
  if (threadIdx.x >= NC) {                             // producer warp: lane 0 issues
    if (threadIdx.x == NC) {
      for (int t = 0; t < T; ++t) {
        const int s = t % S, g = t / steps, j0 = (t - g * steps) * BK;
        if (t >= S) mbar_wait(&empty[s], (t / S - 1) & 1);
        unsigned char* st = smem + s * L::STAGE;
        mbar_expect_tx(&full[s], L::MAT + BN * BK * 4);
        tma_3d(st, &tmm, j0, i0, g * K + k, &full[s]);
        tma_3d(st + L::MAT, &tmv, j0, k, n0, &full[s]);
      }
    }
  } else {                                             // consumer warpgroups
    const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int grp = lane >> 2, tig = lane & 3;
    // block_matvec: a stage in flight at BN >= TC_A_INFLIGHT_LANES (A's
    // fragments of two stages held), else each stage's wgmmas waited for
    constexpr bool INFLIGHT = PD || BN >= TC_A_INFLIGHT_LANES;
    uint32_t abuf[2][4][4], asbuf[2][4][4];            // A's fragments, big / small
    auto consume = [&](auto parity, int t) {
      constexpr int u = decltype(parity)::value;
      uint32_t (&ab)[4][4] = abuf[u];
      uint32_t (&as)[4][4] = asbuf[u];
      const int s = t % S, g = t / steps, j0 = (t - g * steps) * BK;
      unsigned char* st = smem + s * L::STAGE;
      constexpr int LOW = L::LOW;
      unsigned char* V = st + L::MAT;                  // x_big | r raw, then hi and mid
      unsigned char* W = V + L::VEC;                   // x_small | lo
      mbar_wait(&full[s], (t / S) & 1);
      if constexpr (PD) {
        // r [BN][64] f32 -> three bf16 planes [BN][64] (swizzled); every raw
        // value is read before the planes overwrite the tile
        constexpr int PER = L::PER;
        float4 v[PER];
#pragma unroll
        for (int p = 0; p < PER; ++p)
          v[p] = reinterpret_cast<const float4*>(V)[threadIdx.x + p * NC];
#pragma unroll
        for (int h = 0; h < BM / 64; ++h)
          if (j0 == i0 + 64 * h)                       // these columns are rows of the block
#pragma unroll
            for (int p = 0; p < PER; ++p) rr[h][p] = v[p];
        named_bar(TC_CONSUMER_BAR, NC);
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const int q = threadIdx.x + p * NC, l = q >> 4, c = (q & 15) * 4;
          uint32_t h0, m0, l0, h1, m1, l1;
          split_bf16x3(v[p].x, v[p].y, h0, m0, l0);
          split_bf16x3(v[p].z, v[p].w, h1, m1, l1);
          const int o = sw128<2>(l, c);
          *reinterpret_cast<uint2*>(V + o) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(V + LOW + o) = make_uint2(m0, m1);
          *reinterpret_cast<uint2*>(W + o) = make_uint2(l0, l1);
        }
      } else {
        // coef[b, g] x -> big (in place) / small, element by element (the
        // layout is TMA's swizzled one on both sides), and A's fragments
        constexpr int PER = BN * 8 / NC;
        const float4* X = reinterpret_cast<const float4*>(V);
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const int q = threadIdx.x + p * NC, b = n0 + (q >> 3);
          const float cg = coef == nullptr ? 1.f : b < B ? __ldg(coef + (size_t)b * G + g) : 0.f;
          const float4 v = X[q];
          uint4 big, small;
          split_tf32(cg * v.x, big.x, small.x);
          split_tf32(cg * v.y, big.y, small.y);
          split_tf32(cg * v.z, big.z, small.z);
          split_tf32(cg * v.w, big.w, small.w);
          reinterpret_cast<uint4*>(V)[q] = big;
          reinterpret_cast<uint4*>(W)[q] = small;
        }
        const unsigned char* At = st + wg * 64 * 128;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * w + grp + 8 * (e & 1), c = 8 * ks + tig + 4 * (e >> 1);
            split_tf32(*reinterpret_cast<const float*>(At + sw128<4>(r, c)), ab[ks][e], as[ks][e]);
          }
      }
      fence_proxy_async();
      named_bar(TC_CONSUMER_BAR, NC);
      // one stage of products: three per k step, small terms first
      auto issue = [&](float (&d)[R]) {
        wg_pin(d);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if constexpr (PD) {
            const uint64_t fa = wg_desc(st + wg * 64 * 128 + 32 * ks);
            Wg<BN>::bf16(d, fa, wg_desc(W + 32 * ks), 1);
            Wg<BN>::bf16(d, fa, wg_desc(V + LOW + 32 * ks), 1);
            Wg<BN>::bf16(d, fa, wg_desc(V + 32 * ks), 1);
          } else {
            Wg<BN>::tf32(d, as[ks], wg_desc(V + 32 * ks), 1);
            Wg<BN>::tf32(d, ab[ks], wg_desc(W + 32 * ks), 1);
            Wg<BN>::tf32(d, ab[ks], wg_desc(V + 32 * ks), 1);
          }
        }
        wg_commit();
        wg_pin(d);
      };
      if constexpr (!INFLIGHT) {
        issue(acc);                                    // A's fragments are registers: no
        wg_wait<0>();                                  // product stays in flight past them
        wg_pin(acc);
        mbar_arrive(&empty[s]);
      } else {
        issue(acc);
        wg_wait<1>();                                  // stage t - 1's products are done
        wg_pin(acc);
        if constexpr (!PD) {                           // its fragments were live until here
#pragma unroll
          for (int i = 0; i < 16; ++i)
            asm volatile("" : "+r"(abuf[1 - u][i / 4][i % 4]), "+r"(asbuf[1 - u][i / 4][i % 4])
                         :: "memory");
        }
        if (t > 0) mbar_arrive(&empty[(t - 1) % S]);
      }
    };
    for (int t = 0; t < T; t += 2) {
      consume(std::integral_constant<int, 0>{}, t);
      if (t + 1 < T) consume(std::integral_constant<int, 1>{}, t + 1);
    }
    wg_wait<0>();
    wg_pin(acc);
  }
  __syncthreads();                                     // every stage consumed: the ring is free

  // outputs [BN][BM] through shared memory, written as 16-byte rows
  float* O = reinterpret_cast<float*>(smem);
  if (threadIdx.x < NC) {
    const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int row = 64 * wg + 16 * w + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        O[(8 * j + col + (q & 1)) * L::OSTRIDE + row + 8 * (q >> 1)] = acc[4 * j + q];
  }
  __syncthreads();
  // each thread writes 16-byte chunks [lane q / 16][64 h + 4 (q % 16) ..]:
  // 16 threads a lane's 64 rows (256 contiguous bytes); precond_dot sums r z
  // over its chunks in h order, then over the lane's 16 threads (shuffles)
  if (threadIdx.x < NC) {
#pragma unroll
    for (int p = 0; p < L::PER; ++p) {
      const int q = threadIdx.x + p * NC, l = q >> 4, c = 4 * (q & 15), b = n0 + l;
      float part = 0.f;
#pragma unroll
      for (int h = 0; h < BM / 64; ++h) {
        const int i = i0 + 64 * h + c;
        const float4 v = *reinterpret_cast<const float4*>(O + l * L::OSTRIDE + 64 * h + c);
        if (b < B && i < N) {
          *reinterpret_cast<float4*>(out + ((size_t)b * K + k) * N + i) = v;
          if constexpr (PD) {
            const float4 r = rr[h][p];
            part = fmaf(r.w, v.w, fmaf(r.z, v.z, fmaf(r.y, v.y, fmaf(r.x, v.x, part))));
          }
        }
      }
      if constexpr (PD) {
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if ((q & 15) == 0 && b < B) partials[((size_t)b * K + k) * gridDim.y + blockIdx.y] = part;
      }
    }
  }
  if constexpr (PD) {
    __threadfence();
    __syncthreads();
    const int tiles = gridDim.y;
    const unsigned ticket = blockIdx.x * K + k;
    if (threadIdx.x == 0) last = atomicAdd(&tickets[ticket], 1u) == (unsigned)(tiles - 1);
    __syncthreads();
    if (last) {
      if (threadIdx.x < BN && n0 + (int)threadIdx.x < B) {
        const int b = n0 + threadIdx.x;
        const float* p = partials + ((size_t)b * K + k) * tiles;
        float s = 0.f;
        for (int c = 0; c < tiles; ++c) s += __ldcg(p + c);
        rz[(size_t)b * K + k] = s;
      }
      if (threadIdx.x == 0) tickets[ticket] = 0u;     // ready for the next launch
    }
  }
}

template <int BN, bool PD>
int launch_tensor_cfg(const void* M, const float* v, const float* coef, float* out, float* rz,
                      float* partials, unsigned* tickets, int G, int K, int N, int B,
                      cudaStream_t s) {
  using L = TcLayout<BN, PD>;
  CUtensorMap tm{}, tv{};   // matrix [G K, N, N] (bf16 F: [K, N, N]), vector [B, K, N]
  const cuuint64_t msz = PD ? 2 : 4;
  if (!tmap_3d(&tm, M, PD ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, N,
               N, (cuuint64_t)G * K, N * msz, (cuuint64_t)N * N * msz, L::BK, L::BM, 1, true) ||
      !tmap_3d(&tv, v, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, N, K, B, (cuuint64_t)N * 4,
               (cuuint64_t)K * N * 4, L::BK, 1, BN, !PD))
    return (int)cudaErrorInvalidValue;
  auto kernel = tensor_kernel<BN, PD>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  dim3 grid((B + BN - 1) / BN, (N + L::BM - 1) / L::BM, K);
  kernel<<<grid, L::NC + 32, L::BYTES, s>>>(tm, tv, coef, out, rz, partials, tickets, G, K, N, B);
  return (int)cudaGetLastError();
}

// lanes: 32 or 128 lanes a block (plan() in ops/hopper_kernels.py picks them)
template <bool PD>
int launch_tensor(int lanes, const void* M, const float* v, const float* coef, float* out,
                  float* rz, float* partials, unsigned* tickets, int G, int K, int N, int B,
                  cudaStream_t s) {
  if (N % 32 != 0 || !aligned16(M) || !aligned16(v) || !aligned16(out) ||
      (PD && (partials == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (lanes == 128)
    return launch_tensor_cfg<128, PD>(M, v, coef, out, rz, partials, tickets, G, K, N, B, s);
  if (lanes == 32)
    return launch_tensor_cfg<32, PD>(M, v, coef, out, rz, partials, tickets, G, K, N, B, s);
  return (int)cudaErrorInvalidValue;
}

// ----------------------------------------------------------------------------
// tiles route (unchanged from the first port; f32 vectors only on a path)
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

// ----------------------------------------------------------------------------
// dispatch
// ----------------------------------------------------------------------------

template <typename TS, typename TA>
int launch_block_matvec(int route, int lanes, int C, const void* A, const void* x,
                        const void* coef, void* y, int G, int K, int N, int B,
                        cudaStream_t s) {
  const TS* a = static_cast<const TS*>(A);
  const TA* xv = static_cast<const TA*>(x);
  const TA* c = static_cast<const TA*>(coef);
  TA* yv = static_cast<TA*>(y);
  if (route == kStream)
    return launch_stream<TS, TA, false>(lanes, C, a, xv, c, yv, nullptr, nullptr, nullptr,
                                        G, K, N, B, s);
  if (route == kTensor) {
    if constexpr (std::is_same<TS, float>::value && std::is_same<TA, float>::value)
      return launch_tensor<false>(lanes, a, xv, c, yv, nullptr, nullptr, nullptr, G, K, N, B, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route == kRing) {
    if constexpr (std::is_same<TS, TA>::value && !std::is_same<TS, __nv_bfloat16>::value)
      return launch_ring<TA, false>(a, xv, c, yv, nullptr, nullptr, nullptr, G, K, N, B, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route == kDmma) {
    if constexpr (std::is_same<TA, double>::value)
      return launch_dmma<TS, false>(lanes, C, a, xv, c, yv, nullptr, nullptr, nullptr, G, K, N,
                                    B, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route == kTiles) {
    // 64 rows x 64 lanes per block, 4 x 4 (row, lane) accumulators a thread
    dim3 grid(K, (N + 63) / 64, (B + 63) / 64);
    block_matvec_tiles<TS, TA, 64, 64, 4, 4><<<grid, 256, 0, s>>>(a, xv, c, yv, G, K, N, B);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TS, typename TA>
int launch_precond_dot(int route, int lanes, int C, const void* F, const void* r, void* z,
                       void* rz, void* partials, void* tickets, int K, int N, int B,
                       cudaStream_t s) {
  const TS* f = static_cast<const TS*>(F);
  const TA* rv = static_cast<const TA*>(r);
  TA* zv = static_cast<TA*>(z);
  TA* rzv = static_cast<TA*>(rz);
  if (route == kStream) {
    if (partials == nullptr || tickets == nullptr) return (int)cudaErrorInvalidValue;
    return launch_stream<TS, TA, true>(lanes, C, f, rv, nullptr, zv, rzv,
                                       static_cast<TA*>(partials),
                                       static_cast<unsigned*>(tickets), 1, K, N, B, s);
  }
  if (route == kTensor) {
    if constexpr (std::is_same<TS, __nv_bfloat16>::value && std::is_same<TA, float>::value)
      return launch_tensor<true>(lanes, f, rv, nullptr, zv, rzv, static_cast<float*>(partials),
                                 static_cast<unsigned*>(tickets), 1, K, N, B, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route == kRing) {
    if constexpr (std::is_same<TS, TA>::value && !std::is_same<TS, __nv_bfloat16>::value)
      return launch_ring<TA, true>(f, rv, nullptr, zv, rzv, static_cast<TA*>(partials),
                                   static_cast<unsigned*>(tickets), 1, K, N, B, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route == kDmma) {
    if constexpr (std::is_same<TA, double>::value)
      return launch_dmma<TS, true>(lanes, C, f, rv, nullptr, zv, rzv,
                                   static_cast<double*>(partials),
                                   static_cast<unsigned*>(tickets), 1, K, N, B, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route == kTiles) {
    // 64 rows x 32 lanes per step, 4 x 2 accumulators a thread; a block
    // walks all row tiles of its subdomain
    dim3 grid(K, (B + 31) / 32);
    precond_dot_tiles<TS, TA, 32, 64, 4, 2><<<grid, 256, 0, s>>>(f, rv, zv, rzv, K, N, B);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}


// ----------------------------------------------------------------------------
// stencil3: the lane-batched 3D hex (Q1) stencil apply
// ----------------------------------------------------------------------------
//
//   y[b,k,c,:] = sum_q theta[b,q] * sum_{j<7} S[q,k,c,j] @ x[b, nbr_j(k,c), :]
//
// Replaces no Pallas kernel: the JAX package's 3D apply is plain jnp.  It
// was added because the port's plain apply materialised one assembled
// stencil per lane (B x 7 MB at the SPE10 3D cell's shape) and streamed it,
// with a product temporary per block family, in every PCG iteration.  The
// operator is affine in theta, so only the Q component stencils are read
// here, from the folded layout S [Q, K, s, s, s, 7, 8, 8]
// (ops/matrixfree3d.fold_stencils3: slot 0 the cell's own block, slots 1-6
// the couplings to its -x, +x, -y, +y, -z, +z neighbour, across subdomain
// interfaces too; zero where there is none).
//
// Bound (K=32, s=4, Q=2, B=1024, f32): bytes, 42.1 us an apply (the
// component stencils 6.8 MB, x read and y written once 134.2 MB, at 3.35
// TB/s).  With theta applied to x the depth of a cell's product is
// Q 7 nb = 112, so the work is 2 Q 7 nb^2 multiply-adds a lane and cell
// (3.8 GFLOP: 56 us at the 67 TFLOP/s of the f32 units).  What bounds it in
// practice is the loads: each lane's x row of a cell is 32 bytes in its own
// cache line (lanes lie K N apart), so a warp's load of 32 lanes' rows
// costs 32 L1 wavefronts, and every row is read for each of the 7 blocks
// that use it.  Both routes load each x row once per block that uses it
// (for all q) and keep every other operand in registers; a warp owns one
// cell, the blocks walk all cells of a lane tile before the next tile (a
// tile's x, 2-8 MB, stays in L2 for the six neighbour reads), and y is
// written once:
//
//  * simt (f64 vectors): a thread owns L = 2 lanes and the cell's 8 rows;
//    the cell's block rows are the same address for the whole warp (one
//    broadcast 16-byte load feeds 32 x L x 2 multiply-adds), each thread's
//    x rows are four 16-byte loads of its lane; theta_bq scales the x row
//    before each component's block.
//  * tensor (f32 vectors): mma.sync m16n8k8 on the 3xTF32 split (the
//    split of the ring route: big = round-to-nearest TF32, small = the
//    truncated remainder; small x small dropped), lanes as M (16 a tile, MT
//    = 2 tiles a warp), the cell's rows as N, a block's 8 columns as the
//    depth.
//    Columns are permuted (fragment column t <-> 2t, t + 4 <-> 2t + 1) so a
//    thread's pair is adjacent: x rows come as 8-byte loads, 4 threads a
//    row (one wavefront a row), scaled by theta_bq for each component; the
//    block's fragment is one 8-byte load, split once and used for all MT
//    tiles; y leaves as 8-byte stores.  Each (j, q) step's three products
//    sum into fresh registers, added to the running sum with an IEEE f32
//    add (the tensor cores drop low bits in long chains).
//
// At the shape above in f32 (H100 SXM, 700 W, L2 flushed) the tensor route
// takes 0.224 ms at MT = 2 (0.33 at 1, 0.23 at 4), the simt route 0.297
// ms at L = 2 (0.37 at 1, 0.30 at 4); slower were: all 7 x rows loaded up
// front (0.284), the box's x staged in shared memory once a block with only
// the outer neighbours read from global memory (0.285), and 16 or 32 warps
// a block (0.241, 0.259).  In f64 the simt route takes 0.659 ms at L = 2
// (0.763 at 1).
//
// Sums run in a fixed order (j, then q, then the 8 columns), so every
// launch gives the same bits.  nb = 8 only; any Q, B >= 1, and kx, ky, kz,
// s >= 1.

constexpr int S3_NB = 8;      // Q1 hex: dofs a cell
constexpr int S3_SLOTS = 7;   // the own block, then -x, +x, -y, +y, -z, +z
constexpr int S3_WARPS = 8;   // warps a block, one cell each
constexpr int S3_LANES = 2;   // simt route: lanes a thread
constexpr int S3_TILES = 2;   // tensor route: 16-lane tiles a warp

__device__ __forceinline__ void load8(const double* p, double (&v)[S3_NB]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p) + h);
    v[2 * h] = a.x;
    v[2 * h + 1] = a.y;
  }
}

__device__ __forceinline__ void store8(double* p, const double (&v)[S3_NB]) {
#pragma unroll
  for (int h = 0; h < 4; ++h)
    reinterpret_cast<double2*>(p)[h] = make_double2(v[2 * h], v[2 * h + 1]);
}

// flat (k, c) index of the global cell (gx, gy, gz); k = (iz ky + iy) kx + ix,
// c = (cz s + cy) s + cx
__device__ __forceinline__ int s3_cell(int gx, int gy, int gz, int s, int ky, int kx) {
  const int k = ((gz / s) * ky + gy / s) * kx + gx / s;
  return (k * s + gz % s) * s * s + (gy % s) * s + gx % s;
}

// the flat index of `cell` and of its six neighbours (-1: none)
__device__ __forceinline__ void s3_neighbours(int cell, int kz, int ky, int kx, int s,
                                              int (&nbr)[S3_SLOTS]) {
  const int C = s * s * s;
  const int k = cell / C, c = cell - k * C;
  const int gx = (k % kx) * s + c % s;
  const int gy = ((k / kx) % ky) * s + (c / s) % s;
  const int gz = (k / (kx * ky)) * s + c / (s * s);
  nbr[0] = cell;
  nbr[1] = gx > 0 ? s3_cell(gx - 1, gy, gz, s, ky, kx) : -1;
  nbr[2] = gx < kx * s - 1 ? s3_cell(gx + 1, gy, gz, s, ky, kx) : -1;
  nbr[3] = gy > 0 ? s3_cell(gx, gy - 1, gz, s, ky, kx) : -1;
  nbr[4] = gy < ky * s - 1 ? s3_cell(gx, gy + 1, gz, s, ky, kx) : -1;
  nbr[5] = gz > 0 ? s3_cell(gx, gy, gz - 1, s, ky, kx) : -1;
  nbr[6] = gz < kz * s - 1 ? s3_cell(gx, gy, gz + 1, s, ky, kx) : -1;
}

__global__ void __launch_bounds__(32 * S3_WARPS)
stencil3_simt(const double* __restrict__ S, const double* __restrict__ theta,
              const double* __restrict__ x, double* __restrict__ y,
              int Q, int kz, int ky, int kx, int s, int B) {
  using T = double;
  constexpr int L = S3_LANES;
  const int KC = kz * ky * kx * s * s * s;
  const int cell = blockIdx.x * S3_WARPS + (threadIdx.x >> 5);
  if (cell >= KC) return;                       // the whole warp
  int nbr[S3_SLOTS];
  s3_neighbours(cell, kz, ky, kx, s, nbr);
  const int b0 = blockIdx.y * (32 * L) + (threadIdx.x & 31);

  T acc[L][S3_NB];
#pragma unroll
  for (int u = 0; u < L; ++u)
#pragma unroll
    for (int i = 0; i < S3_NB; ++i) acc[u][i] = T(0);
#pragma unroll
  for (int j = 0; j < S3_SLOTS; ++j) {
    if (nbr[j] < 0) continue;                   // uniform over the warp
    T xv[L][S3_NB];
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const int b = b0 + 32 * u;
      if (b < B) {
        load8(x + ((size_t)b * KC + nbr[j]) * S3_NB, xv[u]);
      } else {
#pragma unroll
        for (int l = 0; l < S3_NB; ++l) xv[u][l] = T(0);
      }
    }
    for (int q = 0; q < Q; ++q) {
      const T* W = S + (((size_t)q * KC + cell) * S3_SLOTS + j) * (S3_NB * S3_NB);
      T tx[L][S3_NB];                           // theta_bq x
#pragma unroll
      for (int u = 0; u < L; ++u) {
        const int b = b0 + 32 * u;
        const T th = b < B ? __ldg(theta + (size_t)b * Q + q) : T(0);
#pragma unroll
        for (int l = 0; l < S3_NB; ++l) tx[u][l] = th * xv[u][l];
      }
#pragma unroll
      for (int i = 0; i < S3_NB; ++i) {
        T w[S3_NB];
        load8(W + i * S3_NB, w);
#pragma unroll
        for (int u = 0; u < L; ++u)
#pragma unroll
          for (int l = 0; l < S3_NB; ++l) acc[u][i] = madd(w[l], tx[u][l], acc[u][i]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < L; ++u) {
    const int b = b0 + 32 * u;
    if (b < B) store8(y + ((size_t)b * KC + cell) * S3_NB, acc[u]);
  }
}

__global__ void __launch_bounds__(32 * S3_WARPS)
stencil3_tensor(const float* __restrict__ S, const float* __restrict__ theta,
                const float* __restrict__ x, float* __restrict__ y,
                int Q, int kz, int ky, int kx, int s, int B) {
  constexpr int MT = S3_TILES;
  const int KC = kz * ky * kx * s * s * s;
  const int cell = blockIdx.x * S3_WARPS + (threadIdx.x >> 5);
  if (cell >= KC) return;                       // the whole warp
  int nbr[S3_SLOTS];
  s3_neighbours(cell, kz, ky, kx, s, nbr);
  const int grp = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
  // lanes of fragment rows grp and grp + 8 of each 16-lane tile
  int lane[MT][2];
#pragma unroll
  for (int u = 0; u < MT; ++u) {
    lane[u][0] = blockIdx.y * (16 * MT) + 16 * u + grp;
    lane[u][1] = lane[u][0] + 8;
  }
  float acc[MT][4];
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
#pragma unroll
  for (int j = 0; j < S3_SLOTS; ++j) {
    if (nbr[j] < 0) continue;                   // uniform over the warp
    float2 xv[MT][2];                           // columns 2 tig, 2 tig + 1
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xv[u][h] = lane[u][h] < B
            ? __ldg(reinterpret_cast<const float2*>(
                  x + ((size_t)lane[u][h] * KC + nbr[j]) * S3_NB) + tig)
            : make_float2(0.f, 0.f);
    for (int q = 0; q < Q; ++q) {
      // B fragment: (column t, row grp) = S[q, cell, j][grp][2 tig],
      // (column t + 4, row grp) = S[...][grp][2 tig + 1]
      const float2 w = __ldg(reinterpret_cast<const float2*>(
          S + (((size_t)q * KC + cell) * S3_SLOTS + j) * (S3_NB * S3_NB) + grp * S3_NB) + tig);
      uint32_t wb0, ws0, wb1, ws1;
      split_tf32(w.x, wb0, ws0);
      split_tf32(w.y, wb1, ws1);
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        float th[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          th[h] = lane[u][h] < B ? __ldg(theta + (size_t)lane[u][h] * Q + q) : 0.f;
        uint32_t ab[4], as[4];
        split_tf32(th[0] * xv[u][0].x, ab[0], as[0]);
        split_tf32(th[1] * xv[u][1].x, ab[1], as[1]);
        split_tf32(th[0] * xv[u][0].y, ab[2], as[2]);
        split_tf32(th[1] * xv[u][1].y, ab[3], as[3]);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, as, wb0, wb1);           // small terms first
        mma_tf32(part, ab, ws0, ws1);
        mma_tf32(part, ab, wb0, wb1);
        add_stage(acc[u], part);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (lane[u][h] < B)
        reinterpret_cast<float2*>(y + ((size_t)lane[u][h] * KC + cell) * S3_NB)[tig] =
            make_float2(acc[u][2 * h], acc[u][2 * h + 1]);
}

// f32 vectors take the tensor route, f64 vectors the simt route; a block
// owns S3_WARPS cells and one lane tile
template <typename T>
int launch_stencil3(const T* S, const T* theta, const T* x, T* y, int Q, int kz, int ky,
                    int kx, int s, int B, cudaStream_t st) {
  const int KC = kz * ky * kx * s * s * s;
  const int lanes = std::is_same<T, float>::value ? 16 * S3_TILES : 32 * S3_LANES;
  const dim3 grid((KC + S3_WARPS - 1) / S3_WARPS, (B + lanes - 1) / lanes);
  if constexpr (std::is_same<T, float>::value)
    stencil3_tensor<<<grid, 32 * S3_WARPS, 0, st>>>(S, theta, x, y, Q, kz, ky, kx, s, B);
  else
    stencil3_simt<<<grid, 32 * S3_WARPS, 0, st>>>(S, theta, x, y, Q, kz, ky, kx, s, B);
  return (int)cudaGetLastError();
}


// ----------------------------------------------------------------------------
// stencil2: the lane-batched 2D tri (P1) stencil apply
// ----------------------------------------------------------------------------
//
//   y[b,k,c,:] = sum_q theta[b,q] * sum_{j<4} S[q,k,c,j] @ x[b, nbr_j(k,c), :]
//
// Replaces no Pallas kernel: the JAX package's 2D apply is plain jnp.  It
// was added for the reason stencil3 was: the port's plain apply mixed theta
// into one assembled stencil per lane (B x 2.4 MB at the OS2015 cell's
// shape) and streamed it through ~27 block products and shifted adds in
// every PCG iteration.  Here only the Q component stencils are read, from
// the folded layout S [Q, K, s, s, 2, 4, 3, 3] (ops/matrixfree.
// fold_stencils2: per triangle c = 2 (cy s + cx) + t, slot 0 its own block,
// slot 1 its in-cell partner across the diagonal, slots 2 and 3 its
// neighbour across the vertical and across the horizontal edge: the B to
// the right and below for A (t = 0), the A to the left and above for B,
// across subdomain interfaces too; zero where there is none).
//
// Bound (K=64, s=8, Q=2, B=1024, f32): bytes, 0.0608 ms an apply (x read
// and y written once, 201 MB, and the component stencils, 2.3 MB, at 3.35
// TB/s).  The work is 2 x 9 multiply-adds a lane and block, 0.60 GFLOP,
// 3 operations a byte: far below the f32 SIMT ridge (~20), and blocks of
// 3 x 3 leave nothing for mma, so it is SIMT FMA in x's type.  What the
// design does about the bytes: a block owns one subdomain k and a tile of
// LT lanes.  Each lane's x row of the subdomain (6 s^2 contiguous numbers)
// reaches shared memory by 16-byte cp.async copies, read once from device
// memory; the four edge strips of the neighbour subdomains (s triangles of
// 3 numbers each) are gathered beside it (zero where the domain ends), so
// no x element is read from device memory twice by a block and the strips
// come from L2 (blockIdx.x = k: neighbouring subdomains run together).  A
// thread owns a triangle: for each component it holds the triangle's four
// blocks in registers (one 16-byte load per 4 or 2 numbers) and walks the
// tile's lanes, reading its four x rows from shared memory (consecutive
// triangles, conflict-free) and adding theta_bq times the product to the
// lane's three sums, so no per-lane operator exists anywhere; y is written
// once, consecutive triangles of one lane side by side.
//
// At the shape above (H100 SXM, 700 W, L2 flushed) it takes 0.152 ms in f32
// at 8 lanes a block (0.185 at 4, 0.163 at 12, 0.185 at 16, 0.195 at 32:
// a thread's 3 sums a lane are registers, 188 a thread at 16 lanes, so
// more lanes cost blocks an SM; two or four groups of 128 threads sharing
// a 16- or 32-lane tile, 0.163 and 0.176), and 0.253 ms in f64 (0.350 at 4
// lanes).  The rest of the gap to the bound is the component blocks, read
// from L2 once a lane tile (37 KB against the tile's 16 KB of x).
//
// Sums run in a fixed order (q, then j, then the 3 columns), so every
// launch gives the same bits.  Any Q, B >= 1, kx, ky, s >= 1; the staged
// rows must fit in shared memory (a lane tile of 1 takes s up to ~90 in
// f32, ~60 in f64).

constexpr int S2_NB = 3;                          // P1 triangle: dofs
constexpr int S2_SLOTS = 4;                       // own, partner, vertical, horizontal
constexpr int S2_BLOCK = S2_SLOTS * S2_NB * S2_NB;  // numbers a (q, triangle)
constexpr int S2_THREADS = 128;                   // a triangle a thread (2 s^2 = 128 at s = 8)
constexpr int S2_LANES = 8;                       // lanes a block (a thread's sums in registers)
constexpr int S2_SMEM_MAX = 227 * 1024;           // the H100's dynamic shared memory a block

// a triangle's four blocks of one component, 16-byte loads
__device__ __forceinline__ void s2_load_block(const float* p, float (&w)[S2_BLOCK]) {
#pragma unroll
  for (int v = 0; v < S2_BLOCK / 4; ++v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p) + v);
    w[4 * v] = a.x; w[4 * v + 1] = a.y; w[4 * v + 2] = a.z; w[4 * v + 3] = a.w;
  }
}
__device__ __forceinline__ void s2_load_block(const double* p, double (&w)[S2_BLOCK]) {
#pragma unroll
  for (int v = 0; v < S2_BLOCK / 2; ++v) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p) + v);
    w[2 * v] = a.x; w[2 * v + 1] = a.y;
  }
}

// Block (k = blockIdx.x, lane tile blockIdx.y of LT lanes).  Shared memory:
// per lane of the tile a row of R = 3 (2 s^2 + 4 s) numbers, the subdomain's triangles
// then the halo strips left (the A at (j, s-1) of k - 1), right (the B at
// (j, 0) of k + 1), below (the B at (s-1, j) of k - kx) and above (the A at
// (0, j) of k + kx), j < s; then theta [LT, Q].
template <typename T, int LT>
__global__ void __launch_bounds__(S2_THREADS)
stencil2_simt(const T* __restrict__ S, const T* __restrict__ theta,
              const T* __restrict__ x, T* __restrict__ y,
              int Q, int ky, int kx, int s, int B) {
  extern __shared__ __align__(16) unsigned char s2_raw[];
  T* xs = reinterpret_cast<T*>(s2_raw);
  const int C = 2 * s * s, N = S2_NB * C, R = N + 4 * S2_NB * s;
  const int K = kx * ky, k = blockIdx.x, ix = k % kx, iy = k / kx;
  const int b0 = blockIdx.y * LT, tid = threadIdx.x;
  T* ths = xs + (size_t)LT * R;

  // the tile's x rows: 16-byte copies where rows are 16-byte multiples
  constexpr int V = 16 / sizeof(T);
  if (N % V == 0) {
    const int nv = N / V;
    for (int e = tid; e < LT * nv; e += S2_THREADS) {
      const int u = e / nv, i = e - u * nv, b = b0 + u;
      cp_async16(xs + (size_t)u * R + i * V,
                 x + ((size_t)min(b, B - 1) * K + k) * N + i * V, b < B);
    }
    cp_async_commit();
  } else {
    for (int e = tid; e < LT * N; e += S2_THREADS) {
      const int u = e / N, i = e - u * N, b = b0 + u;
      xs[(size_t)u * R + i] = b < B ? __ldg(x + ((size_t)b * K + k) * N + i) : T(0);
    }
  }
  const int HN = 4 * s * S2_NB;                 // halo numbers a lane
  for (int e = tid; e < LT * HN; e += S2_THREADS) {
    const int u = e / HN, r = e - u * HN, h = r / S2_NB, l = r - h * S2_NB;
    const int side = h / s, j = h - side * s, b = b0 + u;
    int kn = -1, c = 0;
    if (side == 0 && ix > 0) { kn = k - 1; c = 2 * (j * s + s - 1); }
    else if (side == 1 && ix < kx - 1) { kn = k + 1; c = 2 * j * s + 1; }
    else if (side == 2 && iy > 0) { kn = k - kx; c = 2 * ((s - 1) * s + j) + 1; }
    else if (side == 3 && iy < ky - 1) { kn = k + kx; c = 2 * j; }
    xs[(size_t)u * R + N + r] =
        kn >= 0 && b < B ? __ldg(x + ((size_t)b * K + kn) * N + c * S2_NB + l) : T(0);
  }
  for (int e = tid; e < LT * Q; e += S2_THREADS)
    ths[e] = b0 + e / Q < B ? __ldg(theta + (size_t)b0 * Q + e) : T(0);
  if (N % V == 0) cp_async_wait<0>();
  __syncthreads();

  for (int c = tid; c < C; c += S2_THREADS) {
    const int t = c & 1, cy = (c >> 1) / s, cx = (c >> 1) - cy * s;
    int o[S2_SLOTS];                              // the four rows in a lane's row
    o[0] = S2_NB * c;
    o[1] = S2_NB * (c ^ 1);
    if (t == 0) {
      o[2] = S2_NB * (cx < s - 1 ? c + 3 : C + s + cy);
      o[3] = S2_NB * (cy > 0 ? c - 2 * s + 1 : C + 2 * s + cx);
    } else {
      o[2] = S2_NB * (cx > 0 ? c - 3 : C + cy);
      o[3] = S2_NB * (cy < s - 1 ? c + 2 * s - 1 : C + 3 * s + cx);
    }
    T acc[LT][S2_NB];
#pragma unroll
    for (int u = 0; u < LT; ++u)
#pragma unroll
      for (int i = 0; i < S2_NB; ++i) acc[u][i] = T(0);
    for (int q = 0; q < Q; ++q) {
      T w[S2_BLOCK];
      s2_load_block(S + ((size_t)(q * K + k) * C + c) * S2_BLOCK, w);
#pragma unroll
      for (int u = 0; u < LT; ++u) {
        const T* xu = xs + (size_t)u * R;
        T p[S2_NB] = {T(0), T(0), T(0)};
#pragma unroll
        for (int j = 0; j < S2_SLOTS; ++j) {
          const T x0 = xu[o[j]], x1 = xu[o[j] + 1], x2 = xu[o[j] + 2];
#pragma unroll
          for (int i = 0; i < S2_NB; ++i) {
            const T* wi = w + (j * S2_NB + i) * S2_NB;
            p[i] = madd(wi[2], x2, madd(wi[1], x1, madd(wi[0], x0, p[i])));
          }
        }
        const T th = ths[u * Q + q];
#pragma unroll
        for (int i = 0; i < S2_NB; ++i) acc[u][i] = madd(th, p[i], acc[u][i]);
      }
    }
#pragma unroll
    for (int u = 0; u < LT; ++u) {
      const int b = b0 + u;
      if (b < B) {
        T* yr = y + ((size_t)b * K + k) * N + S2_NB * c;
#pragma unroll
        for (int i = 0; i < S2_NB; ++i) yr[i] = acc[u][i];
      }
    }
  }
}

template <typename T, int LT>
int launch_stencil2_tile(const T* S, const T* theta, const T* x, T* y, int Q, int ky, int kx,
                         int s, int B, size_t bytes, cudaStream_t st) {
  auto kernel = stencil2_simt<T, LT>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  }
  const dim3 grid(kx * ky, (B + LT - 1) / LT);
  kernel<<<grid, S2_THREADS, bytes, st>>>(S, theta, x, y, Q, ky, kx, s, B);
  return (int)cudaGetLastError();
}

// S2_LANES lanes a block where their rows fit in shared memory, else one
template <typename T>
int launch_stencil2(const T* S, const T* theta, const T* x, T* y, int Q, int ky, int kx, int s,
                    int B, cudaStream_t st) {
  const size_t row = (size_t)S2_NB * (2 * s * s + 4 * s) + Q;   // a lane's x row and theta
  const size_t bytes = S2_LANES * row * sizeof(T);
  if (bytes <= S2_SMEM_MAX)
    return launch_stencil2_tile<T, S2_LANES>(S, theta, x, y, Q, ky, kx, s, B, bytes, st);
  const size_t one = row * sizeof(T);
  if (one > S2_SMEM_MAX) return (int)cudaErrorInvalidValue;
  return launch_stencil2_tile<T, 1>(S, theta, x, y, Q, ky, kx, s, B, one, st);
}

}  // namespace

extern "C" int pylrbms_block_matvec(int route, int lanes, int chunks, int a_dtype, int x_dtype,
                                    const void* A, const void* x, const void* coef,
                                    void* y, int G, int K, int N, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF64 && a_dtype == kF64)
    return launch_block_matvec<double, double>(route, lanes, chunks, A, x, coef, y, G, K, N, B, s);
  if (x_dtype == kF64 && a_dtype == kBF16)
    return launch_block_matvec<__nv_bfloat16, double>(route, lanes, chunks, A, x, coef, y, G, K, N, B, s);
  if (x_dtype == kF32 && a_dtype == kF32)
    return launch_block_matvec<float, float>(route, lanes, chunks, A, x, coef, y, G, K, N, B, s);
  if (x_dtype == kF32 && a_dtype == kBF16)
    return launch_block_matvec<__nv_bfloat16, float>(route, lanes, chunks, A, x, coef, y, G, K, N, B, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pylrbms_precond_dot(int route, int lanes, int chunks, int f_dtype, int r_dtype,
                                   const void* F, const void* r, void* z, void* rz,
                                   void* partials, void* tickets, int K, int N, int B,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r_dtype == kF64 && f_dtype == kF64)
    return launch_precond_dot<double, double>(route, lanes, chunks, F, r, z, rz, partials, tickets, K, N, B, s);
  if (r_dtype == kF64 && f_dtype == kBF16)
    return launch_precond_dot<__nv_bfloat16, double>(route, lanes, chunks, F, r, z, rz, partials, tickets, K, N, B, s);
  if (r_dtype == kF32 && f_dtype == kF32)
    return launch_precond_dot<float, float>(route, lanes, chunks, F, r, z, rz, partials, tickets, K, N, B, s);
  if (r_dtype == kF32 && f_dtype == kBF16)
    return launch_precond_dot<__nv_bfloat16, float>(route, lanes, chunks, F, r, z, rz, partials, tickets, K, N, B, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pylrbms_stencil3_apply(int dtype, const void* S, const void* theta,
                                      const void* x, void* y, int Q, int kz, int ky, int kx,
                                      int s, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_stencil3<float>(static_cast<const float*>(S), static_cast<const float*>(theta),
                                  static_cast<const float*>(x), static_cast<float*>(y), Q, kz,
                                  ky, kx, s, B, st);
  if (dtype == kF64)
    return launch_stencil3<double>(static_cast<const double*>(S),
                                   static_cast<const double*>(theta),
                                   static_cast<const double*>(x), static_cast<double*>(y), Q, kz,
                                   ky, kx, s, B, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pylrbms_stencil2_apply(int dtype, const void* S, const void* theta,
                                      const void* x, void* y, int Q, int ky, int kx, int s,
                                      int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_stencil2<float>(static_cast<const float*>(S), static_cast<const float*>(theta),
                                  static_cast<const float*>(x), static_cast<float*>(y), Q, ky,
                                  kx, s, B, st);
  if (dtype == kF64)
    return launch_stencil2<double>(static_cast<const double*>(S),
                                   static_cast<const double*>(theta),
                                   static_cast<const double*>(x), static_cast<double*>(y), Q, ky,
                                   kx, s, B, st);
  return (int)cudaErrorInvalidValue;
}
