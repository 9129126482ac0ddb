// Kernel 7: the canonical-domain point kernels over the complete add and
// double: G1's RCB Alg. 7 and 9, or with -DMSM_CURVE_ED Edwards'
// add-2008-hwcd and dbl-2008-hwcd (curve.cuh's vocabulary).
//
// Replaces, from ops/pallas_kernels.py of the JAX package (one launcher,
// _run, three bodies):
//   msm_fused_add         <- fused_add             a' = a + b
//   msm_scalar_mult       <- masked_add_and_double r' = bit ? r + t : r,
//                            t' = 2t, every step of the double-and-add
//   msm_fused_running_add <- fused_running_add     m' = m + b, g' = g + m'
// Every operand is a (39, L) G1 projective or (36, L) Edwards extended
// plane with coordinates below p, and so is every output: each field
// operation reduces, so chains need no bound bookkeeping.  The naive
// engine (models/naive.py) runs the first two; the running add has no
// engine caller in either package.
//
// msm_scalar_mult: k_i * P_i for every lane.  The TPU kernel is one step
// of the double-and-add over all lanes, and the JAX engine scans it 256
// times, each step reading and writing both planes r and t through
// memory.  Here one thread runs a lane's whole chain in registers: it
// loads its canonical Montgomery affine point from the (26|27, N) table
// and its 8 scalar words, sets t = P and r = the identity, and for bit i
// of the scalar's low `bits` bits adds t into r where the bit is set and
// doubles t, stopping after the top set bit (r does not change after
// it): popcount(k) adds and bitlen(k) - 1 doublings, the same operations
// in the same order as `bits` one-step launches, so r is theirs bit for
// bit.  A warp runs its longest lane's chain and an add wherever any of
// its lanes has the bit set: on uniform random scalars about 256 adds and
// 255 doublings a lane against the data's ~128 adds, ~1.4x the products.
//
// Bound on this card: word products.  Per add G1 4,056 (12 Montgomery
// products at 13 words), Edwards 1,620 (10 at 9 words); per double 2,704
// and 1,296 (8 each); bytes per lane: the point (96 G1, 96 Edwards at 12
// and 8 significant words a coordinate), the scalar (32) and r (144,
// 128).  The add and the running add move three and five points a lane
// for one or two adds: bytes and products are within 1.5x of each other
// at the HBM and float32 multiply-add rates.  One thread per lane.
//
// On an H100 (tools/row_times.py --baseline, PERF.md) the scalar
// multiplication of a 2^16 naive call took 35.0 ms on the device (G1;
// Edwards 17.0) where the TPU's 256 steps took 57.6 (25.2): 2.8x its
// integer-rate bound, 2x it with the warp's extra adds counted.  At 232
// registers (G1) two 128-thread blocks fit a SM, eight warps.
//
// This source builds the carry-chain Montgomery product (field.cuh,
// MSM_MONT_CHAIN), as tree.cu does: -DMSM_MONT_C, the C form, ran the
// scalar multiplication 1.4x slower on G1 (1.2x Edwards) and the add and
// the running add 1.8x.  CANON_MIN_BLOCKS sets the scalar
// multiplication's register budget (blocks a SM): of 1, 2 and 3 in
// tools/row_times.py --baseline --variants, 1 and 2 build the same 232
// registers, and 3 (168 and 112 bytes spilled) ran 35 % slower on G1.
// The add and the double in its runtime-length loop sit in __noinline__
// helpers: nvcc 12.8's cicc crashes on such a loop around an inlined
// point add.
#ifndef MSM_MONT_C
#define MSM_MONT_CHAIN
#endif
#include "curve.cuh"

#define THREADS 128
#ifndef CANON_MIN_BLOCKS
#define CANON_MIN_BLOCKS 1
#endif

__global__ void __launch_bounds__(THREADS)
    fused_add_kernel(const int32_t* __restrict__ a,
                     const int32_t* __restrict__ b, int32_t* __restrict__ out,
                     long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Point x, y;
  pt_load(x, a, n, j);
  pt_load(y, b, n, j);
  pt_add(x, x, y);
  pt_store(out, n, j, x);
}

__device__ __noinline__ void chain_add(Point& r, const Point& t) {
  pt_add(r, r, t);
}

__device__ __noinline__ void chain_double(Point& t) { pt_double(t, t); }

__global__ void __launch_bounds__(THREADS, CANON_MIN_BLOCKS)
    scalar_mult_kernel(const int32_t* __restrict__ aff,
                       const int32_t* __restrict__ scalars, int bits,
                       int32_t* __restrict__ out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  // the scalar's low `bits` bits and their length
  u32 k[8];
  int top = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const int keep = bits - 32 * w;
    k[w] = keep <= 0 ? 0u
           : keep >= 32 ? (u32)scalars[w * n + j]
                        : (u32)scalars[w * n + j] & ((1u << keep) - 1u);
    if (k[w]) top = 32 * w + 32 - __clz(k[w]);
  }
  Point r, t;
  {
    Affine a;
    aff_load(a, aff, n, j);
    pt_from_affine(t, a);
  }
  pt_zero(r);
  for (int i = 0; i < top; ++i) {
    if ((k[i >> 5] >> (i & 31)) & 1u) chain_add(r, t);
    if (i + 1 < top) chain_double(t);
  }
  pt_store(out, n, j, r);
}

__global__ void __launch_bounds__(THREADS)
    fused_running_add_kernel(const int32_t* __restrict__ m,
                             const int32_t* __restrict__ g,
                             const int32_t* __restrict__ b,
                             int32_t* __restrict__ m_out,
                             int32_t* __restrict__ g_out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Point x, y;
  pt_load(x, m, n, j);
  pt_load(y, b, n, j);
  pt_add(x, x, y);
  pt_store(m_out, n, j, x);
  pt_load(y, g, n, j);
  pt_add(y, y, x);
  pt_store(g_out, n, j, y);
}

static inline unsigned blocks_for(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

extern "C" int msm_fused_add(const int32_t* a, const int32_t* b, int32_t* out,
                             long long n, cudaStream_t stream) {
  if (n == 0) return 0;
  fused_add_kernel<<<blocks_for(n), THREADS, 0, stream>>>(a, b, out, n);
  return MSM_LAUNCH_STATUS();
}

// aff: the (26|27, n) Montgomery table; scalars: (8, n) u32 words, least
// significant first; bits in [0, 256]; out: the (39|36, n) plane of r.
extern "C" int msm_scalar_mult(const int32_t* aff, const int32_t* scalars,
                               int bits, int32_t* out, long long n,
                               cudaStream_t stream) {
  if (n == 0) return 0;
  scalar_mult_kernel<<<blocks_for(n), THREADS, 0, stream>>>(aff, scalars,
                                                            bits, out, n);
  return MSM_LAUNCH_STATUS();
}

extern "C" int msm_fused_running_add(const int32_t* m, const int32_t* g,
                                     const int32_t* b, int32_t* m_out,
                                     int32_t* g_out, long long n,
                                     cudaStream_t stream) {
  if (n == 0) return 0;
  fused_running_add_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      m, g, b, m_out, g_out, n);
  return MSM_LAUNCH_STATUS();
}
