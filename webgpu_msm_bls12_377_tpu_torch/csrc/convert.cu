// Kernel 1: REDC(a * y) lane-wise for a constant y < p, reduced to the
// canonical residue: Montgomery entry (y = R^2 mod p) and exit (y = 1).
// For any a < R and y < p, REDC(a * y) < y + p < 2p, so one conditional
// subtract of p makes the output canonical.  Built for G1 (13 words) and,
// with -DMSM_CURVE_ED, for Edwards (9 words); the Edwards build adds the
// lane-wise product below.
//
// Replaces ops/pallas_kernels.py:mont_mul_const of the JAX package.
// Work per element: one CIOS product, 338 32x32->64 word products at 13
// words (162 at 9), for 96 bytes moved (values below 2^384 need 12 of
// the 13 words; Edwards 64: below 2^256, 8 of 9): bound by bytes at the HBM rate, about 3x above
// the time its products need even at the float32 multiply-add rate.
// Design: one thread per element, y in __constant__ memory (every thread
// reads the same word: a broadcast), limb-major planes so that word w of
// neighbouring elements sits at neighbouring addresses and every load and
// store is coalesced.
#include "field.cuh"

__constant__ u32 MSM_Y[NW];

// a, out: (groups * NW, n) planes; element (g, j) is rows g*NW.., column j
__global__ void mont_mul_const_kernel(const int32_t* __restrict__ a,
                                      int32_t* __restrict__ out,
                                      long long groups, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= groups * n) return;
  const long long g = e / n, j = e % n;
  const int32_t* src = a + g * NW * n;
  u32 x[NW], y[NW], r[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    x[w] = (u32)src[w * n + j];
    y[w] = MSM_Y[w];
  }
  mont_mul(r, x, y);
  fe_csub(r, MSM_P);
  int32_t* dst = out + g * NW * n;
#pragma unroll
  for (int w = 0; w < NW; ++w) dst[w * n + j] = (int32_t)r[w];
}

extern "C" int msm_mont_mul_const(const int32_t* a, int32_t* out,
                                  const uint32_t* y_host, long long groups,
                                  long long n, cudaStream_t stream) {
  cudaError_t err = cudaMemcpyToSymbolAsync(MSM_Y, y_host, NW * sizeof(u32),
                                            0, cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  const long long total = groups * n;
  if (total == 0) return 0;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  mont_mul_const_kernel<<<(unsigned)blocks, threads, 0, stream>>>(a, out, groups,
                                                                 n);
  return MSM_LAUNCH_STATUS();
}

#ifdef MSM_CURVE_ED
// The Edwards table's t = x*y at point prep: REDC(a * b) lane-wise over
// two canonical (NW, n) planes, canonical out (REDC(a * b) < p^2/R + p <
// 2p: one conditional subtract).  Replaces the XLA mont_mul of the JAX
// package's models/cuzk.py:mont_point_table, which runs outside any
// Pallas kernel.  162 word products for 96 bytes moved: bound by bytes,
// as kernel 1.  One thread per element, coalesced limb-major loads.
__global__ void mont_mul_lanes_kernel(const int32_t* __restrict__ a,
                                      const int32_t* __restrict__ b,
                                      int32_t* __restrict__ out,
                                      long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  u32 x[NW], y[NW], r[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    x[w] = (u32)a[w * n + j];
    y[w] = (u32)b[w * n + j];
  }
  mont_mul(r, x, y);
  fe_csub(r, MSM_P);
#pragma unroll
  for (int w = 0; w < NW; ++w) out[w * n + j] = (int32_t)r[w];
}

extern "C" int msm_mont_mul_lanes(const int32_t* a, const int32_t* b,
                                  int32_t* out, long long n,
                                  cudaStream_t stream) {
  if (n == 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  mont_mul_lanes_kernel<<<(unsigned)blocks, threads, 0, stream>>>(a, b, out, n);
  return MSM_LAUNCH_STATUS();
}
#endif  // MSM_CURVE_ED
