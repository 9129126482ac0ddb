// Kernel 7: the canonical-domain point kernels, three entry points over
// the complete add and double: G1's RCB Alg. 7 and 9, or with
// -DMSM_CURVE_ED Edwards' add-2008-hwcd and dbl-2008-hwcd (curve.cuh's
// vocabulary).
//
// Replaces, from ops/pallas_kernels.py of the JAX package (one launcher,
// _run, three bodies):
//   msm_fused_add             <- fused_add             a' = a + b
//   msm_masked_add_and_double <- masked_add_and_double
//                                r' = bit ? r + t : r, t' = 2t
//   msm_fused_running_add     <- fused_running_add     m' = m + b, g' = g + m'
// Every operand is a (39, L) G1 projective or (36, L) Edwards extended
// plane with coordinates below p, and so is every output: each field
// operation reduces, so chains need no bound bookkeeping.  The naive
// engine (models/naive.py) runs the first two; the running add has no
// engine caller in either package.
//
// Bound on this card: word products per add G1 4,056 (12 Montgomery
// products at 13 words), Edwards 1,620 (10 at 9 words), per double 2,704
// and 1,296 (8 each), against 144 and 128 bytes per point moved (12 and 8
// significant words a coordinate); bytes and products are within 1.5x of
// each other at the HBM and float32 multiply-add rates.  One thread per
// lane, as in bpr.cu.
#include "curve.cuh"

#define THREADS 128

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

__global__ void __launch_bounds__(THREADS)
    masked_add_and_double_kernel(const int32_t* __restrict__ r,
                                 const int32_t* __restrict__ t,
                                 const int32_t* __restrict__ bits,
                                 int32_t* __restrict__ r_out,
                                 int32_t* __restrict__ t_out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Point x, y;
  pt_load(x, r, n, j);
  pt_load(y, t, n, j);
  if (bits[j]) pt_add(x, x, y);
  pt_store(r_out, n, j, x);
  pt_double(y, y);
  pt_store(t_out, n, j, y);
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

extern "C" int msm_masked_add_and_double(const int32_t* r, const int32_t* t,
                                         const int32_t* bits, int32_t* r_out,
                                         int32_t* t_out, long long n,
                                         cudaStream_t stream) {
  if (n == 0) return 0;
  masked_add_and_double_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      r, t, bits, r_out, t_out, n);
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
