// Kernel 4: the BPR family (bucket reduction by parallel running sums),
// four entry points over the same lazy add and double.
//
// Replaces, from ops/pallas_kernels.py of the JAX package (one launcher,
// _run, four bodies):
//   msm_bpr_running_add   <- fused_running_add_lazy       m' = m + b, g' = g + m'
//   msm_bpr_double        <- fused_double_lazy            a' = 2a
//   msm_bpr_masked_add_double <- masked_add_and_double_lazy
//                              r' = bit ? r + t : r, t' = 2t
//   msm_bpr_add           <- fused_add_lazy               a' = a + b
// Every operand is a (39, L) lazy projective plane (coords < 4p); outputs
// stay below 4p, so chains of these steps need no reduction in between.
//
// Bound on this card: 3,549 word products per add and 2,704 per double
// against 156 bytes per point moved, bytes and products within 1.5x of
// each other at the HBM and float32 multiply-add rates.  But BPR runs only
// num_windows * num_threads lanes (8,192 at 2^20), so one launch fills a
// fraction of the card's 132 SMs and launch latency dominates; the design
// here is one thread per lane, simple and right, and the low occupancy is
// left for later work.
#include "curve.cuh"

#define THREADS 128

__global__ void __launch_bounds__(THREADS)
    running_add_kernel(const int32_t* __restrict__ m,
                       const int32_t* __restrict__ g,
                       const int32_t* __restrict__ b,
                       int32_t* __restrict__ m_out,
                       int32_t* __restrict__ g_out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  G1 x, y;
  g1_load(x, m, n, j);
  g1_load(y, b, n, j);
  g1_add_lazy_pair(x, x, y);
  g1_store(m_out, n, j, x);
  g1_load(y, g, n, j);
  g1_add_lazy_pair(y, y, x);
  g1_store(g_out, n, j, y);
}

__global__ void __launch_bounds__(THREADS)
    double_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                  long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  G1 x;
  g1_load(x, a, n, j);
  g1_double_lazy(x, x);
  g1_store(out, n, j, x);
}

__global__ void __launch_bounds__(THREADS)
    masked_add_double_kernel(const int32_t* __restrict__ r,
                             const int32_t* __restrict__ t,
                             const int32_t* __restrict__ bits,
                             int32_t* __restrict__ r_out,
                             int32_t* __restrict__ t_out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  G1 x, y;
  g1_load(x, r, n, j);
  g1_load(y, t, n, j);
  if (bits[j]) g1_add_lazy_pair(x, x, y);
  g1_store(r_out, n, j, x);
  g1_double_lazy(y, y);
  g1_store(t_out, n, j, y);
}

__global__ void __launch_bounds__(THREADS)
    add_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
               int32_t* __restrict__ out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  G1 x, y;
  g1_load(x, a, n, j);
  g1_load(y, b, n, j);
  g1_add_lazy_pair(x, x, y);
  g1_store(out, n, j, x);
}

static inline unsigned blocks_for(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

extern "C" int msm_bpr_running_add(const int32_t* m, const int32_t* g,
                                   const int32_t* b, int32_t* m_out,
                                   int32_t* g_out, long long n,
                                   cudaStream_t stream) {
  if (n == 0) return 0;
  running_add_kernel<<<blocks_for(n), THREADS, 0, stream>>>(m, g, b, m_out,
                                                            g_out, n);
  return MSM_LAUNCH_STATUS();
}

extern "C" int msm_bpr_double(const int32_t* a, int32_t* out, long long n,
                              cudaStream_t stream) {
  if (n == 0) return 0;
  double_kernel<<<blocks_for(n), THREADS, 0, stream>>>(a, out, n);
  return MSM_LAUNCH_STATUS();
}

extern "C" int msm_bpr_masked_add_double(const int32_t* r, const int32_t* t,
                                         const int32_t* bits, int32_t* r_out,
                                         int32_t* t_out, long long n,
                                         cudaStream_t stream) {
  if (n == 0) return 0;
  masked_add_double_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      r, t, bits, r_out, t_out, n);
  return MSM_LAUNCH_STATUS();
}

extern "C" int msm_bpr_add(const int32_t* a, const int32_t* b, int32_t* out,
                           long long n, cudaStream_t stream) {
  if (n == 0) return 0;
  add_kernel<<<blocks_for(n), THREADS, 0, stream>>>(a, b, out, n);
  return MSM_LAUNCH_STATUS();
}
