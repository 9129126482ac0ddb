// Kernel 4: the BPR family (bucket reduction by parallel running sums),
// four entry points over the same lazy add and double.
//
// Replaces, from ops/pallas_kernels.py of the JAX package (one launcher,
// _run, four bodies):
//   msm_bpr_stage1        <- fused_running_add_lazy, every step of stage 1
//                              m' = m + b, g' = g + m' in one launch
//   msm_bpr_double        <- fused_double_lazy            a' = 2a
//   msm_bpr_masked_add_double <- masked_add_and_double_lazy
//                              r' = bit ? r + t : r, t' = 2t
//   msm_bpr_add           <- fused_add_lazy               a' = a + b
// Every operand is a (39, L) lazy projective plane (coords < 4p); outputs
// stay below 4p, so chains of these steps need no reduction in between.
// Built for G1 and, with -DMSM_CURVE_ED, for Edwards (curve.cuh's
// vocabulary): (36, L) extended planes, coords < 2p.
//
// Bound on this card: G1 3,549 word products per add and 2,704 per double
// against 144 bytes per point moved (values below 20p < 2^382: 12 of a
// coordinate's 13 words), Edwards 1,620 and 1,296 against 128 (below 8p
// < 2^256: 8 of 9 words); bytes and products are within 1.5x of each
// other at the HBM and float32 multiply-add rates.  But BPR runs only
// num_windows * num_threads lanes (8,192 at 2^20), so one thread a lane
// fills a fraction of the card's 132 SMs and a launch a step is set by
// launch latency and the adds' dependent chain, not by either bound.
//
// Stage 1 (msm_bpr_stage1): the TPU runs one launch of the running add per
// step (bpt - 1 launches: 63 at 2^20, 15.4 ms on an H100 for 5.5 ms of
// device time, two dependent adds each).  Here one launch walks every
// step, and each lane's walk is split into `split` sub-walks of q =
// bpt / split steps, one thread each, so lanes * split threads run: sub-walk
// s keeps its own running sums m_s, g_s over its q steps, and the lane's
// threads then combine them through shared memory, exactly:
//   m = m_0 + ... + m_{S-1},
//   g = g_0 + ... + g_{S-1} + q * (M_0 + ... + M_{S-2}),  M_s = m_0 + ... + m_s
// in the order of ops/kernels.py:bpr_stage1_plain (a running add over
// m_0 .. m_{S-2}, log2 q lazy doublings, a left fold of the g_s).  The
// adds and doublings are the lazy forms of the chains above, so the
// combine keeps their bounds.  split = 1 is the TPU walk word for word.
#include "curve.cuh"

#define THREADS 128

// The adds sit in __noinline__ helpers, as in packed.cu: nvcc 12.8's cicc
// crashes on a runtime-length loop around an inlined point add.
__device__ __noinline__ void running_step(Point& m, Point& g,
                                          const int32_t* plane,
                                          long long ncols, long long j) {
  Point b;
  pt_load(b, plane, ncols, j);
  pt_add_lazy(m, m, b);
  pt_add_lazy(g, g, m);
}

__device__ __noinline__ void add_into(Point& acc, const Point& b) {
  pt_add_lazy(acc, acc, b);
}

__device__ __noinline__ void double_in(Point& a) { pt_double_lazy(a, a); }

// buckets: the (39|36, bpt * lanes) plane in BPR walk order, column
// st * lanes + lane the bucket lane consumes at step st.  A block holds
// THREADS / split lanes, thread (s, li) at s * (THREADS / split) + li, so
// a warp reads consecutive lanes of one step.
__global__ void __launch_bounds__(THREADS)
    stage1_kernel(const int32_t* __restrict__ buckets,
                  int32_t* __restrict__ m_out, int32_t* __restrict__ g_out,
                  long long lanes, int bpt, int split) {
  __shared__ Point sm_m[THREADS], sm_g[THREADS];
  const int per = THREADS / split;
  const int s = threadIdx.x / per, li = threadIdx.x % per;
  const long long lane = (long long)blockIdx.x * per + li;
  const bool live = lane < lanes;
  const int q = bpt / split;
  const long long ncols = (long long)bpt * lanes;
  Point& m = sm_m[threadIdx.x];
  Point& g = sm_g[threadIdx.x];
  if (live) {
    const long long j0 = (long long)s * q * lanes + lane;
    pt_load(m, buckets, ncols, j0);
    g = m;
    for (int i = 1; i < q; ++i)
      running_step(m, g, buckets, ncols, j0 + (long long)i * lanes);
  }
  if (split > 1) __syncthreads();
  if (s != 0 || !live) return;
  if (split > 1) {
    Point w = m;  // m_0; m becomes the running sum M_s
    for (int k = 1; k < split - 1; ++k) {
      add_into(m, sm_m[k * per + li]);
      add_into(w, m);
    }
    add_into(m, sm_m[(split - 1) * per + li]);
    for (int d = q; d > 1; d >>= 1) double_in(w);
    for (int k = 1; k < split; ++k) add_into(g, sm_g[k * per + li]);
    add_into(g, w);
  }
  pt_store(m_out, lanes, lane, m);
  pt_store(g_out, lanes, lane, g);
}

__global__ void __launch_bounds__(THREADS)
    double_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                  long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Point x;
  pt_load(x, a, n, j);
  pt_double_lazy(x, x);
  pt_store(out, n, j, x);
}

__global__ void __launch_bounds__(THREADS)
    masked_add_double_kernel(const int32_t* __restrict__ r,
                             const int32_t* __restrict__ t,
                             const int32_t* __restrict__ bits,
                             int32_t* __restrict__ r_out,
                             int32_t* __restrict__ t_out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Point x, y;
  pt_load(x, r, n, j);
  pt_load(y, t, n, j);
  if (bits[j]) pt_add_lazy(x, x, y);
  pt_store(r_out, n, j, x);
  pt_double_lazy(y, y);
  pt_store(t_out, n, j, y);
}

__global__ void __launch_bounds__(THREADS)
    add_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
               int32_t* __restrict__ out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Point x, y;
  pt_load(x, a, n, j);
  pt_load(y, b, n, j);
  pt_add_lazy(x, x, y);
  pt_store(out, n, j, x);
}

static inline unsigned blocks_for(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

// split: a power of two that divides bpt and 128 / split lanes fill a
// block (split <= 8 keeps a warp's lanes on one step or two).
extern "C" int msm_bpr_stage1(const int32_t* buckets, int32_t* m_out,
                              int32_t* g_out, long long lanes, int bpt,
                              int split, cudaStream_t stream) {
  if (lanes == 0) return 0;
  const int per = THREADS / split;
  stage1_kernel<<<(unsigned)((lanes + per - 1) / per), THREADS, 0, stream>>>(
      buckets, m_out, g_out, lanes, bpt, split);
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
