// Kernel 4: the BPR family (bucket reduction by parallel running sums):
// stage 1, stage 2 and the window fold, each in one launch, and the
// lane-wise lazy add.
//
// Replaces, from ops/pallas_kernels.py of the JAX package (one launcher,
// _run, four bodies):
//   msm_bpr_stage1  <- fused_running_add_lazy, every step of stage 1
//                        m' = m + b, g' = g + m' in one launch
//   msm_bpr_stage2  <- fused_double_lazy (b launches) and
//                        masked_add_and_double_lazy (nbits launches):
//                        g' = g + (k << b) m, one lane a thread
//   msm_bpr_fold    <- fused_add_lazy, every level of the window fold
//                        (log2 T launches and as many gathers)
//   msm_bpr_add     <- fused_add_lazy            a' = a + b, lane-wise:
//                        the sharded engine's join of bucket partials
//                        and window sums (parallel/mesh.py)
// Every operand is a (39, L) lazy projective plane (coords < 4p); outputs
// stay below 4p, so chains of these steps need no reduction in between.
// Built for G1 and, with -DMSM_CURVE_ED, for Edwards (curve.cuh's
// vocabulary): (36, L) extended planes, coords < 2p.  The product is the
// carry-chain form (field.cuh, MSM_MONT_CHAIN) as in tree.cu and
// stream.cu; -DMSM_MONT_C builds the C form for tools/row_times.py.
//
// Bound on this card: G1 3,549 word products per add and 2,704 per double
// against 144 bytes per point moved (values below 20p < 2^382: 12 of a
// coordinate's 13 words), Edwards 1,620 and 1,296 against 128 (below 8p
// < 2^256: 8 of 9 words).  But BPR runs only num_windows * T lanes (8,192
// at 2^20), so one thread a lane fills a fraction of the card, and each
// lane's chain of dependent adds, not either bound, sets the time.
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
//
// Stage 2 (msm_bpr_stage2): g += m * s for s = k << b, k = T - 1 - t (t the
// lane's thread within its window), b = log2(bpt).  The TPU runs it as b
// launches of the lazy double and nbits launches of the masked
// double-and-add over a (nbits, lanes) bit table, every lane at every
// step (6 + 9 launches at 2^20).  Here one thread runs its lane's whole
// chain in registers: m and g loaded once, b doublings of m, then over k's
// bits, low bit first, g += temp where the bit is set and temp = 2 temp,
// g stored once.  The adds and doublings are the TPU's in its order, so g
// is the same word for word; a lane stops at k's top bit (the doublings
// after it feed no add) and a lane with k = 0 only copies g.
//
// The fold (msm_bpr_fold): the TPU's shift-reduce, log2 T levels of a
// gather and an add over all lanes (lane i takes lane i + off, off = T/2,
// T/4, ..., 1), leaves each window's sum in its lane 0.  Here one launch
// runs only the adds that feed lane 0, in the same pairs, so the window
// sums are the same words: a block of FOLD_THREADS = 128 threads a window
// (from T = 128; below, 128 / T windows a block).  Thread i first folds
// its lanes i + 128 r on its own, the levels off = T/2 .. 128: the first
// level's pairs of lanes i + 128 r and i + 128 r + T/2 in bit-reversed
// order of r, merged on a stack as a binary counter carries, which walks
// the shift-reduce's tree depth first (log2(T/256) + 1 points live, in
// local memory).  The levels off = 64 .. 1 run over shared memory, a point
// a thread.  A window of T lanes takes T - 1 adds in log2 T dependent
// steps (G1 2^20: 3 on the thread's own, 7 through shared memory).
//
// Stage 2 and the fold in one launch, the last of a window's blocks to
// finish folding it (a counter a window), measured no faster than the two
// launches on G1 and slower on Edwards, and was dropped.
//
// The adds sit in __noinline__ helpers, as in packed.cu: nvcc 12.8's cicc
// crashes on a runtime-length loop around an inlined point add.
#ifndef MSM_MONT_C
#define MSM_MONT_CHAIN
#endif
#include "curve.cuh"

#define THREADS 128
// blocks a SM that stage 1's registers are held to: at 2 G1 takes 255
// registers (52 bytes spilled) and Edwards 142, which leaves it 3 blocks a
// SM (ops/bpr.py:STAGE1_RESIDENT); 3 and 4 (G1 168 and 128 registers, 284
// and 352 bytes spilled) ran within noise of 2 on both curves on an H100
// (tools/row_times.py --bpr --variants)
#ifndef STAGE1_MIN_BLOCKS
#define STAGE1_MIN_BLOCKS 2
#endif
#define FOLD_THREADS 128
// the fold's per-thread stack: T up to FOLD_THREADS << FOLD_STACK lanes
#define FOLD_STACK 8

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

// r = lane a + lane b of a (rows, ncols) plane
__device__ __noinline__ void pair_sum(Point& r, const int32_t* plane,
                                      long long ncols, long long a,
                                      long long b) {
  Point y;
  pt_load(r, plane, ncols, a);
  pt_load(y, plane, ncols, b);
  pt_add_lazy(r, r, y);
}

// buckets: the (39|36, bpt * lanes) plane in BPR walk order, column
// st * lanes + lane the bucket lane consumes at step st.  A block holds
// THREADS / split lanes, thread (s, li) at s * (THREADS / split) + li, so
// a warp reads consecutive lanes of one step.
__global__ void __launch_bounds__(THREADS, STAGE1_MIN_BLOCKS)
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

// m, g: (39|36, lanes) stage-1 sums, lanes = windows * t_count window-major
// A block of THREADS lanes: 8,192 lanes at 2^20 are 64 blocks; 128 blocks
// of 64 ran no faster on an H100 (each lane's chain sets the time).
__global__ void __launch_bounds__(THREADS)
    stage2_kernel(const int32_t* __restrict__ m,
                  const int32_t* __restrict__ g, int32_t* __restrict__ g_out,
                  long long lanes, int t_count, int shift) {
  const long long lane = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= lanes) return;
  unsigned k = (unsigned)(t_count - 1) - (unsigned)(lane & (t_count - 1));
  Point acc;
  pt_load(acc, g, lanes, lane);
  if (k) {
    Point temp;
    pt_load(temp, m, lanes, lane);
    for (int i = 0; i < shift; ++i) double_in(temp);
    for (;;) {
      if (k & 1) add_into(acc, temp);
      k >>= 1;
      if (!k) break;
      double_in(temp);
    }
  }
  pt_store(g_out, lanes, lane, acc);
}

// g: (39|36, windows * t_count) stage-2 sums -> out (39|36, windows), the
// lazy window sums; block b folds window b from T = FOLD_THREADS, windows
// b * FOLD_THREADS / T onwards below, thread tid lane tid % T of its window
__global__ void __launch_bounds__(FOLD_THREADS)
    fold_kernel(const int32_t* __restrict__ g, int32_t* __restrict__ out,
                long long windows, int t_count) {
  __shared__ Point sm[FOLD_THREADS];
  const int tid = threadIdx.x;
  const long long lanes = windows * t_count;
  const int width = t_count < FOLD_THREADS ? t_count : FOLD_THREADS;
  const int li = tid & (width - 1);
  const long long w =
      (long long)blockIdx.x * (FOLD_THREADS / width) + tid / width;
  const bool live = w < windows;
  if (live) {
    const long long lane = w * t_count + li;
    // levels off = T/2 .. FOLD_THREADS on the thread's own lanes li +
    // FOLD_THREADS r: the first level's pairs (r, r + pairs), r < pairs,
    // in bit-reversed order of r, each merged as it completes a subtree
    const int pairs = t_count / (2 * FOLD_THREADS);
    if (pairs == 0) {
      pt_load(sm[tid], g, lanes, lane);
    } else {
      Point stack[FOLD_STACK];
      const int bits = __ffs(pairs) - 1;
      int depth = 0;
      for (int s = 0; s < pairs; ++s) {
        const int r = bits ? (int)(__brev((unsigned)s) >> (32 - bits)) : 0;
        pair_sum(stack[depth++], g, lanes,
                 lane + (long long)FOLD_THREADS * r,
                 lane + (long long)FOLD_THREADS * (r + pairs));
        for (int c = s + 1; !(c & 1); c >>= 1, --depth)
          add_into(stack[depth - 2], stack[depth - 1]);
      }
      sm[tid] = stack[0];
    }
  }
  __syncthreads();
  for (int off = width / 2; off >= 1; off >>= 1) {
    if (live && li < off) add_into(sm[tid], sm[tid + off]);
    __syncthreads();
  }
  if (live && li == 0) pt_store(out, windows, w, sm[tid]);
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

// t_count: a power of two that divides lanes; shift = log2(bpt)
extern "C" int msm_bpr_stage2(const int32_t* m, const int32_t* g,
                              int32_t* g_out, long long lanes, int t_count,
                              int shift, cudaStream_t stream) {
  if (lanes == 0) return 0;
  stage2_kernel<<<(unsigned)((lanes + THREADS - 1) / THREADS), THREADS, 0,
                  stream>>>(m, g, g_out, lanes, t_count, shift);
  return MSM_LAUNCH_STATUS();
}

// t_count: a power of two, at most FOLD_THREADS << FOLD_STACK
extern "C" int msm_bpr_fold(const int32_t* g, int32_t* out, long long windows,
                            int t_count, cudaStream_t stream) {
  if (windows == 0) return 0;
  const int per = t_count < FOLD_THREADS ? FOLD_THREADS / t_count : 1;
  fold_kernel<<<(unsigned)((windows + per - 1) / per), FOLD_THREADS, 0,
                stream>>>(g, out, windows, t_count);
  return MSM_LAUNCH_STATUS();
}

extern "C" int msm_bpr_add(const int32_t* a, const int32_t* b, int32_t* out,
                           long long n, cudaStream_t stream) {
  if (n == 0) return 0;
  add_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      a, b, out, n);
  return MSM_LAUNCH_STATUS();
}
