// Kernel 7: the canonical-domain point kernels over the complete add and
// double: G1's RCB Alg. 7 and 9, or with -DMSM_CURVE_ED Edwards'
// add-2008-hwcd and dbl-2008-hwcd (curve.cuh's vocabulary).
//
// Replaces, from ops/pallas_kernels.py of the JAX package (one launcher,
// _run, three bodies):
//   msm_scalar_mult <- masked_add_and_double r' = bit ? r + t : r, t' = 2t:
//                      every step of the naive engine's double-and-add
//   msm_tree_sum    <- fused_add             a' = a + b: every level of the
//                      naive engine's tree sum (models/naive.py:tree_sum)
//   msm_running_sum <- fused_running_add     m' = m + b, g' = g + m': every
//                      step of a running-sum chain
// Every operand is a (39, L) G1 projective or (36, L) Edwards extended
// plane with coordinates below p, and so is every output: each field
// operation reduces, so chains need no bound bookkeeping, and a result
// has one representation: the same adds in the same order give the same
// words.  The naive engine runs the first two; the running add has no
// engine caller in either package (the JAX package's docstring gives it
// BPR stage 1's scan; chip_smoke.py's running-sum chain drives it).
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
// msm_running_sum: `steps` running-sum steps over a step-major walk
// (column t * n + j: lane j's addend at step t, BPR stage 1's layout, here
// canonical).  The TPU runs one launch a step, m and g through memory each
// time; here one thread keeps a lane's m and g in registers, reads each
// step's addend once and writes m and g once: the same two adds a step in
// the same order, so the words of `steps` one-step launches.
//
// msm_tree_sum: the lanes of a (39|36, N) plane folded into one, N a
// power of two, in the JAX tree's pairs (at every level lane i + lane i +
// half, i < half), so its words.  The TPU runs a launch a level (16 at
// 2^16), each reading and writing the plane.  Here one launch of G =
// N / 256 blocks (at least 1, at most 256) of TREE_THREADS = 128: block b
// owns the lanes b + G k, which pair only among themselves while half >=
// G, so it runs the first log2(N / G) levels alone and stores lane b of
// width G; the last block to store (a device counter, after
// __threadfence) runs the last log2 G levels on the G partials the same
// way.  One launch, not a second one-block launch: it saves the launch
// and the gap between the two.  The counter is the call's own, a word of
// the scratch the caller zeroes (ops/kernels.py:tree_sum, torch.zeros), so
// calls on several streams at once do not meet, and a warm call finds it
// as the first did.
//
// The tree is 16 dependent adds deep at 2^16, and one thread's canonical
// G1 add is one carry chain of ~11,000 instructions, ~30 us: 16 of them,
// ~0.5 ms, is what the TPU's launches a level already took.  So a block
// runs its first level a thread a pair (128 pairs, the card full), and
// every level after it through shared memory with PT_COOP = 8 threads an
// add (curve.cuh's pt_add_coop): a thread a product of each stage of the
// formula, whose stages hold 6 independent products each (G1; Edwards 5
// and 4).  The residue mapping makes a warp's first loads strided by G
// columns; the plane fits in L2, where neighbouring blocks' reads of the
// same sectors meet.  A coalesced mapping (a thread the lanes c + 128 G r) keeps the
// pairs only by folding on its own far more levels than the depth, so the
// stride stays.  Above N = 2^16 a thread first folds its N / (128 G)
// lanes on its own, depth first (bpr.cu's fold).
//
// Bound on this card: word products.  Per add G1 4,056 (12 Montgomery
// products at 13 words), Edwards 1,620 (10 at 9 words); per double 2,704
// and 1,296 (8 each); bytes per lane: the point (96 G1, 96 Edwards at 12
// and 8 significant words a coordinate), the scalar (32) and r (144,
// 128).  The running sum moves (steps + 4) points a lane for 2 * steps
// adds; the tree sum a point a lane for one add.
//
// On an H100 (tools/row_times.py --baseline, PERF.md), 2^16, device time
// (G1; Edwards): the scalar multiplication 35.0 ms (17.2) where the 256
// one-step launches took 57.6 (25.2), 2.8x its integer-rate bound; the
// running sum's 8 steps 1.29-1.35 ms (0.44) where 8 launches took
// 1.48-1.59 (0.53); the tree sum 0.27 ms (0.14) where 16 launches and
// their copies took 0.50 (0.20-0.22).  One lone thread's add took 27 us
// (9.3), one cooperative add 12 us (6.1-6.8).
//
// This source builds the carry-chain Montgomery product (field.cuh,
// MSM_MONT_CHAIN), as tree.cu does: -DMSM_MONT_C, the C form, ran the
// scalar multiplication 1.4x slower on G1 (1.2x Edwards) and the running
// sum 1.6x.  CANON_MIN_BLOCKS sets the register budget (blocks a SM) of
// the scalar multiplication and the running sum, swept over 1, 2 and 3 by
// tools/row_times.py --baseline --variants: 1 and 2 build the same
// registers (G1 232 and 233), and 3 (168, 112 and 24 bytes spilled) ran
// 15 % and 22-24 % slower on G1, within noise on Edwards.  The adds in runtime-length loops sit in __noinline__ helpers,
// each called with operands in one memory space: nvcc 12.8's cicc crashes
// on such a loop around an inlined point add, and a helper shared by
// stack and shared-memory operands took 255 registers in every caller.
#ifndef MSM_MONT_C
#define MSM_MONT_CHAIN
#endif
#include "curve.cuh"

#define THREADS 128
#ifndef CANON_MIN_BLOCKS
#define CANON_MIN_BLOCKS 1
#endif
#define TREE_THREADS 128
// the thread fold's stack: N up to 2^31
#define TREE_STACK 16

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

// the running sum's add: one add a call (a helper that ran both adds of a
// step built 186 registers on Edwards, 110 this way, and ran 1.4x slower)
__device__ __noinline__ void running_add(Point& acc, const Point& b) {
  pt_add(acc, acc, b);
}

// m, g: (39|36, n) planes; walk: (39|36, steps * n), column t * n + j the
// addend of lane j at step t
__global__ void __launch_bounds__(THREADS, CANON_MIN_BLOCKS)
    running_sum_kernel(const int32_t* __restrict__ m0,
                       const int32_t* __restrict__ g0,
                       const int32_t* __restrict__ walk, int steps,
                       int32_t* __restrict__ m_out,
                       int32_t* __restrict__ g_out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Point m, g;
  pt_load(m, m0, n, j);
  pt_load(g, g0, n, j);
  const long long ncols = (long long)steps * n;
  for (int t = 0; t < steps; ++t) {
    Point b;
    pt_load(b, walk, ncols, (long long)t * n + j);
    running_add(m, b);
    running_add(g, m);
  }
  pt_store(m_out, n, j, m);
  pt_store(g_out, n, j, g);
}

// Column j of a plane through L2 only (ld.global.cg): the tree sum reads
// each lane once, and its last block reads the partials other blocks
// stored in this launch.  Point's coordinates lie in the plane's row
// order.
__device__ __forceinline__ void col_load(Point& r, const int32_t* plane,
                                         long long ncols, long long j) {
  u32* w = reinterpret_cast<u32*>(&r);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(Point) / 4); ++i)
    w[i] = (u32)__ldcg(plane + (size_t)i * ncols + j);
}

// the thread fold's add, on its stack (local memory)
__device__ __noinline__ void fold_add(Point& r, const Point& t) {
  pt_add(r, r, t);
}

// acc = the tree sum of a thread's `per` elements base + stride * r (r <
// per, a power of two >= 4): the first level's pairs (r, r + per / 2) in
// bit-reversed order of r, each merged as it completes a subtree, which
// walks the tree depth first (bpr.cu's fold, here canonical)
__device__ __noinline__ void thread_fold(Point& acc, const int32_t* src,
                                         long long ncols, long long base,
                                         long long stride, int per) {
  Point stack[TREE_STACK], y;
  const int pairs = per / 2;
  const int bits = __ffs(pairs) - 1;
  int depth = 0;
  for (int s = 0; s < pairs; ++s) {
    const int r = (int)(__brev((unsigned)s) >> (32 - bits));
    col_load(stack[depth], src, ncols, base + stride * r);
    col_load(y, src, ncols, base + stride * (r + pairs));
    fold_add(stack[depth++], y);
    for (int c = s + 1; !(c & 1); c >>= 1, --depth)
      fold_add(stack[depth - 2], stack[depth - 1]);
  }
  acc = stack[0];
}

// The tree's shared-memory levels add few pairs, each a chain of dependent
// products: one thread's canonical G1 add is ~11,000 SASS instructions in
// one carry chain (tools/row_times.py --sass), ~30 us on its own.  So a
// group of PT_COOP threads runs each add (curve.cuh's pt_add_coop: G1 6
// independent products a stage, Edwards 5 and 4), the same words as
// pt_add.
#define GROUPS (TREE_THREADS / PT_COOP)

// sm[k] = sm[k] + sm[k + off] for every k < off, GROUPS pairs at a time,
// group k % GROUPS a pair; sc: PT_COOP_SCRATCH elements a group.  Every
// thread of the block calls it: it synchronizes the block.
__device__ __noinline__ void coop_level(Point* sm,
                                        u32 (*sc)[PT_COOP_SCRATCH][NW],
                                        int off) {
  const int grp = threadIdx.x / PT_COOP, g = threadIdx.x % PT_COOP;
  for (int base = 0; base < off; base += GROUPS) {
    const int k = base + grp;
    const bool on = k < off;
    pt_add_coop(sm[on ? k : 0], sm[on ? k + off : 0], sc[grp], g, on);
  }
}

// acc (thread 0) = the tree sum of `count` elements base + stride * k (k <
// count, a power of two): thread t takes elements t and t + TREE_THREADS
// (from count > 2 TREE_THREADS, its elements t + TREE_THREADS r folded on
// its own), then the block the levels below TREE_THREADS through shared
// memory, a level a coop_level.
__device__ __noinline__ void block_fold(Point& acc, const int32_t* src,
                                        long long ncols, long long base,
                                        long long stride, long long count) {
  __shared__ Point sm[TREE_THREADS];
  __shared__ u32 sc[GROUPS][PT_COOP_SCRATCH][NW];
  const int t = threadIdx.x;
  const int width = count < TREE_THREADS ? (int)count : TREE_THREADS;
  if (t < width) {
    Point x;
    if (count > 2 * TREE_THREADS) {
      thread_fold(x, src, ncols, base + stride * t, stride * TREE_THREADS,
                  (int)(count / TREE_THREADS));
    } else {
      col_load(x, src, ncols, base + stride * t);
      if (count == 2 * TREE_THREADS) {
        Point y;
        col_load(y, src, ncols, base + stride * (t + TREE_THREADS));
        pt_add(x, x, y);
      }
    }
    sm[t] = x;
  }
  __syncthreads();
  for (int off = width / 2; off >= 1; off >>= 1) coop_level(sm, sc, off);
  if (t == 0) acc = sm[0];
}

// G = n / (2 TREE_THREADS) blocks, at least 1 and at most 2 TREE_THREADS,
// so that a block's share and the last block's partials are at most one
// pair a thread
static inline long long tree_blocks(long long n) {
  const long long g = n / (2 * TREE_THREADS);
  return g < 1 ? 1 : g > 2 * TREE_THREADS ? 2 * TREE_THREADS : g;
}

// points: (39|36, n), n a power of two, block b the lanes b + G k; partials:
// (39|36, G) scratch; done: the count of blocks that have stored their
// partial, 0 at launch; out: (39|36, 1)
__global__ void __launch_bounds__(TREE_THREADS)
    tree_sum_kernel(const int32_t* __restrict__ points, long long n,
                    int32_t* partials, unsigned* done,
                    int32_t* __restrict__ out) {
  __shared__ bool last;
  const unsigned blocks = gridDim.x;
  Point acc;
  block_fold(acc, points, n, blockIdx.x, blocks, n / blocks);
  if (blocks > 1) {
    if (threadIdx.x == 0) {
      pt_store(partials, blocks, blockIdx.x, acc);
      __threadfence();
      last = atomicAdd(done, 1u) == blocks - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    block_fold(acc, partials, blocks, 0, 1, blocks);
  }
  if (threadIdx.x == 0) pt_store(out, 1, 0, acc);
}
static inline unsigned blocks_for(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
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

// m, g: the (39|36, n) planes the chain starts from; walk: (39|36, steps *
// n), step-major; steps >= 1; m_out, g_out: (39|36, n)
extern "C" int msm_running_sum(const int32_t* m, const int32_t* g,
                               const int32_t* walk, int steps, int32_t* m_out,
                               int32_t* g_out, long long n,
                               cudaStream_t stream) {
  if (n == 0) return 0;
  running_sum_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      m, g, walk, steps, m_out, g_out, n);
  return MSM_LAUNCH_STATUS();
}

// int32 words of msm_tree_sum's scratch at width n: the (39|36, G)
// partials, then the block counter
extern "C" int msm_tree_sum_scratch(long long n) {
  return (int)(sizeof(Point) / 4 * tree_blocks(n) + 1);
}

// points: (39|36, n), n a power of two; scratch: msm_tree_sum_scratch(n)
// words, zeroed by the caller; out: (39|36, 1)
extern "C" int msm_tree_sum(const int32_t* points, int32_t* scratch,
                            int32_t* out, long long n, cudaStream_t stream) {
  if (n == 0) return 0;
  const long long g = tree_blocks(n);
  unsigned* done = reinterpret_cast<unsigned*>(scratch + sizeof(Point) / 4 * g);
  tree_sum_kernel<<<(unsigned)g, TREE_THREADS, 0, stream>>>(
      points, n, scratch, done, out);
  return MSM_LAUNCH_STATUS();
}
