// Kernel 3: the hybrid finish's piece pass.  Per piece of at most PIECE
// consecutive level-K packed nodes of a bucket, the lazy sum of its nodes
// from the identity; a bucket of one piece canonicalized once.
//
// Replaces ops/smvp_stream.py:accumulate_packed_streamed of the JAX package
// (kernel body _packed_kernel_body_build).  On the TPU that kernel is a
// sequential grid over 256-lane slabs whose accumulator block stays
// resident from a block's first slab to its last.  Hopper blocks run in no
// order, so here the sequential dimension becomes a loop inside one
// thread, over the rows of the (T_K, NODE_WORDS) row-major node array that
// the last tree level writes (tree.cu OUT_ROWS).  No slab gather, slab
// flags or slab-count size class exist on this path.  Built for G1 and,
// with -DMSM_CURVE_ED, for Edwards (curve.cuh's vocabulary).
//
// A thread a bucket made one bucket set the pace: zipf-skewed scalars put
// a quarter of 2^18 points on one value, one bucket a window of ~16,600
// level-2 nodes, whose thread walked that many dependent adds (0.73 s on
// an H100 for G1) while the rest of the card idled.  So the plan
// (ops/smvp_stream.py:finish_plan) cuts every bucket into pieces of at most
// PIECE nodes, thread p owns piece p (rows [starts[p], starts[p] +
// lens[p])), and the pieces of a bucket cut in two or more are folded
// pairwise by tree.cu's fold (msm_fold_split).  A bucket of at most PIECE
// nodes is one piece: its thread writes the canonical sum straight to
// output column dst[p], the words of one thread walking the whole bucket;
// a piece of a longer bucket (dst[p] < 0) writes its lazy sum to column p
// of the piece plane for the fold.  Pieces past the plan's real ones have
// no rows and no output and return at once.
//
// Bound on this card: products.  A bucket of c nodes needs c - 1 full adds
// (G1 3,549 word products each, Edwards 1,620; the add into the identity
// is not counted), against 144 (G1, 48 bytes a coordinate) or 128
// (Edwards, 32 bytes a coordinate) bytes read per node.
//
// What held it back: it read a node from the limb-major (39|36, T_K) plane
// as 39 (36) separate words, and the neighbouring threads of a warp own
// buckets far apart, so every word cost a 32-byte sector: 39 sectors a
// node (1,248 bytes moved for 156 used).  A node row is NODE_LOADS 16-byte
// loads over five sectors: at 2^20 on an H100 the finish fell from 17.5
// to 7.8 ms (G1) and from 4.0 to 2.4 (Edwards).  The piece order stays
// the plan's length-sorted one: in natural order a warp's lanes run
// unequal trip counts and the finish took 1.5-1.7x as long.  A two-slot
// shared-memory ring that copied each thread's next node with cp.async
// while it added the current one measured within 2 % (no gain) and was
// dropped.
//
// The add sits in a __noinline__ helper: with the full add inlined into
// the runtime-length loop, nvcc 12.8's cicc crashes (segmentation fault)
// on this file.  The accumulator the helper updates lives in shared
// memory, a point a thread (in local memory the finish ran 1-2 % slower
// on G1).
#include "curve.cuh"

#define THREADS 128

__device__ __noinline__ void add_row(Point& acc, const int32_t* rows,
                                     long long j) {
  Point node;
  pt_load_row(node, rows, j);
  pt_add_lazy(acc, acc, node);
}

__global__ void __launch_bounds__(THREADS)
    packed_finish_kernel(const int32_t* __restrict__ rows,
                         const int32_t* __restrict__ starts,
                         const int32_t* __restrict__ lens,
                         const int32_t* __restrict__ dst,
                         int32_t* __restrict__ sums, long long np,
                         int32_t* __restrict__ out, long long nb) {
  __shared__ Point accs[THREADS];
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= np) return;
  const int len = lens[p];
  const int d = dst[p];
  if (d < 0 && len == 0) return;
  const long long start = starts[p];
  Point& acc = accs[threadIdx.x];
  pt_zero(acc);
  for (int t = 0; t < len; ++t) add_row(acc, rows, start + t);
  if (d >= 0) {
    pt_canon(acc);
    pt_store(out, nb, d, acc);
  } else {
    pt_store(sums, np, p, acc);
  }
}

// rows: the (T_K, NODE_WORDS) node rows; starts, lens, dst: the np pieces
// of the plan; sums: the (39|36, np) piece plane, column p written where
// dst[p] < 0 and lens[p] > 0; out: (39|36, nb), column dst[p] the
// canonical sum of a bucket of one piece.
extern "C" int msm_packed_finish(const int32_t* rows, const int32_t* starts,
                                 const int32_t* lens, const int32_t* dst,
                                 int32_t* sums, long long np, int32_t* out,
                                 long long nb, cudaStream_t stream) {
  if (np == 0) return 0;
  const unsigned blocks = (unsigned)((np + THREADS - 1) / THREADS);
  packed_finish_kernel<<<blocks, THREADS, 0, stream>>>(rows, starts, lens,
                                                       dst, sums, np, out, nb);
  return MSM_LAUNCH_STATUS();
}
