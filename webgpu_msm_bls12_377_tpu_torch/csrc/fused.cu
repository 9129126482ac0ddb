// Kernel 8: the fused segment SMVP's first pass.  Per segment, the
// canonical complete mixed-add sum of its contiguous pre-gathered signed
// rows.  Built for G1 (RCB Alg. 8) and, with -DMSM_CURVE_ED, for Edwards
// (hwcd; curve.cuh's vocabulary).
//
// Replaces ops/smvp_kernel.py:accumulate_buckets_fused of the JAX package
// (kernel body _kernel_body).  On the TPU that kernel is a grid over
// 256-lane bucket blocks: every lane's segment is fetched by per-lane DMAs
// of fixed 32-row tiles of 128-word rows into VMEM (with a semaphore, pad
// rows behind the last row and a clamp that keeps the last tile in bounds),
// and the block then runs as many masked lockstep rounds as its longest
// bucket, a count that rides in as a scalar prefetch.  One sequential core
// runs those rounds; carried over one thread a bucket, the chain of the
// longest bucket (about n/2 entries in the top window of chunk 4) leaves
// the card nearly empty (512 buckets: 4 blocks on 132 SMs) and its latency
// is the time.  So the port cuts every bucket's segment into pieces of at
// most PIECE rows (ops/smvp_kernel.py:piece_plan): this kernel gives each
// piece one thread, thread s walks rows starts[s] .. starts[s] + lens[s] -
// 1 of the pre-gathered array (ops/smvp_kernel.py:pregather_signed: the
// digit's sign is already applied, to y for G1, to x and t for Edwards) and
// writes column s of the (39, ns) G1 or (36, ns) Edwards output, and
// kernel 2's full mode then folds each bucket's pieces pairwise
// (ops/smvp_kernel.py:fold_pieces).  No tiles, pad rows, clamp, semaphore,
// per-block reshape, round counts or masks exist on this path, and no lane
// constraint: any segment count runs.
//
// A row is 32 words (128 bytes; curve.cuh, ROW_WORDS): G1 x in words
// 0..12, y in 13..25, six zero words; Edwards x in 0..8, y in 9..17, t in
// 18..26, five zero words.  The TPU's 128-word row existed for its DMA's
// lane tiling; 32 is the least width that keeps every row 16-byte aligned,
// so a thread reads a row's first 28 words as seven 16-byte loads (112
// bytes).
//
// A segment's sum starts from the identity and adds the rows in order with
// the canonical complete add, as the TPU kernel and the legacy path
// (kernel 6) do for a whole bucket, and canonical values have one
// representation: the result equals the plain form bit for bit.  Empty
// segments stay the identity.
//
// Bound on this card: products.  Every entry is one mixed add of 3,718
// word products for G1 (11 Montgomery products at 13 words) or 1,458 for
// Edwards (9 at 9 words); the add into the identity is computed, as the
// function says, and counted.  Bytes: 112 loaded per entry, the segment's
// start and length and its output point (144 bytes G1, 128 Edwards, at 12
// and 8 significant words a coordinate) per segment.  In practice each
// thread's loop is a chain of at most PIECE dependent adds.
//
// The add sits in a __noinline__ helper, as in packed.cu and stream.cu:
// nvcc 12.8's cicc crashes on a runtime-length loop around an inlined
// point add.
#include "curve.cuh"

#define THREADS 128

__device__ __noinline__ void add_row(Point& acc,
                                     const int32_t* __restrict__ row) {
  u32 w[28];
  const int4* v = reinterpret_cast<const int4*>(row);
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const int4 q = __ldg(v + i);
    w[4 * i] = (u32)q.x;
    w[4 * i + 1] = (u32)q.y;
    w[4 * i + 2] = (u32)q.z;
    w[4 * i + 3] = (u32)q.w;
  }
  // the row's words are the addend's coordinates in Affine's order (u32
  // arrays, no padding): read them in place
  static_assert(sizeof(Affine) <= sizeof(w), "an affine point fits a row");
  pt_add_mixed(acc, acc, *reinterpret_cast<const Affine*>(w));
}

__global__ void __launch_bounds__(THREADS)
    fused_buckets_kernel(const int32_t* __restrict__ rows,
                         const int32_t* __restrict__ starts,
                         const int32_t* __restrict__ lens,
                         int32_t* __restrict__ out, long long nb) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const int32_t* row = rows + (long long)starts[b] * ROW_WORDS;
  const int len = lens[b];
  Point acc;
  pt_zero(acc);
  for (int t = 0; t < len; ++t, row += ROW_WORDS) add_row(acc, row);
  pt_store(out, nb, b, acc);
}

// rows: (count, 32) row-major signed rows; starts/lens: (nb,) segments of
// rows; out: the (39|36, nb) canonical plane of segment sums.
extern "C" int msm_fused_buckets(const int32_t* rows, const int32_t* starts,
                                 const int32_t* lens, int32_t* out,
                                 long long nb, cudaStream_t stream) {
  if (nb == 0) return 0;
  const long long blocks = (nb + THREADS - 1) / THREADS;
  fused_buckets_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      rows, starts, lens, out, nb);
  return MSM_LAUNCH_STATUS();
}
