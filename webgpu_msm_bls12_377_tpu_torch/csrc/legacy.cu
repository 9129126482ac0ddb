// Kernel 6: the legacy SMVP.  Per segment of the sorted entry stream, the
// canonical complete mixed-add sum of its signed table points, from the
// identity and in entry order.  Built for G1 (RCB Alg. 8) and, with
// -DMSM_CURVE_ED, for Edwards (hwcd; curve.cuh's vocabulary).
//
// Replaces ops/pallas_kernels.py:masked_add_mixed of the JAX package (body
// _masked_add_mixed_body) and the rounds that ops/buckets.py:
// accumulate_buckets drives it through.  On the TPU every bucket of a
// window group advances in lockstep: round t gathers entry t of each
// bucket into a (3|4 coords, B) operand and one launch adds it where
// t < len, a masked lane copying its accumulator through; the engine
// reads the per-window maxima back to fix each group's round count.
// Hopper blocks run in no order, so the round loop moves inside one
// thread: thread s walks entries starts[s] .. starts[s] + lens[s] - 1 of
// sorted_vals, reads each addend's row of the row-major signed table by
// its index and sign (curve.cuh:load_signed_aff: seven 16-byte loads, the
// sign already folded in, as stream.cu does), adds it with the canonical
// complete mixed add pt_add_mixed and stores the canonical sum once, in
// column s of the (39, S) G1 or (36, S) Edwards output.  The same adds run
// in the same order as the lockstep rounds, and canonical values have one
// representation, so the sum equals theirs bit for bit.  An empty segment
// stores the identity.  No gather, round count, mask or readback exists
// on this path.
//
// A segment is a bucket (ops/buckets.py:accumulate_buckets) or a piece of
// at most PIECE entries of one (the engine's path, models/cuzk.py, whose
// pieces tree.cu's fold then adds up): at chunk 4 a bucket holds
// thousands of entries and one thread a bucket leaves the card nearly
// empty (512 threads at 2^14) with the longest chain as the time.
//
// Bound on this card: word products.  Every entry is one canonical mixed
// add (the add into the identity included, as the function computes it):
// G1 3,718 word products (11 Montgomery products at 13 words), Edwards
// 1,458 (9 at 9 words); bytes: 4 of sorted_vals and a row's 112 an entry,
// the start and length (8) and the output point (144 G1, 128 Edwards, at
// 12 and 8 significant words a coordinate) a segment.
//
// On an H100 (tools/row_times.py --baseline, PERF.md) one launch over a
// 2^16 Pippenger plan (chunk 15, 1.1M entries) took 3.46 ms on the
// device where the TPU's 48 rounds took 6.9 ms and 102 gathers; over the
// 2^14 case at chunk 4 (980k entries, buckets of ~2,000) a thread a bucket
// took 252 ms and a thread a piece of at most 32 entries 1.16 ms.  The
// warp runs its longest segment: at chunk 15 segment lengths vary around
// ~4, so the kernel sits at ~5x its integer-rate bound.
//
// This source builds the carry-chain Montgomery product (field.cuh,
// MSM_MONT_CHAIN), as stream.cu does (the C form, -DMSM_MONT_C, ran 1.6x
// slower on G1).  Its register budget, __launch_bounds__(128,
// LEGACY_MIN_BLOCKS), is the fastest of 1, 2 and 3 blocks a SM in
// tools/row_times.py --baseline --variants: 3 (G1 168 registers and 60
// bytes spilled, ~6 % faster than 1 block's 218 registers; Edwards 160,
// within noise).  The add sits in a __noinline__ helper: nvcc 12.8's cicc
// crashes on a runtime-length loop around an inlined point add.
#ifndef MSM_MONT_C
#define MSM_MONT_CHAIN
#endif
#include "curve.cuh"

#define THREADS 128
#ifndef LEGACY_MIN_BLOCKS
#define LEGACY_MIN_BLOCKS 3
#endif

__device__ __noinline__ void add_entry(Point& acc, const int32_t* table,
                                       const int32_t* sorted_vals,
                                       long long n_points, long long i) {
  Affine a;
  load_signed_aff(a, table, sorted_vals, n_points, i);
  pt_add_mixed(acc, acc, a);
}

__global__ void __launch_bounds__(THREADS, LEGACY_MIN_BLOCKS)
    legacy_buckets_kernel(const int32_t* __restrict__ table,
                          long long n_points,
                          const int32_t* __restrict__ sorted_vals,
                          const int32_t* __restrict__ starts,
                          const int32_t* __restrict__ lens,
                          int32_t* __restrict__ out, long long ns) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= ns) return;
  const long long start = starts[s];
  const int len = lens[s];
  Point acc;
  pt_zero(acc);
  for (int t = 0; t < len; ++t)
    add_entry(acc, table, sorted_vals, n_points, start + t);
  pt_store(out, ns, s, acc);
}

// table: the (2 * n_points, 32) row-major signed table; starts, lens: (ns,)
// segments of sorted_vals; out: the (39|36, ns) canonical plane.
extern "C" int msm_legacy_buckets(const int32_t* table, long long n_points,
                                  const int32_t* sorted_vals,
                                  const int32_t* starts, const int32_t* lens,
                                  int32_t* out, long long ns,
                                  cudaStream_t stream) {
  if (ns == 0) return 0;
  const long long blocks = (ns + THREADS - 1) / THREADS;
  legacy_buckets_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      table, n_points, sorted_vals, starts, lens, out, ns);
  return MSM_LAUNCH_STATUS();
}
