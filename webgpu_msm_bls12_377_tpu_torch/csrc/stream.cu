// Kernel 5: the stream SMVP.  Per bucket, the lazy sum of its signed table
// points in sorted-stream order, canonicalized once.
//
// Replaces ops/smvp_stream.py:accumulate_buckets_streamed of the JAX package
// (kernel body _stream_kernel_body_build).  On the TPU that kernel is a
// sequential grid over 256-lane slabs of pre-gathered 64-word rows (the
// addend's coordinates, padding and a validity word), whose accumulator
// block stays resident from a block's first slab to its last.  Hopper
// blocks run in no order, so, as in the hybrid finish (packed.cu), the
// sequential dimension becomes a loop inside one thread: thread r owns
// bucket rank r of the length-sorted layout
// (ops/smvp_stream.py:build_stream_layout), walks that bucket's len
// contiguous entries of sorted_vals from start, reads each addend from the
// signed table by its index and sign (curve.cuh:load_signed_aff, as tree
// level 1 does), and writes column r of the block-ordered output that
// permute_buckets reads.  No slab gather, slab rows, validity word, slab
// maps or slab-count size class exist on this path, and so no cap on the
// slab count: any bucket length runs.
//
// The sum starts from the identity and adds every entry with the mixed
// lazy add, as the TPU kernel does, so both produce the same projective
// coordinates mod p.  Built for G1 and, with -DMSM_CURVE_ED, for Edwards
// (curve.cuh's vocabulary; rows (x, y, t) and (-x, y, -t)).
//
// Bound on this card: products.  A bucket of c entries needs c - 1 mixed
// adds (G1 3,211 word products each, Edwards 1,458; the add into the
// identity is not counted), against 100 (G1, 48 bytes a coordinate) or
// 100 (Edwards, 32 bytes a coordinate) bytes read per entry (4 of
// sorted_vals, the rest of the table) and 152 (G1) or 136 (Edwards) bytes
// per bucket: at 2^17 and the float32 multiply-add rate (33.5e12 word
// products/s), 0.19 ms (G1) and 0.085 (Edwards).  In practice the table
// reads are scattered rows of the
// row-major signed table (seven 16-byte loads, 4 sectors, an entry), a
// warp's lanes run different trip counts, and the longest bucket is one
// thread's chain of dependent adds.
//
// At the rate at which the card runs the carry-chain Montgomery product on
// its own (6.2-6.4e12 word products/s on an H100, tree.cu msm_word_rate,
// chip_smoke.py phase 4) the same products bound it at 2^17 at 0.99 ms
// (G1) and 0.46 (Edwards), against 1.8 and 1.0 measured (PERF.md).
//
// What held it back is the add's word products, not the memory: every G1
// kernel that adds points ran at about the same word products a second,
// whatever its memory pattern.  So this source builds the carry-chain
// Montgomery product (field.cuh, MSM_MONT_CHAIN: half the instructions of
// the C form), which took the kernel from 3.9 to 1.8 ms at 2^17 on an
// H100 (G1; Edwards 1.2 to 1.0).  Its register budget,
// __launch_bounds__(128, STREAM_MIN_BLOCKS), is the fastest of 2, 3 and 4
// blocks a SM in tools/row_times.py's sweep: 2 (189 registers on G1; 3
// and 4 spill and ran 15-23 % slower; Edwards, 142 registers, within
// noise).  The accumulator in shared memory (as in packed.cu) and a
// software prefetch of the next entry's row measured no gain (G1 2 % and
// 55 % slower, the prefetch at 234 registers; Edwards within 5 %) and were
// dropped.  -DMSM_MONT_C builds the C form for the tool's comparison.
//
// The add sits in a __noinline__ helper, as in packed.cu: nvcc 12.8's cicc
// crashes on a runtime-length loop around an inlined point add.
#ifndef MSM_MONT_C
#define MSM_MONT_CHAIN
#endif
#include "curve.cuh"

#define THREADS 128
#ifndef STREAM_MIN_BLOCKS
#define STREAM_MIN_BLOCKS 2
#endif

__device__ __noinline__ void add_entry(Point& acc, const int32_t* table,
                                       const int32_t* sorted_vals,
                                       long long n_points, long long i) {
  Affine a;
  load_signed_aff(a, table, sorted_vals, n_points, i);
  pt_add_mixed_lazy(acc, acc, a);
}

__global__ void __launch_bounds__(THREADS, STREAM_MIN_BLOCKS)
    stream_buckets_kernel(const int32_t* __restrict__ table,
                          long long n_points,
                          const int32_t* __restrict__ sorted_vals,
                          const int32_t* __restrict__ starts_rk,
                          const int32_t* __restrict__ lens_rk,
                          int32_t* __restrict__ out, long long nb) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nb) return;
  const long long start = starts_rk[r];
  const int len = lens_rk[r];
  Point acc;
  pt_zero(acc);
  for (int t = 0; t < len; ++t)
    add_entry(acc, table, sorted_vals, n_points, start + t);
  pt_canon(acc);
  pt_store(out, nb, r, acc);
}

// table: the (2 * n_points, 32) row-major signed table.
extern "C" int msm_stream_buckets(const int32_t* table, long long n_points,
                                  const int32_t* sorted_vals,
                                  const int32_t* starts_rk,
                                  const int32_t* lens_rk, int32_t* out,
                                  long long nb, cudaStream_t stream) {
  if (nb == 0) return 0;
  const long long blocks = (nb + THREADS - 1) / THREADS;
  stream_buckets_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      table, n_points, sorted_vals, starts_rk, lens_rk, out, nb);
  return MSM_LAUNCH_STATUS();
}
