// Kernel 8: the fused segment SMVP.  Per bucket, the canonical complete
// mixed-add sum (RCB Alg. 8) of its contiguous pre-gathered signed rows.
//
// Replaces ops/smvp_kernel.py:accumulate_buckets_fused of the JAX package
// (kernel body _kernel_body).  On the TPU that kernel is a grid over
// 256-lane bucket blocks: every lane's segment is fetched by per-lane DMAs
// of fixed 32-row tiles of 128-word rows into VMEM (with a semaphore, pad
// rows behind the last row and a clamp that keeps the last tile in bounds),
// and the block then runs as many masked lockstep rounds as its longest
// bucket, a count that rides in as a scalar prefetch.  Here a thread owns
// one bucket and its trip count is its own length: thread b walks rows
// starts[b] .. starts[b] + lens[b] - 1 of the pre-gathered array
// (ops/smvp_kernel.py:pregather_signed: the digit's sign is already applied
// to y) and writes column b of the (39, nb) output, in the order of starts.
// No tiles, pad rows, clamp, semaphore, per-block reshape, round counts or
// masks exist on this path, and no lane constraint: any bucket count runs.
//
// A row is 32 words (128 bytes): x in words 0..12, y in 13..25, six zero
// words.  The TPU's 128-word row existed for its DMA's lane tiling; 32 is
// the least width that keeps every row 16-byte aligned, so a thread reads
// a row as seven 16-byte loads.
//
// The sum starts from the identity and adds the rows in order with the
// canonical complete add, as the TPU kernel and the legacy path (kernel 6)
// do, so all three give the same projective coordinates, and canonical
// values have one representation: the result equals the plain form bit for
// bit.  Empty buckets stay the identity.
//
// Bound on this card: products.  Every entry is one mixed add of 3,718
// word products (the add into the identity is computed, as the function
// says, and counted) against 128 bytes read per entry and 164 per bucket.
// In practice the loop is a chain of dependent adds: with few buckets (512
// at chunk 4) the card is nearly empty and the time is the chain's latency.
//
// The add sits in a __noinline__ helper, as in packed.cu and stream.cu:
// nvcc 12.8's cicc crashes on a runtime-length loop around an inlined
// point add.
#include "curve.cuh"

#define THREADS 128
#define ROW_WORDS 32

__device__ __noinline__ void add_row(G1& acc, const int32_t* __restrict__ row) {
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
  g1_add_mixed(acc, acc, w, w + NW);
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
  G1 acc;
  g1_zero(acc);
  for (int t = 0; t < len; ++t, row += ROW_WORDS) add_row(acc, row);
  g1_store(out, nb, b, acc);
}

// rows: (count, 32) row-major signed rows; starts/lens: (nb,) segments of
// rows; out: the (39, nb) canonical bucket plane.
extern "C" int msm_fused_buckets(const int32_t* rows, const int32_t* starts,
                                 const int32_t* lens, int32_t* out,
                                 long long nb, cudaStream_t stream) {
  if (nb == 0) return 0;
  const long long blocks = (nb + THREADS - 1) / THREADS;
  fused_buckets_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      rows, starts, lens, out, nb);
  return MSM_LAUNCH_STATUS();
}
