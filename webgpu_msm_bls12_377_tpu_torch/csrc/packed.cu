// Kernel 3: the hybrid finish.  Per real bucket, the lazy sum of its
// level-K packed nodes, canonicalized once.
//
// Replaces ops/smvp_stream.py:accumulate_packed_streamed of the JAX package
// (kernel body _packed_kernel_body_build).  On the TPU that kernel is a
// sequential grid over 256-lane slabs whose accumulator block stays
// resident from a block's first slab to its last.  Hopper blocks run in no
// order, so here the sequential dimension becomes a loop inside one
// thread: thread r owns bucket rank r of the length-sorted layout
// (ops/smvp_stream.py:build_stream_layout), walks that bucket's len
// contiguous nodes from start, and writes column r of the block-ordered
// output that permute_buckets reads.  Ranks are sorted by length within
// each window, so a warp's lanes run similar trip counts.  No slab gather,
// slab flags or slab-count size class exist on this path.
//
// The sum starts from the identity and adds every node, as the TPU kernel
// does, so both produce the same projective coordinates mod p.  Built for
// G1 and, with -DMSM_CURVE_ED, for Edwards (curve.cuh's vocabulary).
//
// Bound on this card: products.  A bucket of c nodes needs c - 1 full adds
// (G1 3,549 word products each, Edwards 1,620; the add into the identity
// is not counted), against 144 (G1, 48 bytes a coordinate) or 128
// (Edwards, 32 bytes a coordinate) bytes read per node.
//
// The add sits in a __noinline__ helper: with the full add inlined into
// the runtime-length loop, nvcc 12.8's cicc crashes (segmentation fault)
// on this file.  The accumulator then lives in the thread's local memory
// (L1-cached), one point-sized round trip per node added.
#include "curve.cuh"

__device__ __noinline__ void add_node(Point& acc, const int32_t* plane,
                                      long long t_cols, long long j) {
  Point node;
  pt_load(node, plane, t_cols, j);
  pt_add_lazy(acc, acc, node);
}

__global__ void __launch_bounds__(128)
    packed_finish_kernel(const int32_t* __restrict__ plane, long long t_cols,
                         const int32_t* __restrict__ starts_rk,
                         const int32_t* __restrict__ lens_rk,
                         int32_t* __restrict__ out, long long nb) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nb) return;
  const long long start = starts_rk[r];
  const int len = lens_rk[r];
  Point acc;
  pt_zero(acc);
  for (int t = 0; t < len; ++t) add_node(acc, plane, t_cols, start + t);
  pt_canon(acc);
  pt_store(out, nb, r, acc);
}

extern "C" int msm_packed_finish(const int32_t* plane, long long t_cols,
                                 const int32_t* starts_rk,
                                 const int32_t* lens_rk, int32_t* out,
                                 long long nb, cudaStream_t stream) {
  if (nb == 0) return 0;
  const int threads = 128;
  const long long blocks = (nb + threads - 1) / threads;
  packed_finish_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      plane, t_cols, starts_rk, lens_rk, out, nb);
  return MSM_LAUNCH_STATUS();
}
