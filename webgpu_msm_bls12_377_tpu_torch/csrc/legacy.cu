// Kernel 6: one lockstep round of the legacy SMVP,
//   acc' = valid ? acc + (sign ? aff : -aff) : acc,
// the canonical complete mixed add over every bucket lane.  Built for G1
// (RCB Alg. 8; -aff negates y) and, with -DMSM_CURVE_ED, for Edwards
// (hwcd; -aff negates x and t).
//
// Replaces ops/pallas_kernels.py:masked_add_mixed of the JAX package (body
// _masked_add_mixed_body).  acc is a (39, B) G1 or (36, B) Edwards
// canonical plane, aff the (26, B) or (27, B) affine points gathered for
// this round (canonical, never the identity: they are table points), sign
// and valid (B,) int32 lanes.  A lane that is not valid gathered whatever
// entry its clamped index hit; the kernel does not compute on it and
// copies acc through.
//
// Bound on this card: bytes at the HBM rate, whatever the valid share.
// Per valid lane G1 3,718 word products (11 Montgomery products at 13
// words), Edwards 1,458 (9 at 9 words); bytes per lane: acc in and out
// and the valid flag (292 G1, 260 Edwards, at 12 and 8 significant words
// a coordinate), and per valid lane the addend and its sign flag (100,
// 100), which a masked lane never needs.  One thread per lane; the TPU's
// 512-lane blocks and shipped constant columns have no counterpart (the
// constants are in __constant__ memory).
#include "curve.cuh"

#define THREADS 128

__global__ void __launch_bounds__(THREADS)
    masked_add_mixed_kernel(const int32_t* __restrict__ acc,
                            const int32_t* __restrict__ aff,
                            const int32_t* __restrict__ sign_pos,
                            const int32_t* __restrict__ valid,
                            int32_t* __restrict__ out, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Point a;
  pt_load(a, acc, n, j);
  if (valid[j]) {
    Affine q;
    aff_load(q, aff, n, j);
    if (!sign_pos[j]) pt_neg_affine(q);
    pt_add_mixed(a, a, q);
  }
  pt_store(out, n, j, a);
}

extern "C" int msm_masked_add_mixed(const int32_t* acc, const int32_t* aff,
                                    const int32_t* sign_pos,
                                    const int32_t* valid, int32_t* out,
                                    long long n, cudaStream_t stream) {
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  masked_add_mixed_kernel<<<blocks, THREADS, 0, stream>>>(acc, aff, sign_pos,
                                                          valid, out, n);
  return MSM_LAUNCH_STATUS();
}
