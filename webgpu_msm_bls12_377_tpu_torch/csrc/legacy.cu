// Kernel 6: one lockstep round of the legacy SMVP,
//   acc' = valid ? acc + (sign ? aff : -aff) : acc,
// the canonical complete mixed add (RCB Alg. 8) over every bucket lane.
//
// Replaces ops/pallas_kernels.py:masked_add_mixed of the JAX package (body
// _masked_add_mixed_body).  acc is a (39, B) canonical projective plane,
// aff the (26, B) affine points gathered for this round (canonical, never
// the identity: they are table points), sign and valid (B,) int32 lanes.
// A lane that is not valid gathered whatever entry its clamped index hit;
// the kernel does not compute on it and copies acc through.
//
// Bound on this card: 3,718 word products per valid lane (11 Montgomery
// products) against 316 bytes moved per lane (acc in and out, the valid
// flag) and 108 more per valid lane (aff and the sign flag, which a
// masked lane never needs): bytes the larger at the HBM rate whatever the
// valid share.  One thread per lane; the
// TPU's 512-lane blocks and shipped constant columns have no counterpart
// (the constants are in __constant__ memory).
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
  G1 a;
  pt_load(a, acc, n, j);
  if (valid[j]) {
    u32 x[NW], y[NW];
    fe_load(x, aff, n, 0, j);
    fe_load(y, aff, n, NW, j);
    if (!sign_pos[j]) fe_neg_mod(y, y);
    g1_add_mixed(a, a, x, y);
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
