// Kernel 2: one level of the packed bucket tree (the hybrid SMVP's levels
// 1..K).
//
// Replaces ops/smvp_tree.py:run_tree_level of the JAX package (kernel body
// _tree_kernel_body_build), modes "aff" (level 1) and "full" (levels 2..K).
// Output node p of a level reads its children at childA = map[p] & CHILD
// and childA + 1 of the previous level:
//   aff:  the previous level is the sorted entry stream itself.  Child i
//         is sorted_vals[i] (point index | positive-sign bit 30), read
//         from the signed table: rows [0, N) hold (x, y), rows [N, 2N)
//         hold (x, -y).  Both-affine lazy RCB add; a single child is
//         promoted with from_affine.
//   full: the previous level is a packed (39, T) plane of lazy projective
//         nodes.  Full lazy RCB add; a single child is copied.
// FLAG_INVALID slots (past the level's real node count) write the
// identity; LAST canonicalizes every output.  Built for G1 and, with
// -DMSM_CURVE_ED, for Edwards (curve.cuh's vocabulary): the signed table
// is then (27, 2N) of (x, y, t) and (-x, y, -t), nodes (36, T) extended
// points, and the adds the hwcd forms.
//
// Bound on this card: a G1 aff node costs 2,873 word products (4
// Montgomery products, 3 paired) for ~344 bytes moved (two 4-byte
// sorted_vals, two 96-byte table rows, one 144-byte node: values below
// 20p < 2^382 need 12 of a coordinate's 13 words); a full node 3,549 for
// 432 bytes.  Edwards: 1,458 word products (9 products of 162)
// for ~328 bytes (two 96-byte rows, one 128-byte node: values below 8p <
// 2^256 need 8 of a coordinate's 9 words), a full node 1,620 for 384.  At the HBM rate and the float32 multiply-add rate the two
// limits are within 1.5x, bytes the larger.  In practice the kernel runs
// far above both: every word product with its carries is several integer
// instructions, and a thread's points hold ~230 registers, so few warps
// hide the latency.  Design: one thread per output node, so the
// TPU's tile windows, window_gather and tile-base maps are not needed;
// children are read by absolute index.  Reading level 1's children
// through sorted_vals skips materializing the level-0 stream (the JAX
// package's gather_level0).  Neighbouring nodes have neighbouring
// children, so the limb-major loads stay mostly coalesced.
#include "curve.cuh"

#define FLAG_INVALID (1 << 29)
#define FLAG_SINGLE (1 << 30)
#define CHILD_MASK (FLAG_INVALID - 1)

template <bool AFF, bool LAST>
__global__ void __launch_bounds__(128)
    tree_level_kernel(const int32_t* __restrict__ in, long long in_cols,
                      const int32_t* __restrict__ sorted_vals,
                      const int32_t* __restrict__ level_map,
                      int32_t* __restrict__ out, long long t_out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= t_out) return;
  const int32_t e = level_map[p];
  Point r;
  if (e & FLAG_INVALID) {
    pt_zero(r);
  } else {
    const long long a = e & CHILD_MASK;
    const bool single = (e & FLAG_SINGLE) != 0;
    if (AFF) {
      Affine a1;
      load_signed_aff(a1, in, sorted_vals, in_cols, a);
      if (single) {
        pt_from_affine(r, a1);
      } else {
        Affine a2;
        load_signed_aff(a2, in, sorted_vals, in_cols, a + 1);
        pt_add_affine_lazy(r, a1, a2);
      }
    } else {
      pt_load(r, in, in_cols, a);
      if (!single) {
        Point b;
        pt_load(b, in, in_cols, a + 1);
        pt_add_lazy(r, r, b);
      }
    }
  }
  if (LAST) pt_canon(r);
  pt_store(out, t_out, p, r);
}

template <bool AFF, bool LAST>
static int launch(const int32_t* in, long long in_cols,
                  const int32_t* sorted_vals, const int32_t* level_map,
                  int32_t* out, long long t_out, cudaStream_t stream) {
  if (t_out == 0) return 0;
  const int threads = 128;
  const long long blocks = (t_out + threads - 1) / threads;
  tree_level_kernel<AFF, LAST><<<(unsigned)blocks, threads, 0, stream>>>(
      in, in_cols, sorted_vals, level_map, out, t_out);
  return MSM_LAUNCH_STATUS();
}

// aff: in is the (26|27, 2N) signed table, in_cols = N (points per sign).
extern "C" int msm_tree_level_aff(const int32_t* table, long long n_points,
                                  const int32_t* sorted_vals,
                                  const int32_t* level_map, int32_t* out,
                                  long long t_out, int last,
                                  cudaStream_t stream) {
  return last ? launch<true, true>(table, n_points, sorted_vals, level_map,
                                   out, t_out, stream)
              : launch<true, false>(table, n_points, sorted_vals, level_map,
                                    out, t_out, stream);
}

// full: in is the (39|36, in_cols) packed plane of the previous level.
extern "C" int msm_tree_level_full(const int32_t* in, long long in_cols,
                                   const int32_t* level_map, int32_t* out,
                                   long long t_out, int last,
                                   cudaStream_t stream) {
  return last ? launch<false, true>(in, in_cols, nullptr, level_map, out,
                                    t_out, stream)
              : launch<false, false>(in, in_cols, nullptr, level_map, out,
                                     t_out, stream);
}
