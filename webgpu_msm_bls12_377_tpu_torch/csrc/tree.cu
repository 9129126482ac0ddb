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
// identity; LAST canonicalizes every output.
//
// Bound on this card: an aff node costs 2,873 word products (4 Montgomery
// products, 3 paired) for ~316 bytes moved (two 4-byte sorted_vals, two
// 104-byte table rows, one 156-byte node); a full node 3,549 for 468
// bytes.  At the HBM rate and the float32 multiply-add rate the two
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
#define SIGN_BIT 30
#define IDX_MASK ((1 << SIGN_BIT) - 1)

// Signed-table entry i of the sorted stream -> affine (x, y), Montgomery.
__device__ __forceinline__ void load_signed(u32 x[NW], u32 y[NW],
                                            const int32_t* table,
                                            const int32_t* sorted_vals,
                                            long long n_points, long long i) {
  const int32_t v = sorted_vals[i];
  const long long idx = v & IDX_MASK;
  const long long row = ((v >> SIGN_BIT) & 1) ? idx : idx + n_points;
  fe_load(x, table, 2 * n_points, 0, row);
  fe_load(y, table, 2 * n_points, NW, row);
}

template <bool AFF, bool LAST>
__global__ void __launch_bounds__(128)
    tree_level_kernel(const int32_t* __restrict__ in, long long in_cols,
                      const int32_t* __restrict__ sorted_vals,
                      const int32_t* __restrict__ level_map,
                      int32_t* __restrict__ out, long long t_out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= t_out) return;
  const int32_t e = level_map[p];
  G1 r;
  if (e & FLAG_INVALID) {
    g1_zero(r);
  } else {
    const long long a = e & CHILD_MASK;
    const bool single = (e & FLAG_SINGLE) != 0;
    if (AFF) {
      u32 x1[NW], y1[NW];
      load_signed(x1, y1, in, sorted_vals, in_cols, a);
      if (single) {
        g1_from_affine(r, x1, y1);
      } else {
        u32 x2[NW], y2[NW];
        load_signed(x2, y2, in, sorted_vals, in_cols, a + 1);
        g1_add_affine_lazy_pair(r, x1, y1, x2, y2);
      }
    } else {
      g1_load(r, in, in_cols, a);
      if (!single) {
        G1 b;
        g1_load(b, in, in_cols, a + 1);
        g1_add_lazy_pair(r, r, b);
      }
    }
  }
  if (LAST) g1_canon(r);
  g1_store(out, t_out, p, r);
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

// aff: in is the (26, 2N) signed table, in_cols = N (points per sign).
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

// full: in is the (39, in_cols) packed plane of the previous level.
extern "C" int msm_tree_level_full(const int32_t* in, long long in_cols,
                                   const int32_t* level_map, int32_t* out,
                                   long long t_out, int last,
                                   cudaStream_t stream) {
  return last ? launch<false, true>(in, in_cols, nullptr, level_map, out,
                                    t_out, stream)
              : launch<false, false>(in, in_cols, nullptr, level_map, out,
                                     t_out, stream);
}
