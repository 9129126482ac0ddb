// Kernel 2: one level of the packed bucket tree (the hybrid SMVP's levels
// 1..K, every level of the pure tree, and the fused path's fold of a
// bucket's pieces).  One thread per output node.
//
// Replaces ops/smvp_tree.py:run_tree_level of the JAX package (kernel body
// _tree_kernel_body_build), modes "aff" (level 1) and "full" (later
// levels).  Output node p of a level reads its children at childA =
// map[p] & CHILD and childA + 1 of the previous level:
//   aff:  the previous level is the sorted entry stream itself.  Child i
//         is sorted_vals[i] (point index | positive-sign bit 30), read
//         from the row-major signed table (curve.cuh: rows [0, N) hold the
//         points, rows [N, 2N) their negatives, 32 words a row).
//         Both-affine lazy add; a single child is promoted with
//         from_affine.
//   full: the previous level is a packed (39, T) plane of lazy projective
//         nodes.  Full lazy add; a single child is copied.
// FLAG_INVALID slots (past the level's real node count) write the
// identity.  The out mode picks the output: OUT_PLANE a (39|36, t_out)
// limb-major plane of lazy nodes, OUT_CANON the same canonicalized (the
// pure tree's last level), OUT_ROWS lazy nodes as (t_out, NODE_WORDS)
// rows (curve.cuh; the hybrid tree's last level, which the finish reads
// a node at a time).  Built for G1 and, with
// -DMSM_CURVE_ED, for Edwards (curve.cuh's vocabulary): rows then hold
// (x, y, t) and (-x, y, -t), nodes (36, T) extended points, and the adds
// are the hwcd forms.
//
// Bound on this card: a G1 aff node costs 2,873 word products (4
// Montgomery products, 3 paired) for ~344 bytes moved (two 4-byte
// sorted_vals, two 96-byte table rows, one 144-byte node: values below
// 20p < 2^382 need 12 of a coordinate's 13 words); a full node 3,549 for
// 432 bytes.  Edwards: 1,458 word products (9 products of 162) for ~328
// bytes (two 96-byte rows, one 128-byte node: values below 8p < 2^256
// need 8 of a coordinate's 9 words), a full node 1,620 for 384.  At the
// HBM rate and the float32 multiply-add rate the two limits are within
// 1.5x, bytes the larger.
//
// Level 1's children are points in sorted-bucket order, so their table
// rows are scattered over a table (268 MB at 2^20 G1) far larger than the
// 50 MB L2.  A limb-major table cost one 32-byte sector per word read (26
// or 27 a child); a row is 4 sectors (seven 16-byte loads,
// curve.cuh:load_signed_aff), which cut level 1 at 2^20 by 2.8x (G1) and
// 4.2x (Edwards) on an H100.  A persistent form that copied each thread's
// next child rows into a double-buffered shared-memory ring with cp.async
// while it added the current ones measured no faster on G1 (248
// registers: the same 2 blocks a SM) and ~19 % slower on Edwards (the
// 56 KB ring cost a block a SM), so each node keeps one thread.
//
// The full levels also fold the fused path's pieces
// (ops/smvp_kernel.py:fold_pieces).
#include "curve.cuh"

#define FLAG_INVALID (1 << 29)
#define FLAG_SINGLE (1 << 30)
#define CHILD_MASK (FLAG_INVALID - 1)

#define THREADS 128
#define OUT_PLANE 0
#define OUT_CANON 1
#define OUT_ROWS 2

template <bool AFF, int OUT>
__global__ void __launch_bounds__(THREADS)
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
  if (OUT == OUT_CANON) pt_canon(r);
  if (OUT == OUT_ROWS)
    pt_store_row(out, p, r);
  else
    pt_store(out, t_out, p, r);
}

template <bool AFF, int OUT>
static int launch(const int32_t* in, long long in_cols,
                  const int32_t* sorted_vals, const int32_t* level_map,
                  int32_t* out, long long t_out, cudaStream_t stream) {
  if (t_out == 0) return 0;
  const long long blocks = (t_out + THREADS - 1) / THREADS;
  tree_level_kernel<AFF, OUT><<<(unsigned)blocks, THREADS, 0, stream>>>(
      in, in_cols, sorted_vals, level_map, out, t_out);
  return MSM_LAUNCH_STATUS();
}

template <bool AFF>
static int launch_mode(const int32_t* in, long long in_cols,
                       const int32_t* sorted_vals, const int32_t* level_map,
                       int32_t* out, long long t_out, int out_mode,
                       cudaStream_t stream) {
  switch (out_mode) {
    case OUT_PLANE:
      return launch<AFF, OUT_PLANE>(in, in_cols, sorted_vals, level_map, out,
                                    t_out, stream);
    case OUT_CANON:
      return launch<AFF, OUT_CANON>(in, in_cols, sorted_vals, level_map, out,
                                    t_out, stream);
    case OUT_ROWS:
      return launch<AFF, OUT_ROWS>(in, in_cols, sorted_vals, level_map, out,
                                   t_out, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// aff: table is the (2N, 32) signed table, n_points = N.
extern "C" int msm_tree_level_aff(const int32_t* table, long long n_points,
                                  const int32_t* sorted_vals,
                                  const int32_t* level_map, int32_t* out,
                                  long long t_out, int out_mode,
                                  cudaStream_t stream) {
  return launch_mode<true>(table, n_points, sorted_vals, level_map, out,
                           t_out, out_mode, stream);
}

// full: in is the (39|36, in_cols) packed plane of the previous level.
extern "C" int msm_tree_level_full(const int32_t* in, long long in_cols,
                                   const int32_t* level_map, int32_t* out,
                                   long long t_out, int out_mode,
                                   cudaStream_t stream) {
  return launch_mode<false>(in, in_cols, nullptr, level_map, out, t_out,
                            out_mode, stream);
}
