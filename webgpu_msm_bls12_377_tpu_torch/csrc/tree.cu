// Kernel 2: one level of the packed bucket tree (the hybrid SMVP's levels
// 1..K, every level of the pure tree), and the fold of every bucket's
// pieces in one launch (the fused path's, and the hybrid finish's of the
// buckets it cut).  One thread per output node.
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
// HBM rate and the float32 multiply-add rate (33.5e12 word products/s) the
// two limits are within 1.5x, bytes the larger: at 2^20 G1 0.88 ms for
// level 1 and 0.57 for level 2.  At the rate at which the card runs this
// source's Montgomery product on its own, 6.2-6.4e12 word products/s on
// an H100 for either field (msm_word_rate below, chip_smoke.py phase 4),
// products bound them: G1 3.8 and 2.3 ms, Edwards 1.9 and 1.1, against
// 4.5, 3.0, 2.0 and 1.2 measured (PERF.md).
//
// What held the full levels back was the product, not the memory: their
// reads are coalesced and their adds independent, one a thread, yet they
// ran no faster per word product than the chained kernels.  So this source
// builds the carry-chain Montgomery product (field.cuh, MSM_MONT_CHAIN:
// two 32-bit multiply-adds a word product, two independent carry chains a
// step; one G1 product 672 SASS instructions against the C form's 1,296),
// which halved level 2 at 2^20 on an H100 (G1 6.8-6.9 to 3.2-3.3 ms at 2
// blocks a SM, 3.0 at 3; Edwards 1.9 to 1.2) and level 1 with it (9.7-10.2
// to 4.5; 3.3 to 2.0), and gives the full levels a register budget
// (__launch_bounds__(THREADS,
// TREE_FULL_MIN_BLOCKS), the fastest of 2, 3 and 4 blocks a SM in
// tools/row_times.py's sweep).  -DMSM_MONT_C builds the C form instead,
// for that tool's comparison.
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
// The fold (msm_fold_pieces, ops/smvp_kernel.py:fold_pieces) runs the full
// level's pairing for every bucket of the fused path in one launch, one
// block a bucket: node i of a level is node 2i + node 2i+1 of the one
// before, an odd last node carried up, the last node canonicalized, the
// same adds in the same order as the level-by-level plain form.  A level
// of more than FOLD_SMEM_NODES nodes lives in the bucket's own columns of
// a scratch plane (in L2 at the fused path's sizes), a smaller one in
// dynamic shared memory.  Each bucket runs only its own levels: no level
// maps, no padding levels, one launch where the level loop made one a
// level.  The hybrid finish (msm_fold_split, ops/smvp_stream.py) folds
// the buckets its piece pass (packed.cu) cut into two or more pieces,
// listed in slots whose count stays on the card: a fixed grid of blocks
// walks the slots, so no host reads the count, and a finish with no long
// bucket pays an empty launch.  A slot of at most
// smvp_stream.FOLD_LONE = 8 pieces (the caller's argument) is folded whole
// by one thread (fold_lone, the same pairing), neighbouring threads taking
// neighbouring slots; a longer one by a block as above.  Uniform 2^24 scalars cut every one of a set's
// ~2^19 buckets (~128 level-2 nodes, 3 pieces of PIECE = 48): a block a
// slot, one or two threads of 64 busy, folded them in 60-64 ms on an
// H100, ~100x the 0.6 ms the products bound; one thread a slot takes 3.3
// ms, most of it the top window's ~4,780 buckets of ~19 pieces, which
// stay on the block fold.  zipf_2p18 cuts ~2,200, 18 % of them longer
// than 8: its fold is paced by each window's top bucket of 347
// pieces and fell from 0.59 to 0.41 ms (G1; Edwards 0.19 to 0.16; PERF.md).
// 8 pieces against 4, 16 and 32: the fastest at zipf_2p18, within 8 %
// at 2^24 but for 32, which folds the top window alone (2.1 ms) and costs
// zipf_2p18 0.46 ms.
#ifndef MSM_MONT_C
#define MSM_MONT_CHAIN
#endif
#include "curve.cuh"

#define FLAG_INVALID (1 << 29)
#define FLAG_SINGLE (1 << 30)
#define CHILD_MASK (FLAG_INVALID - 1)

#define THREADS 128
// blocks a SM the full levels' registers leave room for: 3 ran 6 % faster
// than 2 on G1 at 2^20 (168 registers and 272 bytes spilled against 212
// and none) and 4 40 % slower (128 registers, 868 bytes spilled); Edwards
// takes 116 registers at each (tools/row_times.py --variants, PERF.md)
#ifndef TREE_FULL_MIN_BLOCKS
#define TREE_FULL_MIN_BLOCKS 3
#endif
#define OUT_PLANE 0
#define OUT_CANON 1
#define OUT_ROWS 2

template <bool AFF, int OUT>
__global__ void __launch_bounds__(THREADS, AFF ? 1 : TREE_FULL_MIN_BLOCKS)
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

// -- The fold of the fused path's pieces --------------------------------------

#define FOLD_THREADS 64
// a level of at most this many nodes lives in shared memory (two halves:
// a level and the one before it)
#define FOLD_SMEM_NODES 64
#define FOLD_SMEM_BYTES (2 * FOLD_SMEM_NODES * (int)sizeof(Point))
// blocks of the hybrid finish's fold, more than the card holds at once
// (4 a SM on G1 and 8 on Edwards on an H100, bound by registers: the block
// fold's shared memory costs none): the lone pass's 2^17 threads fill the
// card, and a skewed finish's few hundred long slots take one block each
// (a grid of what the card holds, 528 blocks, put two windows' top
// buckets in one block and slowed zipf_2p18's fold to 0.97 ms)
#define FOLD_SPLIT_GRID 2048
// the most pieces of a slot the hybrid finish may fold on one thread (its
// caller gives the count, ops/smvp_stream.py:FOLD_LONE)
#define FOLD_LONE_MAX 32
// a lone fold's stack of partial sums: at most bit_width(FOLD_LONE_MAX)
// levels
__host__ __device__ constexpr int fold_lone_depth(int c) {
  return c ? 1 + fold_lone_depth(c >> 1) : 0;
}
#define FOLD_LONE_DEPTH fold_lone_depth(FOLD_LONE_MAX)

// The add sits in a __noinline__ helper: nvcc 12.8's cicc crashes on a
// runtime-length loop around an inlined point add.
__device__ __noinline__ void fold_add(Point& r, const Point& q) {
  pt_add_lazy(r, r, q);
}

// Node i of a bucket's level k of ck nodes: level 0 is the piece sums
// (columns off.. of the sums plane), a level of more than FOLD_SMEM_NODES
// nodes sits in the scratch plane at column off (k odd) or off + c1 (k
// even, c1 = level 1's size: ceil(c/2) + ceil(c/4) <= c, so both stay in
// the bucket's own columns and never overlap), a smaller one in shared
// memory half k & 1.
struct FoldLevels {
  const int32_t* sums;
  int32_t* scratch;
  long long cols, off, c1;
  Point* smem;

  __device__ __forceinline__ long long col(int k, long long i) const {
    return off + ((k & 1) ? 0 : c1) + i;
  }
  __device__ __forceinline__ void load(Point& r, int k, long long ck,
                                       long long i) const {
    if (k == 0)
      pt_load(r, sums, cols, off + i);
    else if (ck <= FOLD_SMEM_NODES)
      r = smem[(k & 1) * FOLD_SMEM_NODES + i];
    else
      pt_load(r, scratch, cols, col(k, i));
  }
  __device__ __forceinline__ void store(int k, long long ck, long long i,
                                        const Point& r) const {
    if (ck <= FOLD_SMEM_NODES)
      smem[(k & 1) * FOLD_SMEM_NODES + i] = r;
    else
      pt_store(scratch, cols, col(k, i), r);
  }
};

// Fold one bucket of c pieces (columns off.. of sums) and store its
// canonical sum at column col of out.  The caller's block runs it whole.
__device__ __forceinline__ void fold_bucket(const int32_t* sums,
                                            long long cols, long long c,
                                            long long off, int32_t* scratch,
                                            int32_t* out, long long nb,
                                            long long col, Point* smem) {
  const FoldLevels lv{sums, scratch, cols, off, (c + 1) >> 1, smem};
  int k = 0;
  while (c > 1) {
    const long long cn = (c + 1) >> 1;
    for (long long i = threadIdx.x; i < cn; i += FOLD_THREADS) {
      Point r;
      lv.load(r, k, c, 2 * i);
      if (2 * i + 1 < c) {
        Point q;
        lv.load(q, k, c, 2 * i + 1);
        fold_add(r, q);
      }
      lv.store(k + 1, cn, i, r);
    }
    __syncthreads();
    c = cn;
    ++k;
  }
  if (threadIdx.x == 0) {
    Point r;
    if (c == 0)
      pt_zero(r);
    else
      lv.load(r, k, 1, 0);
    pt_canon(r);
    pt_store(out, nb, col, r);
  }
}

// Fold a slot of 2..FOLD_LONE_MAX pieces (columns off.. of sums) on the calling
// thread alone and store its canonical sum at column col of out.  A stack
// of partial sums by level: each piece enters at level 0 and merges with
// the top while the top is of its level (node 2i + node 2i+1, the left
// operand first); what is left merges from the top down, which is the
// carry of an odd last node up each level: the same adds, operands in the
// same order, as fold_bucket and the plain form.
__device__ __forceinline__ void fold_lone(const int32_t* sums, long long cols,
                                          int c, long long off, int32_t* out,
                                          long long nb, long long col) {
  Point st[FOLD_LONE_DEPTH];
  int lv[FOLD_LONE_DEPTH];
  int top = 0;
  for (int j = 0; j < c; ++j) {
    Point q;
    pt_load(q, sums, cols, off + j);
    int k = 0;
    while (top > 0 && lv[top - 1] == k) {
      --top;
      fold_add(st[top], q);
      q = st[top];
      ++k;
    }
    st[top] = q;
    lv[top++] = k;
  }
  Point r = st[--top];
  while (top > 0) {
    --top;
    fold_add(st[top], r);
    r = st[top];
  }
  pt_canon(r);
  pt_store(out, nb, col, r);
}

// SPLIT false (the fused path): block b folds bucket b into column b.
// SPLIT true (the hybrid finish): the buckets are the first *live of the
// slots, slot s's sum goes to column dst[s].  Block b folds the slots of
// more than lone pieces among b, + gridDim.x, ..., looking at
// FOLD_THREADS of them at a time; then its thread t folds those of at most
// lone among (gridDim.x - 1 - b) * FOLD_THREADS + t, + gridDim.x *
// FOLD_THREADS, ...  Long slots first and the lone pass from the last
// block down: where the slots are fewer than the grid's threads (a skewed
// 2^18 finish cuts ~2,200), the lone ones land on the last blocks, which
// hold no long slot, and the blocks of the long slots (each window's top
// ranks) start them at once and take no lone slot.  Where folded is not
// null, the slots folded on one thread are added to *folded.
template <bool SPLIT>
__global__ void __launch_bounds__(FOLD_THREADS)
    fold_pieces_kernel(const int32_t* __restrict__ sums, long long cols,
                       const int32_t* __restrict__ counts,
                       const int32_t* __restrict__ offsets,
                       const int32_t* __restrict__ dst,
                       const long long* __restrict__ live,
                       int32_t* __restrict__ scratch,
                       int32_t* __restrict__ out, long long nb, int lone,
                       unsigned long long* __restrict__ folded) {
  extern __shared__ __align__(16) unsigned char fold_smem[];
  Point* smem = reinterpret_cast<Point*>(fold_smem);
  if (!SPLIT) {
    const long long b = blockIdx.x;
    fold_bucket(sums, cols, counts[b], offsets[b], scratch, out, nb, b, smem);
    return;
  }
  const long long n = *live;
  const long long g = gridDim.x;
  for (long long base = blockIdx.x; base < n; base += g * FOLD_THREADS) {
    const long long mine = base + threadIdx.x * g;
    if (!__syncthreads_or(mine < n && counts[mine] > lone)) continue;
    for (int t = 0; t < FOLD_THREADS; ++t) {
      const long long s = base + t * g;
      if (s >= n) break;
      if (counts[s] <= lone) continue;
      fold_bucket(sums, cols, counts[s], offsets[s], scratch, out, nb, dst[s],
                  smem);
      // thread 0 may still read the last level from shared memory
      __syncthreads();
    }
  }
  unsigned long long mine = 0;
  for (long long s = (g - 1 - blockIdx.x) * FOLD_THREADS + threadIdx.x; s < n;
       s += g * FOLD_THREADS) {
    const int c = counts[s];
    if (c <= lone) {
      fold_lone(sums, cols, c, offsets[s], out, nb, dst[s]);
      ++mine;
    }
  }
  if (folded && mine) atomicAdd(folded, mine);
}

template <bool SPLIT>
static int fold_launch(unsigned blocks, const int32_t* sums, long long cols,
                       const int32_t* counts, const int32_t* offsets,
                       const int32_t* dst, const long long* live,
                       int32_t* scratch, int32_t* out, long long nb,
                       int lone, unsigned long long* folded,
                       cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        fold_pieces_kernel<SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FOLD_SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  fold_pieces_kernel<SPLIT><<<blocks, FOLD_THREADS, FOLD_SMEM_BYTES, stream>>>(
      sums, cols, counts, offsets, dst, live, scratch, out, nb, lone, folded);
  return MSM_LAUNCH_STATUS();
}

// sums: the (39|36, cols) plane of piece sums; bucket b's counts[b] pieces
// sit in columns offsets[b].. (disjoint, as the piece plan lays them out);
// scratch: a plane of the same shape, overwritten; out: (39|36, nb),
// column b bucket b's canonical sum (the identity for an empty bucket).
extern "C" int msm_fold_pieces(const int32_t* sums, long long cols,
                               const int32_t* counts, const int32_t* offsets,
                               int32_t* scratch, int32_t* out, long long nb,
                               cudaStream_t stream) {
  if (nb == 0) return 0;
  return fold_launch<false>((unsigned)nb, sums, cols, counts, offsets,
                            nullptr, nullptr, scratch, out, nb, 0, nullptr,
                            stream);
}

// The hybrid finish's fold (ops/smvp_stream.py:packed_finish): sums and
// scratch as above, cols of them; slots: the length of counts, offsets and
// dst, whose first *live entries are the buckets cut into two or more
// pieces; slot s's canonical sum goes to column dst[s] of out (39|36, nb),
// which no other slot and no single-piece bucket writes.  A slot of at
// most lone (0..FOLD_LONE_MAX) pieces is folded on one thread, a longer
// one by a block.  folded: null, or one word set to the number of slots
// folded on one thread; zeroing it is a memset, not a kernel launch.
extern "C" int msm_fold_split(const int32_t* sums, long long cols,
                              const int32_t* counts, const int32_t* offsets,
                              const int32_t* dst, const long long* live,
                              int32_t* scratch, int32_t* out, long long nb,
                              long long slots, int lone, long long* folded,
                              cudaStream_t stream) {
  if (lone < 0 || lone > FOLD_LONE_MAX) return (int)cudaErrorInvalidValue;
  if (folded) {
    const cudaError_t z = cudaMemsetAsync(folded, 0, sizeof(*folded), stream);
    if (z != cudaSuccess) return (int)z;
  }
  if (slots == 0) return 0;
  const long long blocks = slots < FOLD_SPLIT_GRID ? slots : FOLD_SPLIT_GRID;
  return fold_launch<true>((unsigned)blocks, sums, cols, counts, offsets, dst,
                           live, scratch, out, nb, lone,
                           reinterpret_cast<unsigned long long*>(folded),
                           stream);
}

// -- The product itself, lane-wise ----------------------------------------------

// prod = REDC(a*b) and pair = REDC(a*b + c*d), mod R, lane-wise over
// (NW, n) planes: this source's Montgomery products on their own, for the
// tests and chip_smoke.py to hold against ops/field.py at extreme operands.
__global__ void __launch_bounds__(THREADS)
    field_mul_lanes_kernel(const int32_t* __restrict__ a,
                           const int32_t* __restrict__ b,
                           const int32_t* __restrict__ c,
                           const int32_t* __restrict__ d,
                           int32_t* __restrict__ prod,
                           int32_t* __restrict__ pair, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  u32 x[NW], y[NW], z[NW], w[NW], r[NW];
  fe_load(x, a, n, 0, j);
  fe_load(y, b, n, 0, j);
  fe_load(z, c, n, 0, j);
  fe_load(w, d, n, 0, j);
  mont_mul(r, x, y);
  fe_store(prod, n, 0, j, r);
  mont_mul_pair(r, x, y, z, w);
  fe_store(pair, n, 0, j, r);
}

extern "C" int msm_field_mul_lanes(const int32_t* a, const int32_t* b,
                                   const int32_t* c, const int32_t* d,
                                   int32_t* prod, int32_t* pair, long long n,
                                   cudaStream_t stream) {
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  field_mul_lanes_kernel<<<blocks, THREADS, 0, stream>>>(a, b, c, d, prod,
                                                        pair, n);
  return MSM_LAUNCH_STATUS();
}

// -- The card's word-product rate -----------------------------------------------

#define RATE_THREADS 256

// Each thread runs `iters` dependent carry-chain Montgomery products, x =
// REDC(x * y) (exact for any operands below R): 2 NW^2 word products each
// (a*b and m*p), in the mad.lo / mad.hi chains of field.cuh, with no memory
// traffic but the final store.  Launched with many blocks a SM, the word
// products over the time give the rate at which the card runs this
// source's product on its own (chip_smoke.py phase 4): the integer-rate
// bound of every kernel that adds points.  A loop of the bare chains ran
// slower (2.9-3.4e12 word products/s on an H100, below what the full
// levels reach), as it misses the wide multiplies ptxas forms from a
// product's pairs of halves.  The result is meaningless; it is stored so
// that nothing is optimized away.
__global__ void __launch_bounds__(RATE_THREADS)
    word_rate_kernel(int32_t* __restrict__ out, int iters) {
  const u32 seed = blockIdx.x * RATE_THREADS + threadIdx.x;
  u32 x[NW], y[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    x[k] = seed * 2654435761u + k * 40503u + 1u;
    y[k] = x[k] ^ 0x9e3779b9u;
  }
  for (int it = 0; it < iters; ++it) {
    u32 r[NW];
    mont_mul(r, x, y);
    fe_copy(x, r);
  }
  u32 s = 0u;
#pragma unroll
  for (int k = 0; k < NW; ++k) s ^= x[k];
  out[seed] = (int32_t)s;
}

// out: blocks * RATE_THREADS words.  Returns the launch status; the word
// products are blocks * RATE_THREADS * iters * 2 * NW * NW.
extern "C" int msm_word_rate(int32_t* out, long long blocks, int iters,
                             cudaStream_t stream) {
  if (blocks == 0) return 0;
  word_rate_kernel<<<(unsigned)blocks, RATE_THREADS, 0, stream>>>(out, iters);
  return MSM_LAUNCH_STATUS();
}
