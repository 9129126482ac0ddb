// Kernel 1: the Montgomery entry of the point prep (msm_point_prep) and
// the Montgomery exit of the window sums (msm_mont_mul_const).
//
// Replaces ops/pallas_kernels.py:mont_mul_const of the JAX package (row
// 1), and for Edwards also the XLA product t = x*y of its
// models/cuzk.py:mont_point_table (row 1e+), which runs outside any
// Pallas kernel.  Built for G1 (13 words) and, with -DMSM_CURVE_ED, for
// Edwards (9 words), on the carry-chain product (field.cuh; -DMSM_MONT_C
// builds the C form).
//
// The entry.  For any v < R and y < p, REDC(v * y) < y + p < 2p, so one
// conditional subtract of p makes REDC(v * (R^2 mod p)) canonical: a wire
// coordinate (12 or 8 words, the top word of the 13 or 9 zero) enters the
// Montgomery domain in one product.  Edwards adds t = REDC(x_m * y_m) <
// p^2 / R + p < 2p, canonical after one subtract.  One thread a point
// reads the wire words as they arrive, in either layout, given by three
// strides (coordinate, word, point): the (2, k, N) word-major arrays
// (coalesced 4-byte loads) or the (N, 2k) point-major words of a wire
// buffer (a point's 96 or 64 bytes as six or four 16-byte loads).  It
// writes the form the path reads, in one pass:
//   SIGNED: rows j and N + j of the (2N, 32) int32 signed table
//     (ops/kernels.py:build_signed_table): G1 (x, y) and (x, -y), Edwards
//     (x, y, t) and (-x, y, -t), -0 = 0, the pad words zero (the table
//     needs no zero fill).  A thread's 128-byte rows land in shared memory
//     first, and the block writes its 128 rows of each half as one
//     contiguous 16 KB run of 16-byte stores: a thread storing its own row
//     put a warp's stores 128 bytes apart, and the table's write took 0.30
//     ms at 2^20 where the Montgomery table's took 0.13 (PERF.md);
//   PLANE: the (26|27, N) Montgomery table (x; y[; t]) of the fused,
//     legacy and naive paths.
// Work a point: 676 word products (G1, 2 x 2 x 13^2) or 486 (Edwards, 3 x
// 2 x 9^2) for 352 or 320 bytes moved in SIGNED mode: bound by bytes at
// the HBM rate, about level with the measured rate of the carry-chain
// product (PERF.md).  So the design moves each byte once: no zero word
// appended in memory, no separate product for t, no negation pass, no
// zero fill of the table.
//
// The exit.  REDC(a * y) lane-wise for a constant y < p (y = 1 on the
// window sums), canonical; limb-major planes, coalesced.  Both entries
// take their constant by value (a kernel parameter, in the constant
// bank: no copy to the card).
#ifndef MSM_MONT_C
#define MSM_MONT_CHAIN
#endif
#include "field.cuh"

#define PREP_THREADS 128
// words of a wire coordinate: the field's words but the top one
#define WIRE_WORDS (NW - 1)
// words of a signed-table row (ops/kernels.py ROW_WORDS)
#define ROW_WORDS 32
// words of a row staged in shared memory: 16-byte aligned, and eight
// threads' 16-byte accesses at this stride fall in distinct banks
#define STAGE_ROW 36
#define PREP_SIGNED 0
#define PREP_PLANE 1
#ifdef MSM_CURVE_ED
#define AFF_COORDS 3
#else
#define AFF_COORDS 2
#endif

struct FieldWords {
  u32 w[NW];
};

// the wire words of point j -> x, y (NW words each, the top one zero)
template <bool POINT_MAJOR>
__device__ __forceinline__ void load_wire(u32 x[NW], u32 y[NW],
                                          const int32_t* __restrict__ words,
                                          long long j, long long s_coord,
                                          long long s_word,
                                          long long s_point) {
  if (POINT_MAJOR) {
    u32 v[2 * WIRE_WORDS];
    const int4* src = reinterpret_cast<const int4*>(words + j * s_point);
#pragma unroll
    for (int q = 0; q < 2 * WIRE_WORDS / 4; ++q) {
      const int4 u = __ldg(src + q);
      v[4 * q] = (u32)u.x;
      v[4 * q + 1] = (u32)u.y;
      v[4 * q + 2] = (u32)u.z;
      v[4 * q + 3] = (u32)u.w;
    }
#pragma unroll
    for (int w = 0; w < WIRE_WORDS; ++w) {
      x[w] = v[w];
      y[w] = v[WIRE_WORDS + w];
    }
  } else {
    const int32_t* src = words + j * s_point;
#pragma unroll
    for (int w = 0; w < WIRE_WORDS; ++w) {
      x[w] = (u32)__ldg(src + w * s_word);
      y[w] = (u32)__ldg(src + s_coord + w * s_word);
    }
  }
  x[NW - 1] = 0u;
  y[NW - 1] = 0u;
}

// REDC(v * y) mod p for v < R, y < p
__device__ __forceinline__ void mont_entry(u32 r[NW], const u32 v[NW],
                                           const u32 y[NW]) {
  mont_mul(r, v, y);
  fe_csub(r, MSM_P);
}

// a thread's 128-byte row into its slot of the block's staged rows
__device__ __forceinline__ void stage_row(u32* stage, const u32 row[ROW_WORDS]) {
  int4* dst = reinterpret_cast<int4*>(stage + threadIdx.x * STAGE_ROW);
#pragma unroll
  for (int q = 0; q < ROW_WORDS / 4; ++q)
    dst[q] = make_int4((int)row[4 * q], (int)row[4 * q + 1],
                       (int)row[4 * q + 2], (int)row[4 * q + 3]);
}

// the block's `count` staged rows -> rows [0, count) of dst, 16-byte stores
// at consecutive addresses
__device__ __forceinline__ void store_rows(int32_t* dst, const u32* stage,
                                           int count) {
  int4* out = reinterpret_cast<int4*>(dst);
  for (int i = threadIdx.x; i < count * (ROW_WORDS / 4); i += PREP_THREADS)
    out[i] = *reinterpret_cast<const int4*>(
        stage + (i / (ROW_WORDS / 4)) * STAGE_ROW + 4 * (i % (ROW_WORDS / 4)));
}

template <bool POINT_MAJOR, int OUT>
__global__ void __launch_bounds__(PREP_THREADS)
    point_prep_kernel(const int32_t* __restrict__ words,
                      int32_t* __restrict__ out, long long n,
                      long long s_coord, long long s_word, long long s_point,
                      FieldWords r2) {
  const long long first = (long long)blockIdx.x * PREP_THREADS;
  const long long j = first + threadIdx.x;
  const bool live = j < n;
  u32 c[AFF_COORDS][NW];
  if (live) {
    u32 y2[NW], x[NW], y[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) y2[w] = r2.w[w];
    load_wire<POINT_MAJOR>(x, y, words, j, s_coord, s_word, s_point);
    mont_entry(c[0], x, y2);
    mont_entry(c[1], y, y2);
#ifdef MSM_CURVE_ED
    mont_entry(c[2], c[0], c[1]);
#endif
  }
  if constexpr (OUT == PREP_PLANE) {
    if (live) {
#pragma unroll
      for (int k = 0; k < AFF_COORDS; ++k)
#pragma unroll
        for (int w = 0; w < NW; ++w)
          out[(k * NW + w) * n + j] = (int32_t)c[k][w];
    }
  } else {
    __shared__ __align__(16) u32 stage[PREP_THREADS * STAGE_ROW];
    const int count = (int)min((long long)PREP_THREADS, n - first);
    u32 row[ROW_WORDS];
    if (live) {
#pragma unroll
      for (int k = 0; k < AFF_COORDS; ++k)
#pragma unroll
        for (int w = 0; w < NW; ++w) row[k * NW + w] = c[k][w];
#pragma unroll
      for (int w = AFF_COORDS * NW; w < ROW_WORDS; ++w) row[w] = 0u;
      stage_row(stage, row);
    }
    __syncthreads();
    store_rows(out + first * ROW_WORDS, stage, count);
    __syncthreads();
    if (live) {
      // the negative: G1 (x, -y), Edwards (-x, y, -t)
#ifdef MSM_CURVE_ED
      fe_neg_mod(row, c[0]);
      fe_neg_mod(row + 2 * NW, c[2]);
#else
      fe_neg_mod(row + NW, c[1]);
#endif
      stage_row(stage, row);
    }
    __syncthreads();
    store_rows(out + (n + first) * ROW_WORDS, stage, count);
  }
}

template <bool POINT_MAJOR>
static void launch_prep(int mode, unsigned blocks, cudaStream_t stream,
                        const int32_t* words, int32_t* out, long long n,
                        long long s_coord, long long s_word, long long s_point,
                        const FieldWords& r2) {
  if (mode == PREP_PLANE)
    point_prep_kernel<POINT_MAJOR, PREP_PLANE>
        <<<blocks, PREP_THREADS, 0, stream>>>(words, out, n, s_coord, s_word,
                                              s_point, r2);
  else
    point_prep_kernel<POINT_MAJOR, PREP_SIGNED>
        <<<blocks, PREP_THREADS, 0, stream>>>(words, out, n, s_coord, s_word,
                                              s_point, r2);
}

// words: int32 wire words, word w of coordinate c of point j at
// words[c * s_coord + w * s_word + j * s_point]; the point-major strides
// (WIRE_WORDS, 1, 2 WIRE_WORDS) on a 16-byte aligned buffer take the
// 16-byte loads.  out: (2n, ROW_WORDS) (mode SIGNED) or (AFF_COORDS NW,
// n) (mode PLANE).  r2_host: R^2 mod p, NW words.
extern "C" int msm_point_prep(const int32_t* words, int32_t* out, long long n,
                              long long s_coord, long long s_word,
                              long long s_point, int mode,
                              const uint32_t* r2_host, cudaStream_t stream) {
  if (mode != PREP_SIGNED && mode != PREP_PLANE)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  FieldWords r2;
  for (int w = 0; w < NW; ++w) r2.w[w] = r2_host[w];
  const unsigned blocks = (unsigned)((n + PREP_THREADS - 1) / PREP_THREADS);
  const bool point_major = s_coord == WIRE_WORDS && s_word == 1 &&
                           s_point == 2 * WIRE_WORDS &&
                           ((uintptr_t)words & 15) == 0;
  if (point_major)
    launch_prep<true>(mode, blocks, stream, words, out, n, s_coord, s_word,
                      s_point, r2);
  else
    launch_prep<false>(mode, blocks, stream, words, out, n, s_coord, s_word,
                       s_point, r2);
  return MSM_LAUNCH_STATUS();
}

// a, out: (groups * NW, n) planes; element (g, j) is rows g*NW.., column j
__global__ void mont_mul_const_kernel(const int32_t* __restrict__ a,
                                      int32_t* __restrict__ out,
                                      long long groups, long long n,
                                      FieldWords y) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= groups * n) return;
  const long long g = e / n, j = e % n;
  const int32_t* src = a + g * NW * n;
  u32 x[NW], c[NW], r[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    x[w] = (u32)src[w * n + j];
    c[w] = y.w[w];
  }
  mont_entry(r, x, c);
  int32_t* dst = out + g * NW * n;
#pragma unroll
  for (int w = 0; w < NW; ++w) dst[w * n + j] = (int32_t)r[w];
}

extern "C" int msm_mont_mul_const(const int32_t* a, int32_t* out,
                                  const uint32_t* y_host, long long groups,
                                  long long n, cudaStream_t stream) {
  const long long total = groups * n;
  if (total == 0) return 0;
  FieldWords y;
  for (int w = 0; w < NW; ++w) y.w[w] = y_host[w];
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  mont_mul_const_kernel<<<(unsigned)blocks, threads, 0, stream>>>(a, out, groups,
                                                                 n, y);
  return MSM_LAUNCH_STATUS();
}
