// Point formulas shared by every kernel, for the curve a source is built
// for: BLS12-377 G1 by default, Twisted Edwards BLS12 with -DMSM_CURVE_ED
// (params.cuh picks the field to match).
//
// G1: complete projective formulas of Renes-Costello-Batina 2016 (a = 0,
// b3 = 3), Montgomery form, in the exact operation order of
// ops/curve.py:G1Ops (the plain PyTorch forms).  Lazy forms: comments give
// value bounds in units of p ("b<=k": value < k*p); REDC outputs stay
// below 2p because R/p ~ 2^39 dwarfs every bound product used here (at
// most 304).
//
// Edwards (a = -1, d = 3021): the unified extended hwcd formulas, in the
// exact operation order of ops/curve.py:EdwardsOps.  Lazy forms:
// coordinates handed on stay below 2p, REDC inputs reach bound products
// of 48 at most against R/p ~ 5.9e10.  No paired-product form.
//
// Canonical forms of both curves (pt_add, pt_add_mixed, pt_double) take
// and return coordinates below p and reduce after every field operation:
// the product is mont_mul_mod (REDC of canonical inputs lands below 2p,
// one conditional subtract brings it below p), sums and differences are
// fe_add_mod and fe_sub_mod, so canonical values have one representation
// and a kernel equals its plain form bit for bit.
//
// Every kernel is written against one vocabulary that both curves define:
// Point, Affine, pt_zero, pt_from_affine, pt_add_affine_lazy,
// pt_add_mixed_lazy, pt_add_lazy, pt_double_lazy, pt_canon, pt_add,
// pt_add_mixed, pt_double, pt_add_coop, pt_neg_affine, pt_load, pt_store
// and aff_load; the row loaders at the end (aff_load_row, load_signed_aff)
// serve both.
#pragma once
#include "field.cuh"

// Column j of a merged (k*NW, ncols) limb-major plane: coordinate c, word
// w at row c*NW + w.  Neighbouring threads read neighbouring columns, so
// every row load is coalesced.
__device__ __forceinline__ void fe_load(u32 r[NW], const int32_t* plane,
                                        size_t ncols, int row0, size_t j) {
#pragma unroll
  for (int w = 0; w < NW; ++w) r[w] = (u32)plane[(size_t)(row0 + w) * ncols + j];
}

__device__ __forceinline__ void fe_store(int32_t* plane, size_t ncols,
                                         int row0, size_t j,
                                         const u32 a[NW]) {
#pragma unroll
  for (int w = 0; w < NW; ++w) plane[(size_t)(row0 + w) * ncols + j] = (int32_t)a[w];
}

__device__ __forceinline__ void fe_sel(u32 r[NW], bool c, const u32 a[NW],
                                       const u32 b[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r[i] = c ? a[i] : b[i];
}

// pt_add_coop: pt_add run by a group of PT_COOP threads, a thread a product
// of each stage of the formula, the stages' values passed through the
// group's PT_COOP_SCRATCH elements of shared memory.  Every value is the
// field element pt_add computes, and a canonical value has one
// representation: the same words as pt_add.  A change to pt_add's formula
// is made in pt_add_coop too.
#define PT_COOP 8
#define PT_COOP_SCRATCH 12

// A sorted entry stream holds point index | positive-sign bit 30; the
// signed table's rows [0, N) hold the points, [N, 2N) their negatives.
#define SIGN_BIT 30
#define IDX_MASK ((1 << SIGN_BIT) - 1)

__device__ __forceinline__ long long signed_col(const int32_t* sorted_vals,
                                                long long n_points,
                                                long long i) {
  const int32_t v = sorted_vals[i];
  const long long idx = v & IDX_MASK;
  return ((v >> SIGN_BIT) & 1) ? idx : idx + n_points;
}

#ifndef MSM_CURVE_ED

struct G1 {
  u32 x[NW], y[NW], z[NW];
};
typedef G1 Point;
// affine addend (x, y), canonical; z = 1 implicit
struct Affine {
  u32 x[NW], y[NW];
};

// Identity (0 : 1 : 0), Montgomery form.
__device__ __forceinline__ void pt_zero(Point& r) {
  fe_zero(r.x);
  fe_set_const(r.y, MSM_ONE_MONT);
  fe_zero(r.z);
}

__device__ __forceinline__ void pt_from_affine(Point& r, const Affine& a) {
  fe_copy(r.x, a.x);
  fe_copy(r.y, a.y);
  fe_set_const(r.z, MSM_ONE_MONT);
}

// Both-affine add (Z1 = Z2 = 1), canonical inputs, outputs b<=2.
__device__ __forceinline__ void pt_add_affine_lazy(Point& r, const Affine& a,
                                                   const Affine& b) {
  const u32 *X1 = a.x, *Y1 = a.y, *X2 = b.x, *Y2 = b.y;
  u32 t0[NW], t1[NW], t3[NW], t4[NW], Y3[NW], Z3[NW], u[NW];
  mont_mul(t0, X1, X2);             // b<=2
  mont_mul(t1, Y1, Y2);             // b<=2
  fe_add(t3, X2, Y2);               // b<=2
  fe_add(t4, X1, Y1);               // b<=2
  mont_mul(t3, t3, t4);             // 4 -> b<=2
  fe_add(t4, t0, t1);               // b<=4
  fe_sub_kp(t3, t3, t4, MSM_KP4);   // b<=6
  fe_add(t4, Y2, Y1);               // b<=2
  fe_add(Y3, X2, X1);               // b<=2
  fe_scale(t0, t0, 3u);             // b<=6
  fe_add(Z3, t1, MSM_THREE_MONT);   // t2 = 3*Z1 = 3 (Montgomery); b<=3
  fe_sub_kp(t1, t1, MSM_THREE_MONT, MSM_KP2);  // b<=4
  fe_scale(Y3, Y3, 3u);             // b<=6
  fe_neg_kp(u, t4, MSM_KP4);        // 4p - t4; b<=4
  // X3 = t3*t1 - t4*Y3, Y3 = t1*Z3 + Y3*t0, Z3 = Z3*t4 + t0*t3
  mont_mul_pair(r.x, t3, t1, u, Y3);   // 48 -> b<=2
  mont_mul_pair(r.y, t1, Z3, Y3, t0);  // 48 -> b<=2
  mont_mul_pair(r.z, Z3, t4, t0, t3);  // 42 -> b<=2
}

// Mixed add: accumulator b<=4, affine addend (X2, Y2) canonical and not
// the identity; outputs b<=2.  r may alias p.
__device__ __forceinline__ void pt_add_mixed_lazy(Point& r, const Point& p,
                                                  const Affine& a) {
  const u32 *X2 = a.x, *Y2 = a.y;
  u32 t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], Y3[NW], Z3[NW], u[NW];
  mont_mul(t0, p.x, X2);            // 4 -> b<=2
  mont_mul(t1, p.y, Y2);            // 4 -> b<=2
  fe_add(t3, X2, Y2);               // b<=2
  fe_add(t4, p.x, p.y);             // b<=8
  mont_mul(t3, t3, t4);             // 16 -> b<=2
  fe_add(t4, t0, t1);               // b<=4
  fe_sub_kp(t3, t3, t4, MSM_KP4);   // b<=6
  mont_mul(t4, Y2, p.z);            // 4 -> b<=2
  fe_add(t4, t4, p.y);              // b<=6
  mont_mul(Y3, X2, p.z);            // 4 -> b<=2
  fe_add(Y3, Y3, p.x);              // b<=6
  fe_scale(t0, t0, 3u);             // b<=6
  fe_scale(t2, p.z, 3u);            // b<=12
  fe_add(Z3, t1, t2);               // b<=14
  fe_sub_kp(t1, t1, t2, MSM_KP12);  // b<=14
  fe_scale(Y3, Y3, 3u);             // b<=18
  fe_neg_kp(u, t4, MSM_KP6);        // 6p - t4; b<=6
  // X3 = t3*t1 - t4*Y3, Y3 = t1*Z3 + Y3*t0, Z3 = Z3*t4 + t0*t3
  mont_mul_pair(r.x, t3, t1, u, Y3);   // 6*14 + 6*18 = 192 -> b<=2
  mont_mul_pair(r.y, t1, Z3, Y3, t0);  // 14*14 + 18*6 = 304 -> b<=2
  mont_mul_pair(r.z, Z3, t4, t0, t3);  // 14*6 + 6*6 = 120 -> b<=2
}

// Full projective add, inputs b<=4, outputs b<=2 (closed under chaining).
// r may alias p or q.
__device__ __forceinline__ void pt_add_lazy(Point& r, const Point& p,
                                            const Point& q) {
  u32 t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], X3[NW], Y3[NW], Z3[NW];
  mont_mul(t0, p.x, q.x);           // 16 -> b<=2
  mont_mul(t1, p.y, q.y);           // 16 -> b<=2
  mont_mul(t2, p.z, q.z);           // 16 -> b<=2
  fe_add(t3, p.x, p.y);             // b<=8
  fe_add(t4, q.x, q.y);             // b<=8
  mont_mul(t3, t3, t4);             // 64 -> b<=2
  fe_add(t4, t0, t1);               // b<=4
  fe_sub_kp(t3, t3, t4, MSM_KP4);   // b<=6
  fe_add(t4, p.y, p.z);             // b<=8
  fe_add(X3, q.y, q.z);             // b<=8
  mont_mul(t4, t4, X3);             // 64 -> b<=2
  fe_add(X3, t1, t2);               // b<=4
  fe_sub_kp(t4, t4, X3, MSM_KP4);   // b<=6
  fe_add(X3, p.x, p.z);             // b<=8
  fe_add(Y3, q.x, q.z);             // b<=8
  mont_mul(X3, X3, Y3);             // 64 -> b<=2
  fe_add(Y3, t0, t2);               // b<=4
  fe_sub_kp(Y3, X3, Y3, MSM_KP4);   // b<=6
  fe_scale(t0, t0, 3u);             // b<=6
  fe_scale(t2, t2, 3u);             // b<=6
  fe_add(Z3, t1, t2);               // b<=8
  fe_sub_kp(t1, t1, t2, MSM_KP6);   // b<=8
  fe_scale(Y3, Y3, 3u);             // b<=18
  fe_neg_kp(X3, t4, MSM_KP12);      // 12p - t4; b<=12
  // X3 = t3*t1 - t4*Y3, Y3 = t1*Z3 + Y3*t0, Z3 = Z3*t4 + t0*t3
  mont_mul_pair(r.x, t3, t1, X3, Y3);  // 6*8 + 12*18 = 264 -> b<=2
  mont_mul_pair(X3, t1, Z3, Y3, t0);   // 8*8 + 18*6 = 172 -> b<=2
  mont_mul_pair(r.z, Z3, t4, t0, t3);  // 8*6 + 6*6 = 84 -> b<=2
  fe_copy(r.y, X3);
}

// Complete doubling, input b<=4, outputs b<=4.  r may alias p.
__device__ __forceinline__ void pt_double_lazy(Point& r, const Point& p) {
  u32 t0[NW], t1[NW], t2[NW], X3[NW], Y3[NW], Z3[NW];
  mont_mul(t0, p.y, p.y);           // 16 -> b<=2
  fe_scale(Z3, t0, 8u);             // b<=16
  mont_mul(t1, p.y, p.z);           // 16 -> b<=2
  mont_mul(t2, p.z, p.z);           // 16 -> b<=2
  fe_scale(t2, t2, 3u);             // b<=6
  mont_mul(X3, t2, Z3);             // 96 -> b<=2
  fe_add(Y3, t0, t2);               // b<=8
  mont_mul(Z3, t1, Z3);             // 32 -> b<=2
  fe_scale(t2, t2, 3u);             // b<=18
  fe_sub_kp(t0, t0, t2, MSM_KP18);  // b<=20
  mont_mul(Y3, t0, Y3);             // 160 -> b<=2
  fe_add(Y3, X3, Y3);               // b<=4
  mont_mul(t1, p.x, p.y);           // 16 -> b<=2
  mont_mul(X3, t0, t1);             // 40 -> b<=2
  fe_add(r.x, X3, X3);              // b<=4
  fe_copy(r.y, Y3);
  fe_copy(r.z, Z3);
}

// -- canonical domain: coordinates < p in, < p out ------------------------

__device__ __forceinline__ void fe_triple_mod(u32 r[NW], const u32 a[NW]) {
  u32 t[NW];
  fe_add_mod(t, a, a);
  fe_add_mod(r, t, a);
}

// Complete projective add (RCB Alg. 7): 12 products.  r may alias p or q.
__device__ __forceinline__ void pt_add(Point& r, const Point& p,
                                       const Point& q) {
  u32 t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], X3[NW], Y3[NW], Z3[NW];
  mont_mul_mod(t0, p.x, q.x);
  mont_mul_mod(t1, p.y, q.y);
  mont_mul_mod(t2, p.z, q.z);
  fe_add_mod(t3, p.x, p.y);
  fe_add_mod(t4, q.x, q.y);
  mont_mul_mod(t3, t3, t4);
  fe_add_mod(t4, t0, t1);
  fe_sub_mod(t3, t3, t4);
  fe_add_mod(t4, p.y, p.z);
  fe_add_mod(X3, q.y, q.z);
  mont_mul_mod(t4, t4, X3);
  fe_add_mod(X3, t1, t2);
  fe_sub_mod(t4, t4, X3);
  fe_add_mod(X3, p.x, p.z);
  fe_add_mod(Y3, q.x, q.z);
  mont_mul_mod(X3, X3, Y3);
  fe_add_mod(Y3, t0, t2);
  fe_sub_mod(Y3, X3, Y3);
  fe_triple_mod(t0, t0);
  fe_triple_mod(t2, t2);
  fe_add_mod(Z3, t1, t2);
  fe_sub_mod(t1, t1, t2);
  fe_triple_mod(Y3, Y3);
  mont_mul_mod(X3, t4, Y3);
  mont_mul_mod(t2, t3, t1);
  fe_sub_mod(r.x, t2, X3);
  mont_mul_mod(Y3, Y3, t0);
  mont_mul_mod(t1, t1, Z3);
  fe_add_mod(r.y, t1, Y3);
  mont_mul_mod(t0, t0, t3);
  mont_mul_mod(Z3, Z3, t4);
  fe_add_mod(r.z, Z3, t0);
}

// p = p + q, pt_add in three stages (p, q and S in shared memory; g the
// thread's rank in its group; a group with on false only synchronizes):
// t0 = x1 x2, t1 = y1 y2, t2 = z1 z2, t3 = (x1 + y1)(x2 + y2),
// t4 = (y1 + z1)(y2 + z2), t5 = (x1 + z1)(x2 + z2), a thread each; then
// d0 = t3 - (t0 + t1), d1 = t4 - (t1 + t2), d2 = 3 (t5 - (t0 + t2)),
// d3 = 3 t0, d4 = t1 + 3 t2, d5 = t1 - 3 t2 in every thread, and x = d1 d2,
// T2 = d0 d5, y = d2 d3, T1 = d5 d4, T0 = d3 d0, z = d4 d1, a thread each;
// then x3 = T2 - x, y3 = T1 + y, z3 = z + T0.  Every thread of the block
// calls it: it synchronizes the block.
__device__ __forceinline__ void pt_add_coop(Point& p, const Point& q,
                                            u32 (*S)[NW], int g, bool on) {
  u32 (*P)[NW] = reinterpret_cast<u32(*)[NW]>(&p);
  const u32 (*Q)[NW] = reinterpret_cast<const u32(*)[NW]>(&q);
  u32 a[NW], b[NW], r[NW];
  if (on && g < 6) {
    const int i = g < 3 ? g : g == 4 ? 1 : 0, j = g == 3 ? 1 : 2;
    fe_add_mod(r, P[i], P[j]);
    fe_sel(a, g < 3, P[i], r);
    fe_add_mod(r, Q[i], Q[j]);
    fe_sel(b, g < 3, Q[i], r);
    mont_mul_mod(r, a, b);
    fe_copy(S[g], r);
  }
  __syncthreads();
  if (on && g < 6) {
    u32 d[6][NW];
    fe_add_mod(r, S[0], S[1]);
    fe_sub_mod(d[0], S[3], r);
    fe_add_mod(r, S[1], S[2]);
    fe_sub_mod(d[1], S[4], r);
    fe_add_mod(r, S[0], S[2]);
    fe_sub_mod(r, S[5], r);
    fe_triple_mod(d[2], r);
    fe_triple_mod(d[3], S[0]);
    fe_triple_mod(r, S[2]);
    fe_add_mod(d[4], S[1], r);
    fe_sub_mod(d[5], S[1], r);
    // operand pairs (1, 2), (0, 5), (2, 3), (5, 4), (3, 0), (4, 1)
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      a[w] = g == 0 ? d[1][w] : g == 1 ? d[0][w] : g == 2 ? d[2][w]
           : g == 3 ? d[5][w] : g == 4 ? d[3][w] : d[4][w];
      b[w] = g == 0 ? d[2][w] : g == 1 ? d[5][w] : g == 2 ? d[3][w]
           : g == 3 ? d[4][w] : g == 4 ? d[0][w] : d[1][w];
    }
    mont_mul_mod(r, a, b);
    fe_copy(S[6 + g], r);
  }
  __syncthreads();
  if (on && g < 3) {
    if (g == 0)
      fe_sub_mod(r, S[7], S[6]);
    else
      fe_add_mod(r, S[6 + 2 * g + 1], S[6 + 2 * g]);
    fe_copy(P[g], r);
  }
  __syncthreads();
}

// Complete mixed add (RCB Alg. 8): 11 products.  The affine addend
// (X2, Y2) must not be the identity; the accumulator may be.  r may alias p.
__device__ __forceinline__ void pt_add_mixed(Point& r, const Point& p,
                                             const Affine& a) {
  const u32 *X2 = a.x, *Y2 = a.y;
  u32 t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], X3[NW], Y3[NW], Z3[NW];
  mont_mul_mod(t0, p.x, X2);
  mont_mul_mod(t1, p.y, Y2);
  fe_add_mod(t3, X2, Y2);
  fe_add_mod(t4, p.x, p.y);
  mont_mul_mod(t3, t3, t4);
  fe_add_mod(t4, t0, t1);
  fe_sub_mod(t3, t3, t4);
  mont_mul_mod(t4, Y2, p.z);
  fe_add_mod(t4, t4, p.y);
  mont_mul_mod(Y3, X2, p.z);
  fe_add_mod(Y3, Y3, p.x);
  fe_triple_mod(t0, t0);
  fe_triple_mod(t2, p.z);
  fe_add_mod(Z3, t1, t2);
  fe_sub_mod(t1, t1, t2);
  fe_triple_mod(Y3, Y3);
  mont_mul_mod(X3, t4, Y3);
  mont_mul_mod(t2, t3, t1);
  fe_sub_mod(r.x, t2, X3);
  mont_mul_mod(Y3, Y3, t0);
  mont_mul_mod(t1, t1, Z3);
  fe_add_mod(r.y, t1, Y3);
  mont_mul_mod(t0, t0, t3);
  mont_mul_mod(Z3, Z3, t4);
  fe_add_mod(r.z, Z3, t0);
}

// Complete doubling (RCB Alg. 9): 8 products.  r may alias p.
__device__ __forceinline__ void pt_double(Point& r, const Point& p) {
  u32 t0[NW], t1[NW], t2[NW], X3[NW], Y3[NW], Z3[NW];
  mont_mul_mod(t0, p.y, p.y);
  fe_add_mod(Z3, t0, t0);
  fe_add_mod(Z3, Z3, Z3);
  fe_add_mod(Z3, Z3, Z3);
  mont_mul_mod(t1, p.y, p.z);
  mont_mul_mod(t2, p.z, p.z);
  fe_triple_mod(t2, t2);
  mont_mul_mod(X3, t2, Z3);
  fe_add_mod(Y3, t0, t2);
  mont_mul_mod(Z3, t1, Z3);
  fe_triple_mod(t2, t2);
  fe_sub_mod(t0, t0, t2);
  mont_mul_mod(Y3, t0, Y3);
  fe_add_mod(Y3, X3, Y3);
  mont_mul_mod(t1, p.x, p.y);
  mont_mul_mod(X3, t0, t1);
  fe_add_mod(r.x, X3, X3);
  fe_copy(r.y, Y3);
  fe_copy(r.z, Z3);
}

// (x, y) -> (x, -y), canonical
__device__ __forceinline__ void pt_neg_affine(Affine& a) { fe_neg_mod(a.y, a.y); }

__device__ __forceinline__ void pt_canon(Point& r) {
  fe_canon4(r.x);
  fe_canon4(r.y);
  fe_canon4(r.z);
}

__device__ __forceinline__ void pt_load(Point& r, const int32_t* plane,
                                        size_t ncols, size_t j) {
  fe_load(r.x, plane, ncols, 0, j);
  fe_load(r.y, plane, ncols, NW, j);
  fe_load(r.z, plane, ncols, 2 * NW, j);
}

__device__ __forceinline__ void pt_store(int32_t* plane, size_t ncols,
                                         size_t j, const Point& a) {
  fe_store(plane, ncols, 0, j, a.x);
  fe_store(plane, ncols, NW, j, a.y);
  fe_store(plane, ncols, 2 * NW, j, a.z);
}

// Column j of a (26, ncols) affine plane
__device__ __forceinline__ void aff_load(Affine& a, const int32_t* plane,
                                         size_t ncols, size_t j) {
  fe_load(a.x, plane, ncols, 0, j);
  fe_load(a.y, plane, ncols, NW, j);
}

#else  // MSM_CURVE_ED

// -- Twisted Edwards BLS12, extended coordinates ---------------------------

struct Point {
  u32 x[NW], y[NW], t[NW], z[NW];
};
// affine addend (x, y, t = x*y), canonical; z = 1 implicit
struct Affine {
  u32 x[NW], y[NW], t[NW];
};

// Identity (0 : 1 : 0 : 1), Montgomery form.
__device__ __forceinline__ void pt_zero(Point& r) {
  fe_zero(r.x);
  fe_set_const(r.y, MSM_ONE_MONT);
  fe_zero(r.t);
  fe_set_const(r.z, MSM_ONE_MONT);
}

__device__ __forceinline__ void pt_from_affine(Point& r, const Affine& a) {
  fe_copy(r.x, a.x);
  fe_copy(r.y, a.y);
  fe_copy(r.t, a.t);
  fe_set_const(r.z, MSM_ONE_MONT);
}

// Unified mixed add: accumulator b<=2, affine addend canonical; outputs
// b<=2.  r may alias p.
__device__ __forceinline__ void pt_add_mixed_lazy(Point& r, const Point& p,
                                                  const Affine& q) {
  u32 a[NW], b[NW], c[NW], e[NW], f[NW], g[NW], h[NW], u[NW];
  mont_mul(a, p.x, q.x);            // 2 -> b<=2
  mont_mul(b, p.y, q.y);            // 2 -> b<=2
  mont_mul(u, p.t, q.t);            // 2 -> b<=2
  mont_mul(c, MSM_D_MONT, u);       // 2 -> b<=2
  fe_add(e, p.x, p.y);              // b<=4
  fe_add(f, q.x, q.y);              // b<=2
  mont_mul(e, e, f);                // 8 -> b<=2
  fe_add(u, a, b);                  // b<=4
  fe_sub_kp(e, e, u, MSM_KP4);      // b<=6
  fe_sub_kp(f, p.z, c, MSM_KP2);    // b<=4 (z2 = 1: the d-term is z1)
  fe_add(g, p.z, c);                // b<=4
  fe_add(h, b, a);                  // b<=4
  mont_mul(r.x, e, f);              // 24 -> b<=2
  mont_mul(r.y, g, h);              // 16 -> b<=2
  mont_mul(r.t, e, h);              // 24 -> b<=2
  mont_mul(r.z, f, g);              // 16 -> b<=2
}

// Both-affine add (tree level 1): the mixed add seeded with the promoted
// first addend, as ops/curve.py:EdwardsOps.add_affine_lazy.
__device__ __forceinline__ void pt_add_affine_lazy(Point& r, const Affine& a,
                                                   const Affine& b) {
  Point p;
  pt_from_affine(p, a);
  pt_add_mixed_lazy(r, p, b);
}

// Unified full add: inputs b<=2, outputs b<=2 (closed).  r may alias p
// or q.
__device__ __forceinline__ void pt_add_lazy(Point& r, const Point& p,
                                            const Point& q) {
  u32 a[NW], b[NW], c[NW], e[NW], f[NW], g[NW], h[NW], u[NW];
  mont_mul(a, p.x, q.x);            // 4 -> b<=2
  mont_mul(b, p.y, q.y);            // 4 -> b<=2
  mont_mul(u, p.t, q.t);            // 4 -> b<=2
  mont_mul(c, MSM_D_MONT, u);       // 2 -> b<=2
  fe_add(e, p.x, p.y);              // b<=4
  fe_add(f, q.x, q.y);              // b<=4
  mont_mul(e, e, f);                // 16 -> b<=2
  fe_add(u, a, b);                  // b<=4
  fe_sub_kp(e, e, u, MSM_KP4);      // b<=6
  mont_mul(u, p.z, q.z);            // 4 -> b<=2
  fe_sub_kp(f, u, c, MSM_KP2);      // b<=4
  fe_add(g, u, c);                  // b<=4
  fe_add(h, b, a);                  // b<=4
  mont_mul(r.x, e, f);              // 24 -> b<=2
  mont_mul(r.y, g, h);              // 16 -> b<=2
  mont_mul(r.t, e, h);              // 24 -> b<=2
  mont_mul(r.z, f, g);              // 16 -> b<=2
}

// dbl-2008-hwcd (a = -1): input b<=2, outputs b<=2.  r may alias p.
__device__ __forceinline__ void pt_double_lazy(Point& r, const Point& p) {
  u32 a[NW], b[NW], c[NW], d[NW], e[NW], f[NW], g[NW], h[NW];
  mont_mul(a, p.x, p.x);            // 4 -> b<=2
  mont_mul(b, p.y, p.y);            // 4 -> b<=2
  mont_mul(c, p.z, p.z);            // 4 -> b<=2
  fe_add(c, c, c);                  // b<=4
  fe_neg_kp(d, a, MSM_KP2);         // 2p - a; b<=2
  fe_add(e, p.x, p.y);              // b<=4
  mont_mul(e, e, e);                // 16 -> b<=2
  fe_add(f, a, b);                  // b<=4
  fe_sub_kp(e, e, f, MSM_KP4);      // b<=6
  fe_add(g, d, b);                  // b<=4
  fe_sub_kp(f, g, c, MSM_KP4);      // b<=8
  fe_sub_kp(h, d, b, MSM_KP2);      // b<=4
  mont_mul(r.x, e, f);              // 48 -> b<=2
  mont_mul(r.y, g, h);              // 16 -> b<=2
  mont_mul(r.t, e, h);              // 24 -> b<=2
  mont_mul(r.z, f, g);              // 32 -> b<=2
}

// coordinates below 2p (LAZY_BOUND 2) -> canonical: one conditional
// subtract of p each
__device__ __forceinline__ void pt_canon(Point& r) {
  fe_csub(r.x, MSM_P);
  fe_csub(r.y, MSM_P);
  fe_csub(r.t, MSM_P);
  fe_csub(r.z, MSM_P);
}

// -- canonical domain: coordinates < p in, < p out ------------------------
// Complete for a = -1 and d a non-square: identity, equal and inverse
// operands need no select.

// add-2008-hwcd core with a = -1 folded in (h = b + a); dd is the z-term
// (z1*z2, or z1 for an affine addend).  r may alias p, dd may be p.z.
__device__ __forceinline__ void ed_add_core(Point& r, const Point& p,
                                            const u32 x2[NW],
                                            const u32 y2[NW],
                                            const u32 t2[NW],
                                            const u32 dd[NW]) {
  u32 a[NW], b[NW], c[NW], e[NW], f[NW], g[NW], h[NW];
  mont_mul_mod(a, p.x, x2);
  mont_mul_mod(b, p.y, y2);
  mont_mul_mod(c, p.t, t2);
  mont_mul_mod(c, MSM_D_MONT, c);
  fe_add_mod(e, p.x, p.y);
  fe_add_mod(f, x2, y2);
  mont_mul_mod(e, e, f);
  fe_sub_mod(e, e, a);
  fe_sub_mod(e, e, b);
  fe_sub_mod(f, dd, c);
  fe_add_mod(g, dd, c);
  fe_add_mod(h, b, a);
  mont_mul_mod(r.x, e, f);
  mont_mul_mod(r.y, g, h);
  mont_mul_mod(r.t, e, h);
  mont_mul_mod(r.z, f, g);
}

// Complete extended add: 10 products.  r may alias p or q.
__device__ __forceinline__ void pt_add(Point& r, const Point& p,
                                       const Point& q) {
  u32 dd[NW];
  mont_mul_mod(dd, p.z, q.z);
  ed_add_core(r, p, q.x, q.y, q.t, dd);
}

// p = p + q, pt_add in two stages (p, q and S in shared memory; g the
// thread's rank in its group; a group with on false only synchronizes):
// a = x1 x2, b = y1 y2, c = d t1 t2 (both products in one thread),
// dd = z1 z2, e = (x1 + y1)(x2 + y2), a thread each; then e' = e - a - b,
// f = dd - c, g = dd + c, h = b + a in every thread, and x3 = e' f,
// y3 = g h, t3 = e' h, z3 = f g, a thread each.  Every thread of the block
// calls it: it synchronizes the block.
__device__ __forceinline__ void pt_add_coop(Point& p, const Point& q,
                                            u32 (*S)[NW], int g, bool on) {
  u32 (*P)[NW] = reinterpret_cast<u32(*)[NW]>(&p);
  const u32 (*Q)[NW] = reinterpret_cast<const u32(*)[NW]>(&q);
  u32 a[NW], b[NW], r[NW];
  if (on && g < 5) {
    const int i = g < 4 ? g : 0;
    fe_add_mod(r, P[0], P[1]);
    fe_sel(a, g < 4, P[i], r);
    fe_add_mod(r, Q[0], Q[1]);
    fe_sel(b, g < 4, Q[i], r);
    mont_mul_mod(r, a, b);
    if (g == 2) mont_mul_mod(r, MSM_D_MONT, r);
    fe_copy(S[g], r);
  }
  __syncthreads();
  if (on && g < 4) {
    u32 e[NW], f[NW], gg[NW], h[NW];
    fe_sub_mod(e, S[4], S[0]);
    fe_sub_mod(e, e, S[1]);
    fe_sub_mod(f, S[3], S[2]);
    fe_add_mod(gg, S[3], S[2]);
    fe_add_mod(h, S[1], S[0]);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      a[w] = g == 1 ? gg[w] : g == 3 ? f[w] : e[w];
      b[w] = g == 0 ? f[w] : g == 3 ? gg[w] : h[w];
    }
    mont_mul_mod(r, a, b);
    fe_copy(P[g], r);
  }
  __syncthreads();
}

// Complete mixed add of an affine (x, y, t) addend, z2 = 1 (the z-term is
// z1): 9 products.  r may alias p.
__device__ __forceinline__ void pt_add_mixed(Point& r, const Point& p,
                                             const Affine& a) {
  ed_add_core(r, p, a.x, a.y, a.t, p.z);
}

// dbl-2008-hwcd (a = -1: the d-term is -a): 8 products.  r may alias p.
__device__ __forceinline__ void pt_double(Point& r, const Point& p) {
  u32 a[NW], b[NW], c[NW], d[NW], e[NW], f[NW], g[NW], h[NW];
  mont_mul_mod(a, p.x, p.x);
  mont_mul_mod(b, p.y, p.y);
  mont_mul_mod(c, p.z, p.z);
  fe_add_mod(c, c, c);
  fe_neg_mod(d, a);
  fe_add_mod(e, p.x, p.y);
  mont_mul_mod(e, e, e);
  fe_sub_mod(e, e, a);
  fe_sub_mod(e, e, b);
  fe_add_mod(g, d, b);
  fe_sub_mod(f, g, c);
  fe_sub_mod(h, d, b);
  mont_mul_mod(r.x, e, f);
  mont_mul_mod(r.y, g, h);
  mont_mul_mod(r.t, e, h);
  mont_mul_mod(r.z, f, g);
}

// (x, y, t) -> (-x, y, -t), canonical
__device__ __forceinline__ void pt_neg_affine(Affine& a) {
  fe_neg_mod(a.x, a.x);
  fe_neg_mod(a.t, a.t);
}

__device__ __forceinline__ void pt_load(Point& r, const int32_t* plane,
                                        size_t ncols, size_t j) {
  fe_load(r.x, plane, ncols, 0, j);
  fe_load(r.y, plane, ncols, NW, j);
  fe_load(r.t, plane, ncols, 2 * NW, j);
  fe_load(r.z, plane, ncols, 3 * NW, j);
}

__device__ __forceinline__ void pt_store(int32_t* plane, size_t ncols,
                                         size_t j, const Point& a) {
  fe_store(plane, ncols, 0, j, a.x);
  fe_store(plane, ncols, NW, j, a.y);
  fe_store(plane, ncols, 2 * NW, j, a.t);
  fe_store(plane, ncols, 3 * NW, j, a.z);
}

// Column j of a (27, ncols) affine plane
__device__ __forceinline__ void aff_load(Affine& a, const int32_t* plane,
                                         size_t ncols, size_t j) {
  fe_load(a.x, plane, ncols, 0, j);
  fe_load(a.y, plane, ncols, NW, j);
  fe_load(a.t, plane, ncols, 2 * NW, j);
}

#endif  // MSM_CURVE_ED

// -- Row-major point rows, both curves ---------------------------------------
//
// A row is ROW_WORDS = 32 int32 words: an affine point's coordinates in
// Affine's word order (G1 x, y: words 0..25; Edwards x, y, t: 0..26), then
// zeros.  128 bytes keep every row 16-byte aligned, so a row's first 28
// words (112 bytes, 4 sectors) are seven 16-byte loads.  The signed table
// (ops/smvp_stream.py:build_signed_table) is (2N, ROW_WORDS): row j < N
// holds point j, row N + j its negative; the fused path's pre-gathered rows
// (ops/smvp_kernel.py:pregather_signed) have the same format.
#define ROW_WORDS 32
#define ROW_LOADS 7  // 16-byte loads that cover a row's coordinates

static_assert(sizeof(Affine) <= ROW_LOADS * 16, "an affine point fits a row");

// Row `row` of a row-major (rows, ROW_WORDS) array -> its affine point.
__device__ __forceinline__ void aff_load_row(Affine& a, const int32_t* rows,
                                             long long row) {
  u32 w[4 * ROW_LOADS];
  const int4* v = reinterpret_cast<const int4*>(rows + row * ROW_WORDS);
#pragma unroll
  for (int i = 0; i < ROW_LOADS; ++i) {
    const int4 q = __ldg(v + i);
    w[4 * i] = (u32)q.x;
    w[4 * i + 1] = (u32)q.y;
    w[4 * i + 2] = (u32)q.z;
    w[4 * i + 3] = (u32)q.w;
  }
  u32* d = reinterpret_cast<u32*>(&a);  // Affine's words, in row order
#pragma unroll
  for (int k = 0; k < (int)(sizeof(Affine) / 4); ++k) d[k] = w[k];
}

// Entry i of a sorted entry stream -> its signed affine point from the
// (2N, ROW_WORDS) signed table: G1 (x, y) or (x, -y), Edwards (x, y, t) or
// (-x, y, -t), Montgomery form.
__device__ __forceinline__ void load_signed_aff(Affine& a,
                                                const int32_t* table,
                                                const int32_t* sorted_vals,
                                                long long n_points,
                                                long long i) {
  aff_load_row(a, table, signed_col(sorted_vals, n_points, i));
}

// -- Node rows, both curves ----------------------------------------------------
//
// A lazy projective point as one row-major node of NODE_WORDS int32 words:
// its coordinates in Point's word order (the plane's row order: G1 x, y,
// z; Edwards x, y, t, z), then zeros up to a multiple of four words (G1
// 39 + 1 = 40 words, 160 bytes; Edwards 36, 144 bytes), so a node is
// NODE_LOADS 16-byte loads.  The hybrid tree's last level writes its nodes
// as rows (tree.cu, out mode OUT_ROWS) for the finish (packed.cu), which
// reads a node's five sectors instead of one sector a word of a
// limb-major plane.  ops/smvp_stream.py:node_rows is the plain form.
#define NODE_LOADS ((int)((sizeof(Point) + 15) / 16))
#define NODE_WORDS (4 * NODE_LOADS)

__device__ __forceinline__ void pt_load_row(Point& r, const int32_t* rows,
                                            long long j) {
  u32 w[NODE_WORDS];
  const int4* v = reinterpret_cast<const int4*>(rows + j * NODE_WORDS);
#pragma unroll
  for (int i = 0; i < NODE_LOADS; ++i) {
    const int4 q = __ldg(v + i);
    w[4 * i] = (u32)q.x;
    w[4 * i + 1] = (u32)q.y;
    w[4 * i + 2] = (u32)q.z;
    w[4 * i + 3] = (u32)q.w;
  }
  u32* d = reinterpret_cast<u32*>(&r);  // Point's words, in row order
#pragma unroll
  for (int k = 0; k < (int)(sizeof(Point) / 4); ++k) d[k] = w[k];
}

__device__ __forceinline__ void pt_store_row(int32_t* rows, long long j,
                                             const Point& a) {
  u32 w[NODE_WORDS];
  const u32* s = reinterpret_cast<const u32*>(&a);
#pragma unroll
  for (int k = 0; k < NODE_WORDS; ++k)
    w[k] = k < (int)(sizeof(Point) / 4) ? s[k] : 0u;
  int4* v = reinterpret_cast<int4*>(rows + j * NODE_WORDS);
#pragma unroll
  for (int i = 0; i < NODE_LOADS; ++i)
    v[i] = make_int4((int)w[4 * i], (int)w[4 * i + 1], (int)w[4 * i + 2],
                     (int)w[4 * i + 3]);
}
