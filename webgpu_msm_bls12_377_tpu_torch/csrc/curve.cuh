// BLS12-377 G1 point formulas in the lazy domain, shared by every kernel.
//
// Complete projective formulas of Renes-Costello-Batina 2016 (a = 0,
// b3 = 3), Montgomery form, in the exact operation order of
// ops/curve.py:G1Ops (the plain PyTorch forms).  Comments give value
// bounds in units of p ("b<=k": value < k*p).  REDC outputs stay below 2p
// because R/p ~ 2^39 dwarfs every bound product used here (at most 304).
#pragma once
#include "field.cuh"

struct G1 {
  u32 x[NW], y[NW], z[NW];
};

// Identity (0 : 1 : 0), Montgomery form.
__device__ __forceinline__ void g1_zero(G1& r) {
  fe_zero(r.x);
  fe_set_const(r.y, MSM_ONE_MONT);
  fe_zero(r.z);
}

__device__ __forceinline__ void g1_from_affine(G1& r, const u32 x[NW],
                                               const u32 y[NW]) {
  fe_copy(r.x, x);
  fe_copy(r.y, y);
  fe_set_const(r.z, MSM_ONE_MONT);
}

// Both-affine add (Z1 = Z2 = 1), canonical inputs, outputs b<=2.
__device__ __forceinline__ void g1_add_affine_lazy_pair(G1& r,
                                                        const u32 X1[NW],
                                                        const u32 Y1[NW],
                                                        const u32 X2[NW],
                                                        const u32 Y2[NW]) {
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

// Full projective add, inputs b<=4, outputs b<=2 (closed under chaining).
// r may alias p or q.
__device__ __forceinline__ void g1_add_lazy_pair(G1& r, const G1& p,
                                                 const G1& q) {
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
__device__ __forceinline__ void g1_double_lazy(G1& r, const G1& p) {
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

__device__ __forceinline__ void g1_canon(G1& r) {
  fe_canon4(r.x);
  fe_canon4(r.y);
  fe_canon4(r.z);
}

// Column j of a merged (3*NW, ncols) limb-major plane: coordinate c, word
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

__device__ __forceinline__ void g1_load(G1& r, const int32_t* plane,
                                        size_t ncols, size_t j) {
  fe_load(r.x, plane, ncols, 0, j);
  fe_load(r.y, plane, ncols, NW, j);
  fe_load(r.z, plane, ncols, 2 * NW, j);
}

__device__ __forceinline__ void g1_store(int32_t* plane, size_t ncols,
                                         size_t j, const G1& a) {
  fe_store(plane, ncols, 0, j, a.x);
  fe_store(plane, ncols, NW, j, a.y);
  fe_store(plane, ncols, 2 * NW, j, a.z);
}
