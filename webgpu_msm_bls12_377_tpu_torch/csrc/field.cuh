// Base-field arithmetic on NW x 32-bit words, shared by every kernel of
// the port: NW = 13 for BLS12-377, 9 for Twisted Edwards BLS12 (built with
// -DMSM_CURVE_ED; params.cuh), R = 2^(32 NW).  The same functions, in the
// same order, are the plain PyTorch forms in ops/field.py; both compute
// exact integers, so a kernel and its plain form agree word for word, lazy
// values included.
//
// Values are little-endian u32[NW] held in registers.  "Lazy" values are
// exact integers below k*p for a bound k tracked by the point formulas
// (curve.cuh); they are reduced to [0, p) once, by fe_canon.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#include "params.cuh"

typedef uint32_t u32;
typedef uint64_t u64;
typedef int64_t i64;

#define NW MSM_NW

// Every entry point returns the launch status for the Python wrapper to
// check (a refused launch never runs and is not reported otherwise).  Each
// kernel source builds into a library of its own, so each library carries
// its own copy of msm_error_string.
#define MSM_LAUNCH_STATUS() ((int)cudaGetLastError())

extern "C" const char* msm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

__device__ __forceinline__ void fe_copy(u32 r[NW], const u32 a[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r[i] = a[i];
}

__device__ __forceinline__ void fe_set_const(u32 r[NW], const u32 c[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r[i] = c[i];
}

__device__ __forceinline__ void fe_zero(u32 r[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r[i] = 0u;
}

// r = a + b (exact; callers keep the sum below R)
__device__ __forceinline__ void fe_add(u32 r[NW], const u32 a[NW],
                                       const u32 b[NW]) {
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (u64)a[i] + b[i];
    r[i] = (u32)c;
    c >>= 32;
  }
}

// r = k * a for a small constant k (3 and 8 in the formulas)
__device__ __forceinline__ void fe_scale(u32 r[NW], const u32 a[NW], u32 k) {
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (u64)a[i] * k;
    r[i] = (u32)c;
    c >>= 32;
  }
}

// r = a + kp - b, exact for b <= a + kp (kp one of the MSM_KP* multiples)
__device__ __forceinline__ void fe_sub_kp(u32 r[NW], const u32 a[NW],
                                          const u32 b[NW],
                                          const u32 kp[NW]) {
  i64 c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (i64)a[i] + (i64)kp[i] - (i64)b[i];
    r[i] = (u32)c;
    c >>= 32;  // arithmetic shift: a borrow is carried as -1
  }
}

// r = kp - b, exact for b <= kp
__device__ __forceinline__ void fe_neg_kp(u32 r[NW], const u32 b[NW],
                                          const u32 kp[NW]) {
  i64 c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (i64)kp[i] - (i64)b[i];
    r[i] = (u32)c;
    c >>= 32;
  }
}

// s = s - c where s >= c; returns s unchanged where s < c
__device__ __forceinline__ void fe_csub(u32 s[NW], const u32 c[NW]) {
  u32 d[NW];
  i64 b = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    b += (i64)s[i] - (i64)c[i];
    d[i] = (u32)b;
    b >>= 32;
  }
  if (b == 0) fe_copy(s, d);
}

// lazy value below 4p -> canonical residue below p (the only bound the
// formulas canonicalize from: G1 LAZY_BOUND = 4)
__device__ __forceinline__ void fe_canon4(u32 s[NW]) {
  fe_csub(s, MSM_KP2);
  fe_csub(s, MSM_P);
}

// (a + b) mod p for canonical a, b (ops/field.py:field_add)
__device__ __forceinline__ void fe_add_mod(u32 r[NW], const u32 a[NW],
                                           const u32 b[NW]) {
  fe_add(r, a, b);
  fe_csub(r, MSM_P);
}

// (a - b) mod p for canonical a, b (ops/field.py:field_sub): a + p - b,
// then one conditional subtract
__device__ __forceinline__ void fe_sub_mod(u32 r[NW], const u32 a[NW],
                                           const u32 b[NW]) {
  fe_sub_kp(r, a, b, MSM_P);
  fe_csub(r, MSM_P);
}

// (-a) mod p for canonical a, with 0 -> 0 (ops/field.py:field_neg)
__device__ __forceinline__ void fe_neg_mod(u32 r[NW], const u32 a[NW]) {
  u32 any = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) any |= a[i];
  if (any) {
    fe_neg_kp(r, a, MSM_P);
  } else {
    fe_zero(r);
  }
}

// -- The carry-chain Montgomery product (sources that define MSM_MONT_CHAIN
// before including this header: tree.cu and stream.cu) ---------------------
//
// The same REDC(a*b) and REDC(a*b + c*d), mod R, as the C form below, for
// any operands below R (the pair: any sum below 2R^2), on another
// schedule: PTX carry chains, after supranational's sppark
// (ff/mont_t.cuh, its mul_n / mad_n_redc even/odd form).  A word product
// costs a mad.lo and a mad.hi with the carry in the flag, and no 64-bit
// temporaries.  Each outer step i of the CIOS loop keeps t = x + 2^32 y in
// two accumulators: x (NW + 2 words) takes the products of the
// even-indexed words of a, whose low and high halves never overlap, y
// (NW + 1 words, one word up) those of the odd-indexed words, so the two
// chains of a step are independent and a scheduler can interleave them.
// m = x[0] * N0 reduces both at once (x += m * p's even words, y += m *
// p's odd words), which zeroes x[0]; then t / 2^32 = y + x[1..]: the next
// x is y with x[1] added at word 0, the next y is x[2..], and the carry of
// that one add enters the next y chain.  The last step adds y + x[1..] mod
// R (its top carry is dropped, as the C form drops t's top words).
// Bounds: t < 2R + p before every step, so a step's total is below 3R 2^32
// and x < 3 * 2^(32 (NW + 1)), y < 3 * 2^(32 NW): no chain carries out of
// its top word.  tests/test_torch_mont_chain.py models these steps with
// an explicit carry flag and holds them against integer REDC.
//
// The carry flag passes from one asm statement to the next: they are
// volatile, so the compiler keeps their order, and nothing it emits between
// them (register moves, 32-bit multiplies) touches the flag.
// MSM_MONT_CHAIN picks this product.

#ifdef MSM_MONT_CHAIN

#define MSM_PTX3(op, r, a, b) \
  asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b))
#define MSM_PTX4(op, r, a, b, c) \
  asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c))

// acc[0..TOP] += sum over j = Q, Q + 2, ... < NW of v_j * y * 2^(32 (j - Q)),
// v = MSM_P if MOD else x, as one carry chain: word k takes the low half of
// v_k+Q's product (k even) or the high half of v_k-1+Q's (k odd), then the
// carry runs on to word TOP.  CIN: the chain takes the carry flag that the
// instruction before it left.
template <int Q, int TOP, bool CIN, bool MOD>
__device__ __forceinline__ void mont_chain(u32* acc, const u32* x, u32 y) {
#pragma unroll
  for (int k = 0; k <= TOP; ++k) {
    const int j = (k & ~1) + Q;
    const bool last = k == TOP;
    if (j >= NW) {
      if (last)
        MSM_PTX3("addc.u32", acc[k], acc[k], 0u);
      else
        MSM_PTX3("addc.cc.u32", acc[k], acc[k], 0u);
      continue;
    }
    const u32 v = MOD ? MSM_P[j] : x[j];
    if (k & 1) {
      if (last)
        MSM_PTX4("madc.hi.u32", acc[k], v, y, acc[k]);
      else
        MSM_PTX4("madc.hi.cc.u32", acc[k], v, y, acc[k]);
    } else if (k == 0 && !CIN) {
      MSM_PTX4("mad.lo.cc.u32", acc[k], v, y, acc[k]);
    } else if (last) {
      MSM_PTX4("madc.lo.u32", acc[k], v, y, acc[k]);
    } else {
      MSM_PTX4("madc.lo.cc.u32", acc[k], v, y, acc[k]);
    }
  }
}

// acc = sum over j = Q, Q + 2, ... < NW of x_j * y * 2^(32 (j - Q)), with
// zeros up to word TOP: the halves of one parity never overlap, so no
// carries
template <int Q, int TOP>
__device__ __forceinline__ void mont_first(u32* acc, const u32* x, u32 y) {
#pragma unroll
  for (int k = 0; k <= TOP; ++k) {
    const int j = (k & ~1) + Q;
    acc[k] = j >= NW ? 0u : (k & 1) ? __umulhi(x[j], y) : x[j] * y;
  }
}

// t += m p with m = x[0] * N0: x[0] becomes 0
__device__ __forceinline__ void mont_reduce(u32 x[NW + 2], u32 y[NW + 1]) {
  const u32 m = x[0] * MSM_N0;
  mont_chain<0, NW + 1, false, true>(x, nullptr, m);
  mont_chain<1, NW, false, true>(y, nullptr, m);
}

// (x, y) -> the next step's accumulators for t / 2^32 = y + x[1..]; leaves
// the carry of x'[0] = y[0] + x[1] in the flag for the next y chain
__device__ __forceinline__ void mont_shift(u32 x[NW + 2], u32 y[NW + 1]) {
  u32 nx[NW + 2], ny[NW + 1];
#pragma unroll
  for (int k = 0; k < NW; ++k) ny[k] = x[k + 2];
  ny[NW] = 0u;
#pragma unroll
  for (int k = 1; k <= NW; ++k) nx[k] = y[k];
  nx[NW + 1] = 0u;
  MSM_PTX3("add.cc.u32", nx[0], y[0], x[1]);
#pragma unroll
  for (int k = 0; k < NW + 2; ++k) x[k] = nx[k];
#pragma unroll
  for (int k = 0; k < NW + 1; ++k) y[k] = ny[k];
}

// r = (y + x[1..]) mod R
__device__ __forceinline__ void mont_merge(u32 r[NW], const u32 x[NW + 2],
                                           const u32 y[NW + 1]) {
  MSM_PTX3("add.cc.u32", r[0], y[0], x[1]);
#pragma unroll
  for (int k = 1; k < NW - 1; ++k) MSM_PTX3("addc.cc.u32", r[k], y[k], x[k + 1]);
  MSM_PTX3("addc.u32", r[NW - 1], y[NW - 1], x[NW]);
}

// REDC(a * b) mod R for any a, b < R (below a*b/R + p, i.e. < 2p for every
// bound product the formulas use): the carry-chain schedule above.
__device__ __forceinline__ void mont_mul(u32 r[NW], const u32 a[NW],
                                         const u32 b[NW]) {
  u32 x[NW + 2], y[NW + 1];
  mont_first<0, NW + 1>(x, a, b[0]);
  mont_first<1, NW>(y, a, b[0]);
  mont_reduce(x, y);
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    mont_shift(x, y);
    mont_chain<1, NW, true, false>(y, a, b[i]);
    mont_chain<0, NW + 1, false, false>(x, a, b[i]);
    mont_reduce(x, y);
  }
  mont_merge(r, x, y);
}

// REDC(a*b + c*d) mod R for a*b + c*d < 2R^2 (the paired products of the
// RCB formulas): each step adds both products' chains before reducing.
__device__ __forceinline__ void mont_mul_pair(u32 r[NW], const u32 a[NW],
                                              const u32 b[NW],
                                              const u32 c_[NW],
                                              const u32 d[NW]) {
  u32 x[NW + 2], y[NW + 1];
  mont_first<0, NW + 1>(x, a, b[0]);
  mont_first<1, NW>(y, a, b[0]);
  mont_chain<1, NW, false, false>(y, c_, d[0]);
  mont_chain<0, NW + 1, false, false>(x, c_, d[0]);
  mont_reduce(x, y);
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    mont_shift(x, y);
    mont_chain<1, NW, true, false>(y, a, b[i]);
    mont_chain<1, NW, false, false>(y, c_, d[i]);
    mont_chain<0, NW + 1, false, false>(x, a, b[i]);
    mont_chain<0, NW + 1, false, false>(x, c_, d[i]);
    mont_reduce(x, y);
  }
  mont_merge(r, x, y);
}

#undef MSM_PTX3
#undef MSM_PTX4

#else  // the C form: every other source

// REDC(a * b) = (a*b + m*p) / R with m = -a*b*p^-1 mod R: the
// coarsely integrated operand scanning (CIOS) Montgomery product with
// 64-bit accumulation.  Exact for any a, b < R; the output is below
// a*b/R + p, i.e. < 2p for every bound product the formulas use.
__device__ __forceinline__ void mont_mul(u32 r[NW], const u32 a[NW],
                                         const u32 b[NW]) {
  u32 t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c += (u64)t[j] + (u64)a[j] * b[i];
      t[j] = (u32)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW] = (u32)c;
    t[NW + 1] = (u32)(c >> 32);
    const u32 m = t[0] * MSM_N0;
    c = ((u64)m * MSM_P[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      c += (u64)t[j] + (u64)m * MSM_P[j];
      t[j - 1] = (u32)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW - 1] = (u32)c;
    t[NW] = t[NW + 1] + (u32)(c >> 32);
  }
  fe_copy(r, t);
}

// REDC(a*b + c*d): one reduction for a sum of two products (the paired
// products of the RCB formulas).  Two product passes per outer step keep
// every 64-bit accumulation below 2^64.
__device__ __forceinline__ void mont_mul_pair(u32 r[NW], const u32 a[NW],
                                              const u32 b[NW],
                                              const u32 c_[NW],
                                              const u32 d[NW]) {
  u32 t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c += (u64)t[j] + (u64)a[j] * b[i];
      t[j] = (u32)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW] = (u32)c;
    t[NW + 1] += (u32)(c >> 32);
    c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c += (u64)t[j] + (u64)c_[j] * d[i];
      t[j] = (u32)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW] = (u32)c;
    t[NW + 1] += (u32)(c >> 32);
    const u32 m = t[0] * MSM_N0;
    c = ((u64)m * MSM_P[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      c += (u64)t[j] + (u64)m * MSM_P[j];
      t[j - 1] = (u32)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW - 1] = (u32)c;
    t[NW] = t[NW + 1] + (u32)(c >> 32);
    t[NW + 1] = 0u;
  }
  fe_copy(r, t);
}

#endif  // MSM_MONT_CHAIN

// REDC(a * b) mod p for canonical a, b (REDC(a * b) < 2p): the product of
// the canonical-domain formulas (ops/field.py:mont_mul_canon)
__device__ __forceinline__ void mont_mul_mod(u32 r[NW], const u32 a[NW],
                                             const u32 b[NW]) {
  mont_mul(r, a, b);
  fe_csub(r, MSM_P);
}
