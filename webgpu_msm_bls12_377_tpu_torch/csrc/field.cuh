// BLS12-377 base-field arithmetic on 13 x 32-bit words, shared by every
// kernel of the port.  The same functions, in the same order, are the
// plain PyTorch forms in ops/field.py; both compute exact integers, so a
// kernel and its plain form agree word for word, lazy values included.
//
// Values are little-endian u32[13] held in registers.  "Lazy" values are
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

// r = a + b (exact; callers keep the sum below 2^416)
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

// REDC(a * b) = (a*b + m*p) / 2^416 with m = -a*b*p^-1 mod 2^416: the
// coarsely integrated operand scanning (CIOS) Montgomery product with
// 64-bit accumulation.  Exact for any a, b < 2^416; the output is below
// a*b/2^416 + p, i.e. < 2p for every bound product the formulas use.
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
