// Native host-side MSM oracle for BLS12-377 G1 and Twisted Edwards BLS12.
//
// Plays the role of the reference's Rust snarkVM WASM ground truth
// (src/reference/reference.ts:7-62, aleo_wasm_bg.wasm): an independent,
// fast CPU implementation that checks device results at 2^16..2^20 in
// seconds.  Independence is deliberate: 6 x 64-bit CIOS Montgomery
// arithmetic (R = 2^384) and an unsigned Pippenger bucket walk (window 13,
// a thread a window), sharing *no* code or limb layout with the CUDA
// pipeline (13 x 32-bit words, R = 2^416; 9 words for Edwards; signed
// windows); agreement pins both.
//
// C ABI (little-endian byte buffers, the reference's wire format):
//   msm_g1(points[96B/pt: x||y], scalars[32B], n, out[96B affine x||y])
//   msm_edwards(points[64B/pt], scalars[32B], n, out[64B])
// The G1 identity is written as (0, 1).  Returns 0 on success, 1 when a
// coordinate is not below p (out is then left as it was).
//
// Build: g++ -O2 -shared -fPIC -pthread -I<dir of params_generated.h>
//        msm_oracle.cpp -o libmsm_oracle.so
// (driven by native/__init__.py, which writes the header with
// gen_params.py and loads the library with ctypes).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "params_generated.h"

typedef unsigned __int128 u128;

struct Field {
    const uint64_t *p, *r2, *one;
    uint64_t n0;
};

static const Field BLS_FIELD = {BLS_P, BLS_R2, BLS_ONE, BLS_N0};
static const Field ED_FIELD = {ED_P, ED_R2, ED_ONE, ED_N0};

// ---------------------------------------------------------------------------
// 384-bit Montgomery arithmetic (CIOS), 6x64 limbs
// ---------------------------------------------------------------------------

static inline bool geq(const uint64_t *a, const uint64_t *b) {
    for (int i = NLIMBS - 1; i >= 0; --i) {
        if (a[i] > b[i]) return true;
        if (a[i] < b[i]) return false;
    }
    return true;  // equal
}

static inline void sub_nocarry(uint64_t *a, const uint64_t *b) {
    unsigned char borrow = 0;
    for (int i = 0; i < NLIMBS; ++i) {
        u128 d = (u128)a[i] - b[i] - borrow;
        a[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static void fadd(const Field &F, const uint64_t *a, const uint64_t *b,
                 uint64_t *out) {
    unsigned char carry = 0;
    for (int i = 0; i < NLIMBS; ++i) {
        u128 s = (u128)a[i] + b[i] + carry;
        out[i] = (uint64_t)s;
        carry = (unsigned char)(s >> 64);
    }
    if (carry || geq(out, F.p)) sub_nocarry(out, F.p);
}

static void fsub(const Field &F, const uint64_t *a, const uint64_t *b,
                 uint64_t *out) {
    unsigned char borrow = 0;
    for (int i = 0; i < NLIMBS; ++i) {
        u128 d = (u128)a[i] - b[i] - borrow;
        out[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) {
        unsigned char carry = 0;
        for (int i = 0; i < NLIMBS; ++i) {
            u128 s = (u128)out[i] + F.p[i] + carry;
            out[i] = (uint64_t)s;
            carry = (unsigned char)(s >> 64);
        }
    }
}

static void fneg(const Field &F, const uint64_t *a, uint64_t *out) {
    bool zero = true;
    for (int i = 0; i < NLIMBS; ++i) zero &= (a[i] == 0);
    if (zero) {
        memset(out, 0, NLIMBS * 8);
        return;
    }
    uint64_t t[NLIMBS];
    memcpy(t, F.p, sizeof t);
    sub_nocarry(t, a);
    memcpy(out, t, sizeof t);
}

static void fmul(const Field &F, const uint64_t *a, const uint64_t *b,
                 uint64_t *out) {
    uint64_t t[NLIMBS + 2] = {0};
    for (int i = 0; i < NLIMBS; ++i) {
        u128 c = 0;
        for (int j = 0; j < NLIMBS; ++j) {
            u128 r = (u128)a[j] * b[i] + t[j] + c;
            t[j] = (uint64_t)r;
            c = r >> 64;
        }
        u128 r = (u128)t[NLIMBS] + c;
        t[NLIMBS] = (uint64_t)r;
        t[NLIMBS + 1] = (uint64_t)(r >> 64);

        uint64_t m = t[0] * F.n0;
        c = ((u128)m * F.p[0] + t[0]) >> 64;
        for (int j = 1; j < NLIMBS; ++j) {
            u128 r2v = (u128)m * F.p[j] + t[j] + c;
            t[j - 1] = (uint64_t)r2v;
            c = r2v >> 64;
        }
        r = (u128)t[NLIMBS] + c;
        t[NLIMBS - 1] = (uint64_t)r;
        t[NLIMBS] = t[NLIMBS + 1] + (uint64_t)(r >> 64);
        t[NLIMBS + 1] = 0;
    }
    if (t[NLIMBS] || geq(t, F.p)) sub_nocarry(t, F.p);
    memcpy(out, t, NLIMBS * 8);
}

static void fsqr(const Field &F, const uint64_t *a, uint64_t *out) {
    fmul(F, a, a, out);
}

static void to_mont(const Field &F, const uint64_t *a, uint64_t *out) {
    fmul(F, a, F.r2, out);
}

static void from_mont(const Field &F, const uint64_t *a, uint64_t *out) {
    uint64_t one[NLIMBS] = {1, 0, 0, 0, 0, 0};
    fmul(F, a, one, out);
}

// out = a^(p-2) mod p (inverse), square-and-multiply MSB-first
static void finv(const Field &F, const uint64_t *a, uint64_t *out) {
    uint64_t e[NLIMBS];
    memcpy(e, F.p, sizeof e);
    // e = p - 2
    unsigned char borrow = 0;
    u128 d = (u128)e[0] - 2;
    e[0] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
    for (int i = 1; i < NLIMBS && borrow; ++i) {
        d = (u128)e[i] - borrow;
        e[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    uint64_t acc[NLIMBS];
    memcpy(acc, F.one, sizeof acc);
    bool started = false;
    for (int i = NLIMBS - 1; i >= 0; --i) {
        for (int b = 63; b >= 0; --b) {
            if (started) fsqr(F, acc, acc);
            if ((e[i] >> b) & 1) {
                if (started)
                    fmul(F, acc, a, acc);
                else {
                    memcpy(acc, a, sizeof acc);
                    started = true;
                }
            }
        }
    }
    memcpy(out, acc, NLIMBS * 8);
}

// ---------------------------------------------------------------------------
// BLS12-377 G1: projective short Weierstrass, a = 0 (unified add-2002-bj
// and dbl-2007-bl — the same formula family as the device kernels)
// ---------------------------------------------------------------------------

struct G1 {
    uint64_t x[NLIMBS], y[NLIMBS], z[NLIMBS];
};

static bool g1_is_zero(const G1 &p) {
    for (int i = 0; i < NLIMBS; ++i)
        if (p.z[i]) return false;
    return true;
}

static void g1_set_zero(G1 &p) {
    memset(&p, 0, sizeof p);
    memcpy(p.y, BLS_FIELD.one, NLIMBS * 8);
}

static void g1_add(const G1 &a, const G1 &b, G1 &out) {
    const Field &F = BLS_FIELD;
    if (g1_is_zero(a)) {
        out = b;
        return;
    }
    if (g1_is_zero(b)) {
        out = a;
        return;
    }
    uint64_t u1[NLIMBS], u2[NLIMBS], s1[NLIMBS], s2[NLIMBS], zz[NLIMBS];
    uint64_t t[NLIMBS], m[NLIMBS], u1u2[NLIMBS], tt[NLIMBS], r[NLIMBS];
    uint64_t f[NLIMBS], l[NLIMBS], g[NLIMBS], rr[NLIMBS], w[NLIMBS];
    uint64_t tmp[NLIMBS], tmp2[NLIMBS];
    fmul(F, a.x, b.z, u1);
    fmul(F, b.x, a.z, u2);
    fmul(F, a.y, b.z, s1);
    fmul(F, b.y, a.z, s2);
    fmul(F, a.z, b.z, zz);
    fadd(F, u1, u2, t);
    fadd(F, s1, s2, m);
    fmul(F, u1, u2, u1u2);
    fmul(F, t, t, tt);
    fsub(F, tt, u1u2, r);
    fmul(F, zz, m, f);
    fmul(F, m, f, l);
    fmul(F, t, l, g);
    fmul(F, r, r, rr);
    fsub(F, rr, g, w);
    fmul(F, f, w, tmp);
    fadd(F, tmp, tmp, out.x);
    fadd(F, w, w, tmp);
    fsub(F, g, tmp, tmp2);
    fmul(F, r, tmp2, tmp);
    fmul(F, l, l, tmp2);
    fsub(F, tmp, tmp2, out.y);
    fmul(F, f, f, tmp);
    fmul(F, tmp, f, tmp2);
    fadd(F, tmp2, tmp2, out.z);
}

static void g1_double(const G1 &p, G1 &out) {
    const Field &F = BLS_FIELD;
    uint64_t xx[NLIMBS], w[NLIMBS], s[NLIMBS], ss[NLIMBS], sss[NLIMBS];
    uint64_t r[NLIMBS], rr[NLIMBS], b[NLIMBS], h[NLIMBS];
    uint64_t tmp[NLIMBS], tmp2[NLIMBS];
    fmul(F, p.x, p.x, xx);
    fadd(F, xx, xx, w);
    fadd(F, w, xx, w);  // 3*xx
    fmul(F, p.y, p.z, tmp);
    fadd(F, tmp, tmp, s);  // 2*y*z
    fmul(F, s, s, ss);
    fmul(F, ss, s, sss);
    fmul(F, p.y, s, r);
    fmul(F, r, r, rr);
    fadd(F, p.x, r, tmp);
    fmul(F, tmp, tmp, tmp2);
    fsub(F, tmp2, xx, tmp2);
    fsub(F, tmp2, rr, b);
    fmul(F, w, w, tmp);
    fadd(F, b, b, tmp2);
    fsub(F, tmp, tmp2, h);
    fmul(F, h, s, out.x);
    fsub(F, b, h, tmp);
    fmul(F, w, tmp, tmp2);
    fadd(F, rr, rr, tmp);
    fsub(F, tmp2, tmp, out.y);
    memcpy(out.z, sss, NLIMBS * 8);
}

// ---------------------------------------------------------------------------
// Twisted Edwards BLS12 (a = -1, d = 3021): extended coords, complete add
// ---------------------------------------------------------------------------

struct Ed {
    uint64_t x[NLIMBS], y[NLIMBS], t[NLIMBS], z[NLIMBS];
};

static void ed_set_zero(Ed &p) {
    memset(&p, 0, sizeof p);
    memcpy(p.y, ED_FIELD.one, NLIMBS * 8);
    memcpy(p.z, ED_FIELD.one, NLIMBS * 8);
}

static void ed_add(const Ed &p1, const Ed &p2, Ed &out) {
    const Field &F = ED_FIELD;
    uint64_t a[NLIMBS], b[NLIMBS], c[NLIMBS], d[NLIMBS], e[NLIMBS];
    uint64_t f[NLIMBS], g[NLIMBS], h[NLIMBS], tmp[NLIMBS], tmp2[NLIMBS];
    fmul(F, p1.x, p2.x, a);
    fmul(F, p1.y, p2.y, b);
    fmul(F, p1.t, p2.t, tmp);
    fmul(F, ED_D_MONT, tmp, c);
    fmul(F, p1.z, p2.z, d);
    fadd(F, p1.x, p1.y, tmp);
    fadd(F, p2.x, p2.y, tmp2);
    fmul(F, tmp, tmp2, e);
    fsub(F, e, a, e);
    fsub(F, e, b, e);
    fsub(F, d, c, f);
    fadd(F, d, c, g);
    fadd(F, b, a, h);  // b - (-1)*a
    fmul(F, e, f, out.x);
    fmul(F, g, h, out.y);
    fmul(F, e, h, out.t);
    fmul(F, f, g, out.z);
}

// ---------------------------------------------------------------------------
// Pippenger MSM (unsigned, window c=13) — independent of the device design.
// Windows are independent, so they run on a std::thread pool: the parallel
// role of the reference's rayon-backed WASM worker pool
// (src/workers/wasmMSM.ts:1-13), which verified 2^20 cases in seconds.
// ---------------------------------------------------------------------------

template <typename Point, void (*ADD)(const Point &, const Point &, Point &),
          void (*SET_ZERO)(Point &)>
static void pippenger_window(const std::vector<Point> &points,
                             const uint8_t *scalars, size_t n, int w,
                             Point &out) {
    const int C = 13;
    const size_t nbuckets = ((size_t)1 << C) - 1;
    std::vector<Point> buckets(nbuckets);
    for (size_t i = 0; i < nbuckets; ++i) SET_ZERO(buckets[i]);
    for (size_t i = 0; i < n; ++i) {
        // extract C bits starting at w*C from the 32-byte LE scalar
        int bit = w * C;
        int byte = bit >> 3, off = bit & 7;
        uint32_t v = 0;
        for (int k = 0; k < 4 && byte + k < 32; ++k)
            v |= (uint32_t)scalars[i * 32 + byte + k] << (8 * k);
        v = (v >> off) & ((1u << C) - 1);
        if (v) {
            Point t;
            ADD(buckets[v - 1], points[i], t);
            buckets[v - 1] = t;
        }
    }
    Point running, total, t;
    SET_ZERO(running);
    SET_ZERO(total);
    for (size_t b = nbuckets; b-- > 0;) {
        ADD(running, buckets[b], t);
        running = t;
        ADD(total, running, t);
        total = t;
    }
    out = total;
}

template <typename Point, void (*ADD)(const Point &, const Point &, Point &),
          void (*SET_ZERO)(Point &)>
static void pippenger(const std::vector<Point> &points,
                      const uint8_t *scalars, size_t n, Point &result) {
    const int C = 13;
    const int NBITS = 256;
    const int windows = (NBITS + C - 1) / C;
    std::vector<Point> window_sums(windows);
    unsigned hw = std::thread::hardware_concurrency();
    if (n >= 4096 && hw > 1) {
        std::vector<std::thread> pool;
        pool.reserve(windows);
        for (int w = 0; w < windows; ++w)
            pool.emplace_back(pippenger_window<Point, ADD, SET_ZERO>,
                              std::cref(points), scalars, n, w,
                              std::ref(window_sums[w]));
        for (auto &th : pool) th.join();
    } else {
        for (int w = 0; w < windows; ++w)
            pippenger_window<Point, ADD, SET_ZERO>(points, scalars, n, w,
                                                   window_sums[w]);
    }
    Point acc = window_sums[windows - 1];
    for (int w = windows - 2; w >= 0; --w) {
        for (int k = 0; k < C; ++k) {
            Point t;
            ADD(acc, acc, t);  // complete/unified add doubles correctly
            acc = t;
        }
        Point t;
        ADD(acc, window_sums[w], t);
        acc = t;
    }
    result = acc;
}

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

// false when the coordinate is not below p
static bool read_coord(const Field &F, const uint8_t *src, int nbytes,
                       uint64_t *out_mont) {
    uint64_t v[NLIMBS] = {0};
    memcpy(v, src, nbytes);
    if (geq(v, F.p)) return false;
    to_mont(F, v, out_mont);
    return true;
}

extern "C" int msm_g1(const uint8_t *points, const uint8_t *scalars,
                      size_t n, uint8_t *out) {
    std::vector<G1> pts(n);
    for (size_t i = 0; i < n; ++i) {
        if (!read_coord(BLS_FIELD, points + i * 96, 48, pts[i].x) ||
            !read_coord(BLS_FIELD, points + i * 96 + 48, 48, pts[i].y))
            return 1;
        memcpy(pts[i].z, BLS_FIELD.one, NLIMBS * 8);
    }
    G1 res;
    pippenger<G1, g1_add, g1_set_zero>(pts, scalars, n, res);
    uint64_t zi[NLIMBS], x[NLIMBS], y[NLIMBS], tmp[NLIMBS];
    if (g1_is_zero(res)) {
        memset(out, 0, 96);
        out[48] = 1;  // affine encoding of zero: (0, 1)
        return 0;
    }
    finv(BLS_FIELD, res.z, zi);
    fmul(BLS_FIELD, res.x, zi, tmp);
    from_mont(BLS_FIELD, tmp, x);
    fmul(BLS_FIELD, res.y, zi, tmp);
    from_mont(BLS_FIELD, tmp, y);
    memset(out, 0, 96);
    memcpy(out, x, 48);
    memcpy(out + 48, y, 48);
    return 0;
}

extern "C" int msm_edwards(const uint8_t *points, const uint8_t *scalars,
                           size_t n, uint8_t *out) {
    std::vector<Ed> pts(n);
    for (size_t i = 0; i < n; ++i) {
        if (!read_coord(ED_FIELD, points + i * 64, 32, pts[i].x) ||
            !read_coord(ED_FIELD, points + i * 64 + 32, 32, pts[i].y))
            return 1;
        fmul(ED_FIELD, pts[i].x, pts[i].y, pts[i].t);
        memcpy(pts[i].z, ED_FIELD.one, NLIMBS * 8);
    }
    Ed res;
    pippenger<Ed, ed_add, ed_set_zero>(pts, scalars, n, res);
    uint64_t zi[NLIMBS], x[NLIMBS], y[NLIMBS], tmp[NLIMBS];
    finv(ED_FIELD, res.z, zi);
    fmul(ED_FIELD, res.x, zi, tmp);
    from_mont(ED_FIELD, tmp, x);
    fmul(ED_FIELD, res.y, zi, tmp);
    from_mont(ED_FIELD, tmp, y);
    memset(out, 0, 64);
    memcpy(out, x, 32);
    memcpy(out + 32, y, 32);
    return 0;
}
