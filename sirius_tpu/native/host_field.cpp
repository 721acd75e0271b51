// Native host runtime: 256-bit Montgomery field arithmetic + Pippenger MSM.
//
// Fills the "native runtime" role of the reference's Rust host code
// (reference is a pure-Rust library using halo2curves + rayon, see e.g.
// src/commitment.rs, best_multiexp usage): batch field ops and a
// multi-threaded Pippenger multi-scalar multiplication for the host side
// of the framework (verification oracle, CPU commitments, bench gold
// checks).  The device compute path lives in jax/XLA (ops/msm.py); this is
// the CPU complement, written from scratch.
//
// Representation: 4 x u64 little-endian limbs; short Weierstrass curves
// with a = 0 (bn256, grumpkin, pasta).  All extern "C" entry points take
// and return STANDARD-form (non-Montgomery) limbs; Montgomery form is an
// internal detail.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC host_field.cpp

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

typedef uint64_t u64;
typedef unsigned __int128 u128;

struct Ctx {
    u64 p[4];     // modulus
    u64 n0;       // -p^{-1} mod 2^64
    u64 r2[4];    // R^2 mod p  (R = 2^256)
    u64 one[4];   // R mod p    (1 in Montgomery form)
    u64 pm2[4];   // p - 2      (Fermat inversion exponent)
    u64 b_mont[4];// curve coefficient b in Montgomery form (for y^2=x^3+b)
};

// ---------------------------------------------------------------- basics

static inline int cmp4(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; --i) {
        if (a[i] < b[i]) return -1;
        if (a[i] > b[i]) return 1;
    }
    return 0;
}

static inline int is_zero4(const u64 a[4]) {
    return (a[0] | a[1] | a[2] | a[3]) == 0;
}

static inline void add_mod(const Ctx* c, const u64 a[4], const u64 b[4], u64 out[4]) {
    u128 carry = 0;
    u64 t[4];
    for (int i = 0; i < 4; ++i) {
        u128 cur = (u128)a[i] + b[i] + carry;
        t[i] = (u64)cur;
        carry = cur >> 64;
    }
    if (carry || cmp4(t, c->p) >= 0) {
        u128 borrow = 0;
        for (int i = 0; i < 4; ++i) {
            u128 cur = (u128)t[i] - c->p[i] - borrow;
            out[i] = (u64)cur;
            borrow = (cur >> 64) & 1;
        }
    } else {
        memcpy(out, t, sizeof t);
    }
}

static inline void sub_mod(const Ctx* c, const u64 a[4], const u64 b[4], u64 out[4]) {
    u128 borrow = 0;
    u64 t[4];
    for (int i = 0; i < 4; ++i) {
        u128 cur = (u128)a[i] - b[i] - borrow;
        t[i] = (u64)cur;
        borrow = (cur >> 64) & 1;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; ++i) {
            u128 cur = (u128)t[i] + c->p[i] + carry;
            out[i] = (u64)cur;
            carry = cur >> 64;
        }
    } else {
        memcpy(out, t, sizeof t);
    }
}

static inline void dbl_mod(const Ctx* c, const u64 a[4], u64 out[4]) {
    add_mod(c, a, a, out);
}

// CIOS Montgomery multiplication, 4 limbs.
static inline void mont_mul(const Ctx* c, const u64 a[4], const u64 b[4], u64 out[4]) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 carry = 0;
        for (int j = 0; j < 4; ++j) {
            u128 cur = (u128)a[j] * b[i] + t[j] + carry;
            t[j] = (u64)cur;
            carry = cur >> 64;
        }
        u128 cur = (u128)t[4] + carry;
        t[4] = (u64)cur;
        t[5] = (u64)(cur >> 64);

        u64 m = t[0] * c->n0;
        carry = ((u128)m * c->p[0] + t[0]) >> 64;
        for (int j = 1; j < 4; ++j) {
            cur = (u128)m * c->p[j] + t[j] + carry;
            t[j - 1] = (u64)cur;
            carry = cur >> 64;
        }
        cur = (u128)t[4] + carry;
        t[3] = (u64)cur;
        t[4] = t[5] + (u64)(cur >> 64);
        t[5] = 0;
    }
    if (t[4] || cmp4(t, c->p) >= 0) {
        u128 borrow = 0;
        for (int i = 0; i < 4; ++i) {
            u128 cur = (u128)t[i] - c->p[i] - borrow;
            out[i] = (u64)cur;
            borrow = (cur >> 64) & 1;
        }
    } else {
        memcpy(out, t, 4 * sizeof(u64));
    }
}

static inline void mont_sqr(const Ctx* c, const u64 a[4], u64 out[4]) {
    mont_mul(c, a, a, out);
}

static inline void to_mont(const Ctx* c, const u64 a[4], u64 out[4]) {
    mont_mul(c, a, c->r2, out);
}

static inline void from_mont(const Ctx* c, const u64 a[4], u64 out[4]) {
    u64 one_std[4] = {1, 0, 0, 0};
    mont_mul(c, a, one_std, out);
}

// Montgomery exponentiation, 256-bit exponent, MSB-first square & multiply.
static void mont_pow(const Ctx* c, const u64 base[4], const u64 e[4], u64 out[4]) {
    u64 acc[4];
    memcpy(acc, c->one, sizeof acc);
    for (int bit = 255; bit >= 0; --bit) {
        mont_sqr(c, acc, acc);
        if ((e[bit / 64] >> (bit % 64)) & 1) {
            mont_mul(c, acc, base, acc);
        }
    }
    memcpy(out, acc, 4 * sizeof(u64));
}

static inline void mont_inv(const Ctx* c, const u64 a[4], u64 out[4]) {
    mont_pow(c, a, c->pm2, out);  // a^{p-2}; 0 maps to 0
}

// ---------------------------------------------------------------- context

extern "C" void st_init_ctx(Ctx* c, const u64 p[4], const u64 b_std[4]) {
    memcpy(c->p, p, 4 * sizeof(u64));
    // n0 = -p^{-1} mod 2^64 (Newton iteration)
    u64 inv = 1;
    for (int i = 0; i < 6; ++i) inv *= 2 - p[0] * inv;
    c->n0 = (u64)(0 - inv);
    // one = R mod p: double 1 mod p 256 times; r2 = R^2 mod p: 256 more.
    u64 x[4] = {1, 0, 0, 0};
    if (cmp4(x, c->p) >= 0) { /* p > 1 always */ }
    for (int i = 0; i < 256; ++i) dbl_mod(c, x, x);
    memcpy(c->one, x, sizeof x);
    for (int i = 0; i < 256; ++i) dbl_mod(c, x, x);
    memcpy(c->r2, x, sizeof x);
    // pm2 = p - 2
    u128 borrow = 0;
    u64 two[4] = {2, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 cur = (u128)p[i] - two[i] - borrow;
        c->pm2[i] = (u64)cur;
        borrow = (cur >> 64) & 1;
    }
    to_mont(c, b_std, c->b_mont);
}

extern "C" size_t st_ctx_size() { return sizeof(Ctx); }

// ------------------------------------------------------------- batch ops
// All batch entry points: standard-form in, standard-form out.

extern "C" void st_add_batch(const Ctx* c, const u64* a, const u64* b, u64* out, size_t n) {
    for (size_t i = 0; i < n; ++i) add_mod(c, a + 4 * i, b + 4 * i, out + 4 * i);
}

extern "C" void st_sub_batch(const Ctx* c, const u64* a, const u64* b, u64* out, size_t n) {
    for (size_t i = 0; i < n; ++i) sub_mod(c, a + 4 * i, b + 4 * i, out + 4 * i);
}

extern "C" void st_mul_batch(const Ctx* c, const u64* a, const u64* b, u64* out, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        u64 am[4], bm[4], r[4];
        to_mont(c, a + 4 * i, am);
        to_mont(c, b + 4 * i, bm);
        mont_mul(c, am, bm, r);
        from_mont(c, r, out + 4 * i);
    }
}

// Batch inversion (Montgomery's trick): one field inversion total.
extern "C" void st_inv_batch(const Ctx* c, const u64* a, u64* out, size_t n) {
    if (n == 0) return;
    std::vector<u64> am(4 * n), prefix(4 * n);
    u64 acc[4];
    memcpy(acc, c->one, sizeof acc);
    for (size_t i = 0; i < n; ++i) {
        to_mont(c, a + 4 * i, &am[4 * i]);
        memcpy(&prefix[4 * i], acc, 4 * sizeof(u64));  // product of a[0..i)
        if (!is_zero4(&am[4 * i])) mont_mul(c, acc, &am[4 * i], acc);
    }
    u64 inv_acc[4];
    mont_inv(c, acc, inv_acc);
    for (size_t i = n; i-- > 0;) {
        u64* ai = &am[4 * i];
        u64* oi = out + 4 * i;
        if (is_zero4(ai)) {
            memset(oi, 0, 4 * sizeof(u64));  // inv(0) := 0, matching gold
            continue;
        }
        u64 r[4];
        mont_mul(c, inv_acc, &prefix[4 * i], r);  // = inv(a[i] * suffix-after)
        mont_mul(c, inv_acc, ai, inv_acc);        // strip a[i] from running inverse
        from_mont(c, r, oi);
    }
}

// ------------------------------------------------------------- EC points
// Jacobian coordinates (X, Y, Z) in Montgomery form; Z == 0 is infinity.
// Curves have a = 0.

struct Jac { u64 X[4], Y[4], Z[4]; };

static inline void jac_set_inf(Jac* r) { memset(r, 0, sizeof(Jac)); }
static inline int jac_is_inf(const Jac* r) { return is_zero4(r->Z); }

// dbl-2009-l (a = 0)
static void jac_dbl(const Ctx* c, const Jac* pt, Jac* out) {
    if (jac_is_inf(pt)) { *out = *pt; return; }
    u64 A[4], B[4], C[4], D[4], E[4], F[4], t[4], t2[4];
    mont_sqr(c, pt->X, A);
    mont_sqr(c, pt->Y, B);
    mont_sqr(c, B, C);
    add_mod(c, pt->X, B, t);
    mont_sqr(c, t, t);
    sub_mod(c, t, A, t);
    sub_mod(c, t, C, t);
    dbl_mod(c, t, D);
    add_mod(c, A, A, E);
    add_mod(c, E, A, E);  // 3A
    mont_sqr(c, E, F);
    Jac r;
    sub_mod(c, F, D, r.X);
    sub_mod(c, r.X, D, r.X);               // X3 = F - 2D
    sub_mod(c, D, r.X, t2);
    mont_mul(c, E, t2, t2);
    dbl_mod(c, C, t);
    dbl_mod(c, t, t);
    dbl_mod(c, t, t);                      // 8C
    sub_mod(c, t2, t, r.Y);                // Y3 = E(D - X3) - 8C
    mont_mul(c, pt->Y, pt->Z, t);
    dbl_mod(c, t, r.Z);                    // Z3 = 2YZ
    *out = r;
}

// Mixed addition: Jacobian += affine (Montgomery), madd-2007-bl (a = 0).
static void jac_add_affine(const Ctx* c, const Jac* p1, const u64 x2[4], const u64 y2[4], Jac* out) {
    if (jac_is_inf(p1)) {
        memcpy(out->X, x2, 4 * sizeof(u64));
        memcpy(out->Y, y2, 4 * sizeof(u64));
        memcpy(out->Z, c->one, 4 * sizeof(u64));
        return;
    }
    u64 Z1Z1[4], U2[4], S2[4], H[4], HH[4], I[4], J[4], rr[4], V[4], t[4];
    mont_sqr(c, p1->Z, Z1Z1);
    mont_mul(c, x2, Z1Z1, U2);
    mont_mul(c, y2, p1->Z, S2);
    mont_mul(c, S2, Z1Z1, S2);
    sub_mod(c, U2, p1->X, H);
    sub_mod(c, S2, p1->Y, rr);
    if (is_zero4(H)) {
        if (is_zero4(rr)) { jac_dbl(c, p1, out); return; }
        jac_set_inf(out);
        return;
    }
    dbl_mod(c, rr, rr);                    // r = 2(S2 - Y1)
    mont_sqr(c, H, HH);
    dbl_mod(c, HH, I);
    dbl_mod(c, I, I);                      // I = 4 HH
    mont_mul(c, H, I, J);
    mont_mul(c, p1->X, I, V);
    Jac r;
    mont_sqr(c, rr, r.X);
    sub_mod(c, r.X, J, r.X);
    sub_mod(c, r.X, V, r.X);
    sub_mod(c, r.X, V, r.X);               // X3 = r^2 - J - 2V
    sub_mod(c, V, r.X, t);
    mont_mul(c, rr, t, t);
    u64 y1j[4];
    mont_mul(c, p1->Y, J, y1j);
    dbl_mod(c, y1j, y1j);
    sub_mod(c, t, y1j, r.Y);               // Y3 = r(V - X3) - 2 Y1 J
    add_mod(c, p1->Z, H, t);
    mont_sqr(c, t, t);
    sub_mod(c, t, Z1Z1, t);
    sub_mod(c, t, HH, r.Z);                // Z3 = (Z1 + H)^2 - Z1Z1 - HH
    *out = r;
}

// Full Jacobian addition, add-2007-bl.
static void jac_add(const Ctx* c, const Jac* p1, const Jac* p2, Jac* out) {
    if (jac_is_inf(p1)) { *out = *p2; return; }
    if (jac_is_inf(p2)) { *out = *p1; return; }
    u64 Z1Z1[4], Z2Z2[4], U1[4], U2[4], S1[4], S2[4], H[4], I[4], J[4], rr[4], V[4], t[4];
    mont_sqr(c, p1->Z, Z1Z1);
    mont_sqr(c, p2->Z, Z2Z2);
    mont_mul(c, p1->X, Z2Z2, U1);
    mont_mul(c, p2->X, Z1Z1, U2);
    mont_mul(c, p1->Y, p2->Z, S1);
    mont_mul(c, S1, Z2Z2, S1);
    mont_mul(c, p2->Y, p1->Z, S2);
    mont_mul(c, S2, Z1Z1, S2);
    sub_mod(c, U2, U1, H);
    sub_mod(c, S2, S1, rr);
    if (is_zero4(H)) {
        if (is_zero4(rr)) { jac_dbl(c, p1, out); return; }
        jac_set_inf(out);
        return;
    }
    dbl_mod(c, rr, rr);                    // r = 2(S2 - S1)
    dbl_mod(c, H, t);
    mont_sqr(c, t, I);                     // I = (2H)^2
    mont_mul(c, H, I, J);
    mont_mul(c, U1, I, V);
    Jac r;
    mont_sqr(c, rr, r.X);
    sub_mod(c, r.X, J, r.X);
    sub_mod(c, r.X, V, r.X);
    sub_mod(c, r.X, V, r.X);               // X3 = r^2 - J - 2V
    sub_mod(c, V, r.X, t);
    mont_mul(c, rr, t, t);
    u64 s1j[4];
    mont_mul(c, S1, J, s1j);
    dbl_mod(c, s1j, s1j);
    sub_mod(c, t, s1j, r.Y);               // Y3 = r(V - X3) - 2 S1 J
    add_mod(c, p1->Z, p2->Z, t);
    mont_sqr(c, t, t);
    sub_mod(c, t, Z1Z1, t);
    sub_mod(c, t, Z2Z2, t);
    mont_mul(c, t, H, r.Z);                // Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) H
    *out = r;
}

// --------------------------------------------------------------- Pippenger

struct MsmJob {
    const Ctx* c;
    const u64* xm;        // Montgomery affine xs, n*4
    const u64* ym;
    const uint8_t* inf;   // infinity flags (may be null)
    const u64* scalars;   // standard form, n*4
    size_t n;
    int cbits;
    Jac* window_sums;     // one per window
};

static void msm_window(const MsmJob* job, int w) {
    const int cbits = job->cbits;
    const u64 mask = (cbits == 64) ? ~0ull : ((1ull << cbits) - 1);
    const size_t nbuckets = ((size_t)1 << cbits) - 1;
    std::vector<Jac> buckets(nbuckets);
    for (auto& b : buckets) jac_set_inf(&b);
    const int bit0 = w * cbits;
    for (size_t i = 0; i < job->n; ++i) {
        if (job->inf && job->inf[i]) continue;
        const u64* s = job->scalars + 4 * i;
        int limb = bit0 / 64, off = bit0 % 64;
        u64 d = s[limb] >> off;
        if (off && limb + 1 < 4 && off + cbits > 64) d |= s[limb + 1] << (64 - off);
        d &= mask;
        if (!d) continue;
        Jac* b = &buckets[d - 1];
        jac_add_affine(job->c, b, job->xm + 4 * i, job->ym + 4 * i, b);
    }
    Jac running, sum;
    jac_set_inf(&running);
    jac_set_inf(&sum);
    for (size_t b = nbuckets; b-- > 0;) {
        jac_add(job->c, &running, &buckets[b], &running);
        jac_add(job->c, &sum, &running, &sum);
    }
    job->window_sums[w] = sum;
}

// xs/ys/scalars: n*4 u64 standard form; inf: n bytes (nullable).
// out_xy: 8 u64 (affine x, y standard form); returns 1 if result is infinity.
extern "C" int st_msm(const Ctx* c, const u64* xs, const u64* ys, const uint8_t* inf,
                      const u64* scalars, size_t n, int cbits, int nthreads,
                      u64* out_xy) {
    if (cbits <= 0) {
        cbits = 3;
        for (size_t m = n; m >>= 1;) ++cbits;
        cbits = cbits / 2 + 2;
        if (cbits < 4) cbits = 4;
        if (cbits > 16) cbits = 16;
    }
    const int windows = (256 + cbits - 1) / cbits;
    std::vector<u64> xm(4 * n), ym(4 * n);
    for (size_t i = 0; i < n; ++i) {
        to_mont(c, xs + 4 * i, &xm[4 * i]);
        to_mont(c, ys + 4 * i, &ym[4 * i]);
    }
    std::vector<Jac> sums(windows);
    MsmJob job{c, xm.data(), ym.data(), inf, scalars, n, cbits, sums.data()};
    if (nthreads <= 1) {
        for (int w = 0; w < windows; ++w) msm_window(&job, w);
    } else {
        std::vector<std::thread> ts;
        std::vector<int> next(1, 0);
        for (int t = 0; t < nthreads; ++t) {
            ts.emplace_back([&job, windows, t, nthreads]() {
                for (int w = t; w < windows; w += nthreads) msm_window(&job, w);
            });
        }
        for (auto& th : ts) th.join();
    }
    Jac acc = sums[windows - 1];
    for (int w = windows - 2; w >= 0; --w) {
        for (int d = 0; d < cbits; ++d) jac_dbl(c, &acc, &acc);
        jac_add(c, &acc, &sums[w], &acc);
    }
    if (jac_is_inf(&acc)) {
        memset(out_xy, 0, 8 * sizeof(u64));
        return 1;
    }
    // to affine: x = X/Z^2, y = Y/Z^3
    u64 zinv[4], zinv2[4], zinv3[4];
    mont_inv(c, acc.Z, zinv);
    mont_sqr(c, zinv, zinv2);
    mont_mul(c, zinv2, zinv, zinv3);
    u64 xa[4], ya[4];
    mont_mul(c, acc.X, zinv2, xa);
    mont_mul(c, acc.Y, zinv3, ya);
    from_mont(c, xa, out_xy);
    from_mont(c, ya, out_xy + 4);
    return 0;
}
