// Generic N x 64-bit Montgomery field arithmetic (CIOS) shared by the
// native solver, field-vector and MSM cores.  Header-only template.
#pragma once
#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

template <int N>
struct Field {
    static constexpr int W = N;   // u64 words an element
    u64 p[N];
    u64 pinv;      // -p^{-1} mod 2^64
    u64 r2[N];     // R^2 mod p (for to-Montgomery)
    u64 one[N];    // R mod p (Montgomery 1)

    void init(const u64* mod, const u64* r2_in, const u64* one_in) {
        std::memcpy(p, mod, sizeof(p));
        std::memcpy(r2, r2_in, sizeof(r2));
        std::memcpy(one, one_in, sizeof(one));
        // pinv via Newton iteration on 2-adics
        u64 inv = 1;
        for (int i = 0; i < 6; i++) inv *= 2 - p[0] * inv;
        pinv = ~inv + 1;   // negate mod 2^64
    }

    static bool is_zero(const u64* a) {
        u64 acc = 0;
        for (int i = 0; i < N; i++) acc |= a[i];
        return acc == 0;
    }

    bool geq_p(const u64* a) const {
        for (int i = N - 1; i >= 0; i--) {
            if (a[i] > p[i]) return true;
            if (a[i] < p[i]) return false;
        }
        return true;   // equal
    }

    void cond_sub_p(u64* a) const {
        if (!geq_p(a)) return;
        u128 borrow = 0;
        for (int i = 0; i < N; i++) {
            u128 d = (u128)a[i] - p[i] - borrow;
            a[i] = (u64)d;
            borrow = (d >> 64) & 1;
        }
    }

    void add(const u64* a, const u64* b, u64* out) const {
        u128 carry = 0;
        for (int i = 0; i < N; i++) {
            u128 s = (u128)a[i] + b[i] + carry;
            out[i] = (u64)s;
            carry = s >> 64;
        }
        // inputs < p < 2^(64N); p < 2^(64N-1) is NOT guaranteed (N*64 can
        // be tight) — but a+b < 2p < 2^(64N+1); if carry, subtract p once
        if (carry) {
            u128 borrow = 0;
            for (int i = 0; i < N; i++) {
                u128 d = (u128)out[i] - p[i] - borrow;
                out[i] = (u64)d;
                borrow = (d >> 64) & 1;
            }
        } else {
            cond_sub_p(out);
        }
    }

    void sub(const u64* a, const u64* b, u64* out) const {
        u128 borrow = 0;
        for (int i = 0; i < N; i++) {
            u128 d = (u128)a[i] - b[i] - borrow;
            out[i] = (u64)d;
            borrow = (d >> 64) & 1;
        }
        if (borrow) {
            u128 carry = 0;
            for (int i = 0; i < N; i++) {
                u128 s = (u128)out[i] + p[i] + carry;
                out[i] = (u64)s;
                carry = s >> 64;
            }
        }
    }

    // CIOS Montgomery multiplication: out = a*b*R^{-1} mod p
    void mmul(const u64* a, const u64* b, u64* out) const {
        u64 t[N + 2];
        for (int i = 0; i < N + 2; i++) t[i] = 0;
        for (int i = 0; i < N; i++) {
            u128 carry = 0;
            for (int j = 0; j < N; j++) {
                u128 cur = (u128)a[i] * b[j] + t[j] + carry;
                t[j] = (u64)cur;
                carry = cur >> 64;
            }
            u128 s = (u128)t[N] + carry;
            t[N] = (u64)s;
            t[N + 1] = (u64)(s >> 64);

            u64 m = t[0] * pinv;
            carry = ((u128)m * p[0] + t[0]) >> 64;
            for (int j = 1; j < N; j++) {
                u128 cur = (u128)m * p[j] + t[j] + carry;
                t[j - 1] = (u64)cur;
                carry = cur >> 64;
            }
            s = (u128)t[N] + carry;
            t[N - 1] = (u64)s;
            t[N] = t[N + 1] + (u64)(s >> 64);
            t[N + 1] = 0;
        }
        for (int i = 0; i < N; i++) out[i] = t[i];
        // tight moduli (e.g. Goldilocks: p ~ 2^64) can leave an overflow
        // limb in t[N]; fold it by subtracting p until it clears
        while (t[N]) {
            u128 borrow = 0;
            for (int i = 0; i < N; i++) {
                u128 d = (u128)out[i] - p[i] - borrow;
                out[i] = (u64)d;
                borrow = (d >> 64) & 1;
            }
            t[N] -= (u64)borrow;
        }
        cond_sub_p(out);
    }

    void to_mont(const u64* a, u64* out) const { mmul(a, r2, out); }

    void from_mont(const u64* a, u64* out) const {
        u64 onev[N] = {0};
        onev[0] = 1;
        mmul(a, onev, out);
    }

    // regular a * regular b mod p (two REDC passes)
    void mulmod(const u64* a, const u64* b, u64* out) const {
        u64 t[N];
        mmul(a, b, t);
        mmul(t, r2, out);
    }

    // inverse of a regular value via Fermat (a^(p-2)); 0 -> 0
    void invmod(const u64* a, u64* out) const {
        if (is_zero(a)) { std::memcpy(out, a, sizeof(u64) * N); return; }
        u64 base[N], acc[N], e[N];
        to_mont(a, base);
        std::memcpy(acc, one, sizeof(acc));
        // e = p - 2 (p odd > 2: no net borrow)
        u64 br = 2;
        for (int i = 0; i < N; i++) {
            u128 d = (u128)p[i] - br;
            e[i] = (u64)d;
            br = (u64)((d >> 64) & 1);
        }
        for (int i = N - 1; i >= 0; i--) {
            for (int bit = 63; bit >= 0; bit--) {
                mmul(acc, acc, acc);
                if ((e[i] >> bit) & 1) mmul(acc, base, acc);
            }
        }
        from_mont(acc, out);
    }
};


// fp2 = fp[u] / (u^2 - beta) over Field<N> for a small signed beta, with
// Field<N>'s interface (an element is c0's N words, then c1's): the MSM
// core's G2 over fp2 (BLS12-381, BLS12-377).  Every result is canonical.
template <int N>
struct Fp2Field {
    static constexpr int W = 2 * N;
    Field<N> b;
    int beta;
    u64 one[2 * N];

    void init(const u64* mod, const u64* r2_in, const u64* one_in,
              int beta_in) {
        b.init(mod, r2_in, one_in);
        beta = beta_in;
        std::memcpy(one, b.one, sizeof(u64) * N);
        std::memset(one + N, 0, sizeof(u64) * N);
    }

    static bool is_zero(const u64* a) {
        return Field<N>::is_zero(a) && Field<N>::is_zero(a + N);
    }

    void add(const u64* x, const u64* y, u64* out) const {
        b.add(x, y, out);
        b.add(x + N, y + N, out + N);
    }

    void sub(const u64* x, const u64* y, u64* out) const {
        b.sub(x, y, out);
        b.sub(x + N, y + N, out + N);
    }

    // out = beta * x in the base field (by additions; beta is small)
    void mul_beta(const u64* x, u64* out) const {
        const int k = beta < 0 ? -beta : beta;
        u64 t[N];
        std::memcpy(t, x, sizeof(t));
        for (int i = 1; i < k; i++) b.add(t, x, t);
        if (beta < 0) {
            u64 z[N] = {0};
            b.sub(z, t, out);
        } else {
            std::memcpy(out, t, sizeof(t));
        }
    }

    // Karatsuba; out may alias x or y
    void mmul(const u64* x, const u64* y, u64* out) const {
        u64 v0[N], v1[N], sx[N], sy[N], s[N], t[N];
        b.mmul(x, y, v0);
        b.mmul(x + N, y + N, v1);
        b.add(x, x + N, sx);
        b.add(y, y + N, sy);
        b.mmul(sx, sy, s);
        b.sub(s, v0, s);
        b.sub(s, v1, out + N);
        mul_beta(v1, t);
        b.add(v0, t, out);
    }

    void to_mont(const u64* a, u64* out) const {
        b.to_mont(a, out);
        b.to_mont(a + N, out + N);
    }

    void from_mont(const u64* a, u64* out) const {
        b.from_mont(a, out);
        b.from_mont(a + N, out + N);
    }

    // inverse of a regular value: (c0 - u c1) / (c0^2 - beta c1^2); 0 -> 0
    void invmod(const u64* a, u64* out) const {
        u64 s0[N], s1[N], t[N], nrm[N], ninv[N], z[N] = {0};
        b.mulmod(a, a, s0);
        b.mulmod(a + N, a + N, s1);
        mul_beta(s1, t);
        b.sub(s0, t, nrm);
        b.invmod(nrm, ninv);
        b.mulmod(a, ninv, out);
        b.mulmod(a + N, ninv, t);
        b.sub(z, t, out + N);
    }
};
