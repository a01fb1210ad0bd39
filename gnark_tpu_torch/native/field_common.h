// Generic N x 64-bit Montgomery field arithmetic (CIOS) shared by the
// native solver, field-vector and MSM cores.  Header-only template.
#pragma once
#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

template <int N>
struct Field {
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

