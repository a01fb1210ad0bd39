// R1CS witness-solver core: C++ scalar walk over Montgomery limbs.
//
// The host-side counterpart of the reference's Go solver
// (internal/backend/bn254/cs/r1cs.go:280 solveConstraint + parallelSolve):
// python-int mulmods are ~3us/constraint, this loop is ~60ns — it is what
// makes 2^20-constraint witness solving sub-second on a one-core
// host for NARROW level schedules, where the numpy leveled solver's
// per-level vector-op overhead cannot amortize.
//
// Field arithmetic: generic N x 64-bit Montgomery (CIOS multiplication),
// templated on the limb count and instantiated for every supported
// scalar field width (4 = 256-bit fr family, 5/6 = BW6/BLS24 outer
// fields, 8 / 12 = headroom for 512/768-bit).
//
// Wire values are exchanged with Python in REGULAR form, little-endian
// 64-bit limbs, so numpy can reinterpret them as 16-bit limb planes for
// the device without any per-element conversion.  Hint wires resolve
// through a callback into Python which reads/writes the shared
// values/solved buffers directly.

#include <cstdint>
#include <cstring>

#include "field_common.h"

extern "C" {
// returns 0 on success, nonzero on failure; may recursively resolve
// other hints; must write outputs into the shared values buffer and set
// solved flags.
typedef int (*hint_cb_t)(void* ctx, int64_t hint_idx);
}

namespace {

struct SolveArgs {
    int64_t m, nwires, nb_in, ncoeff;
    const int64_t* indptr[3];
    const int64_t* wires[3];
    const int64_t* cids[3];
    const u64* coeffs_mont;   // [ncoeff][N] (premultiplied by R)
    const u64* coeffs_inv;    // [ncoeff][N] inverses, Montgomery form
    u64* values;              // [nwires][N] regular (shared with Python)
    uint8_t* solved;          // [nwires]    (shared with Python)
    const int64_t* wire_to_hint;  // [nwires], -1 = none
    u64* av; u64* bv; u64* cv;    // [m][N] regular
    hint_cb_t hint_cb;
    void* cb_ctx;
    int check;
};

template <int N>
int64_t solve_loop(const Field<N>& F, const SolveArgs& A) {
    u64 sums[3][N];
    u64 tmp[N], term[N], inv[N];
    for (int64_t ci = 0; ci < A.m; ci++) {
        int unknown_side = -1;
        int64_t unknown_wire = -1, unknown_cid = -1;
        for (int side = 0; side < 3; side++) {
            u64* acc = sums[side];
            std::memset(acc, 0, sizeof(u64) * N);
            const int64_t lo = A.indptr[side][ci], hi = A.indptr[side][ci + 1];
            for (int64_t k = lo; k < hi; k++) {
                const int64_t w = A.wires[side][k];
                if (!A.solved[w]) {
                    const int64_t h = A.wire_to_hint[w];
                    if (h >= 0) {
                        if (A.hint_cb(A.cb_ctx, h) != 0) return -3;  // hint err
                        if (!A.solved[w]) return -3;
                    } else {
                        if (unknown_wire >= 0) return -5;   // 2 unknowns
                        unknown_side = side;
                        unknown_wire = w;
                        unknown_cid = A.cids[side][k];
                        continue;
                    }
                }
                // acc += coeff_mont * value  (one REDC: result regular)
                F.mmul(A.coeffs_mont + A.cids[side][k] * N,
                       A.values + w * N, tmp);
                F.add(acc, tmp, acc);
            }
        }
        u64 *a = sums[0], *b = sums[1], *c = sums[2];
        if (unknown_wire < 0) {
            if (A.check) {
                F.mulmod(a, b, tmp);
                if (std::memcmp(tmp, c, sizeof(u64) * N) != 0)
                    return ci;   // unsatisfied
            }
        } else {
            std::memset(term, 0, sizeof(term));
            if (unknown_side == 0) {
                if (!Field<N>::is_zero(b)) {
                    F.invmod(b, inv);
                    F.mulmod(c, inv, term);
                    F.sub(term, a, term);
                    F.add(a, term, a);
                } else if (A.check) {
                    F.mulmod(a, b, tmp);
                    if (std::memcmp(tmp, c, sizeof(u64) * N) != 0) return ci;
                }
            } else if (unknown_side == 1) {
                if (!Field<N>::is_zero(a)) {
                    F.invmod(a, inv);
                    F.mulmod(c, inv, term);
                    F.sub(term, b, term);
                    F.add(b, term, b);
                } else if (A.check) {
                    F.mulmod(a, b, tmp);
                    if (std::memcmp(tmp, c, sizeof(u64) * N) != 0) return ci;
                }
            } else {
                F.mulmod(a, b, term);
                F.sub(term, c, term);
                F.add(c, term, c);
            }
            // value = term * coeff^{-1} (inverse precomputed, mont form:
            // one REDC mul yields the regular-form product)
            F.mmul(A.coeffs_inv + unknown_cid * N, term,
                   A.values + unknown_wire * N);
            A.solved[unknown_wire] = 1;
        }
        std::memcpy(A.av + ci * N, a, sizeof(u64) * N);
        std::memcpy(A.bv + ci * N, b, sizeof(u64) * N);
        std::memcpy(A.cv + ci * N, c, sizeof(u64) * N);
    }
    return -1;   // success
}

struct ScsArgs {
    int64_t m, nwires, ncoeff;
    const int64_t *wl, *wr, *wo;          // slot wires, -1 = none
    const int64_t *ql, *qr, *qm, *qo, *qc;  // per-gate coeff ids
    const u64* coeffs_mont;               // [ncoeff][N]
    const u64* coeffs_reg;                // [ncoeff][N] regular form
    const u64* coeffs_neg_inv;            // [ncoeff][N] (-c)^{-1}, mont
    u64* values;
    uint8_t* solved;
    const int64_t* wire_to_hint;
    u64* lv; u64* rv; u64* ov;
    hint_cb_t hint_cb;
    void* cb_ctx;
    int check;
};

// PLONK gate walk: qL*l + qR*r + qM*l*r + qO*o + qC = 0 per gate, at
// most one unsolved non-hint slot (r1cs_sparse.go:305-361 semantics).
template <int N>
int64_t solve_scs_loop(const Field<N>& F, const ScsArgs& A) {
    u64 l[N], r[N], o[N], t1[N], t2[N], num[N], den[N], inv[N];
    u64 zero[N];
    std::memset(zero, 0, sizeof(zero));
    for (int64_t ci = 0; ci < A.m; ci++) {
        const int64_t slots[3] = {A.wl[ci], A.wr[ci], A.wo[ci]};
        int unknown = -1;
        for (int si = 0; si < 3; si++) {
            const int64_t w = slots[si];
            if (w >= 0 && !A.solved[w]) {
                const int64_t h = A.wire_to_hint[w];
                if (h >= 0) {
                    if (A.hint_cb(A.cb_ctx, h) != 0) return -3;
                    if (!A.solved[w]) return -3;
                } else if (unknown >= 0) {
                    return -5;
                } else {
                    unknown = si;
                }
            }
        }
        auto val = [&](int si, u64* out) {
            const int64_t w = slots[si];
            if (w >= 0 && A.solved[w])
                std::memcpy(out, A.values + w * N, sizeof(u64) * N);
            else
                std::memset(out, 0, sizeof(u64) * N);
        };
        val(0, l); val(1, r); val(2, o);
        const u64* qlm = A.coeffs_mont + A.ql[ci] * N;
        const u64* qrm = A.coeffs_mont + A.qr[ci] * N;
        const u64* qmm = A.coeffs_mont + A.qm[ci] * N;
        const u64* qom = A.coeffs_mont + A.qo[ci] * N;
        const u64* qcr = A.coeffs_reg + A.qc[ci] * N;

        auto gate_residual = [&](u64* out) {
            // ql*l + qr*r + qm*l*r + qo*o + qc (regular form)
            F.mmul(qlm, l, t1);
            F.mmul(qrm, r, t2);
            F.add(t1, t2, out);
            F.mmul(qmm, l, t1);
            F.mulmod(t1, r, t1);
            F.add(out, t1, out);
            F.mmul(qom, o, t1);
            F.add(out, t1, out);
            F.add(out, qcr, out);
        };

        if (unknown < 0) {
            if (A.check) {
                gate_residual(t2);
                if (!Field<N>::is_zero(t2)) return ci;
            }
        } else {
            if (unknown < 2 && slots[0] == slots[1]) return -6;  // quadratic
            if (unknown == 2) {
                // den = -qo is a table constant: its inverse is
                // precomputed (no per-gate Fermat inversion)
                F.mmul(qlm, l, t1);
                F.mmul(qrm, r, t2);
                F.add(t1, t2, num);
                F.mmul(qmm, l, t1);
                F.mulmod(t1, r, t1);
                F.add(num, t1, num);
                F.add(num, qcr, num);
                const u64* ninv = A.coeffs_neg_inv + A.qo[ci] * N;
                const int64_t w = slots[2];
                if (Field<N>::is_zero(ninv)) {          // qo == 0
                    if (A.check && !Field<N>::is_zero(num)) return ci;
                    std::memset(A.values + w * N, 0, sizeof(u64) * N);
                } else {
                    F.mmul(ninv, num, A.values + w * N);
                }
                A.solved[w] = 1;
                val(0, l); val(1, r); val(2, o);
                std::memcpy(A.lv + ci * N, l, sizeof(u64) * N);
                std::memcpy(A.rv + ci * N, r, sizeof(u64) * N);
                std::memcpy(A.ov + ci * N, o, sizeof(u64) * N);
                continue;
            } else if (unknown == 1) {
                F.from_mont(qrm, t1);
                F.mmul(qmm, l, t2);
                F.add(t1, t2, den);                     // qr + qm*l
                F.mmul(qlm, l, t1);
                F.mmul(qom, o, t2);
                F.add(t1, t2, num);
                F.add(num, qcr, num);
                F.sub(zero, num, num);                  // -(ql*l+qo*o+qc)
            } else {
                F.from_mont(qlm, t1);
                F.mmul(qmm, r, t2);
                F.add(t1, t2, den);                     // ql + qm*r
                F.mmul(qrm, r, t1);
                F.mmul(qom, o, t2);
                F.add(t1, t2, num);
                F.add(num, qcr, num);
                F.sub(zero, num, num);
            }
            const int64_t w = slots[unknown];
            if (Field<N>::is_zero(den)) {
                if (A.check && !Field<N>::is_zero(num)) return ci;
                std::memset(A.values + w * N, 0, sizeof(u64) * N);
            } else {
                F.invmod(den, inv);
                F.mulmod(num, inv, A.values + w * N);
            }
            A.solved[w] = 1;
            val(0, l); val(1, r); val(2, o);
        }
        std::memcpy(A.lv + ci * N, l, sizeof(u64) * N);
        std::memcpy(A.rv + ci * N, r, sizeof(u64) * N);
        std::memcpy(A.ov + ci * N, o, sizeof(u64) * N);
    }
    return -1;
}

template <int N>
void qap_accumulate(const Field<N>& F, int64_t m,
                    const int64_t* indptr, const int64_t* wires,
                    const int64_t* cids, const u64* coeffs_mont,
                    const u64* lag, u64* out) {
    u64 t[N];
    for (int64_t c = 0; c < m; c++) {
        const u64* lc = lag + c * N;
        for (int64_t k = indptr[c]; k < indptr[c + 1]; k++) {
            F.mmul(coeffs_mont + cids[k] * N, lc, t);
            u64* o = out + wires[k] * N;
            F.add(o, t, o);
        }
    }
}

template <int N>
void lincomb3(const Field<N>& F, int64_t n, const u64* A, const u64* B,
              const u64* C, const u64* ka_m, const u64* kb_m,
              const u64* s_m, u64* out) {
    u64 t[N], u[N];
    for (int64_t i = 0; i < n; i++) {
        F.mmul(ka_m, A + i * N, t);
        F.mmul(kb_m, B + i * N, u);
        F.add(t, u, t);
        F.add(t, C + i * N, t);
        F.mmul(s_m, t, out + i * N);
    }
}

template <int N>
void powers(const Field<N>& F, int64_t n, const u64* base_m,
            const u64* start, u64* out) {
    if (n <= 0) return;
    std::memcpy(out, start, sizeof(u64) * N);
    for (int64_t i = 1; i < n; i++)
        F.mmul(base_m, out + (i - 1) * N, out + i * N);
}

template <int N>
void vecmul(const Field<N>& F, int64_t n, const u64* a, const u64* b,
            int64_t stride_b, u64* out) {
    for (int64_t i = 0; i < n; i++)
        F.mulmod(a + i * N, b + i * stride_b * N, out + i * N);
}

template <int N>
void vecadd(const Field<N>& F, int64_t n, const u64* a, const u64* b,
            int64_t stride_b, u64* out) {
    for (int64_t i = 0; i < n; i++)
        F.add(a + i * N, b + i * stride_b * N, out + i * N);
}

template <int N>
void prefix_mul(const Field<N>& F, int64_t n, const u64* vals, u64* out,
                int exclusive) {
    // out[i] = prod_{j<=i} vals[j] (or j<i when exclusive)
    u64 run[N];
    std::memset(run, 0, sizeof(run));
    run[0] = 1;
    for (int64_t i = 0; i < n; i++) {
        if (exclusive) {
            std::memcpy(out + i * N, run, sizeof(run));
            F.mulmod(run, vals + i * N, run);
        } else {
            F.mulmod(run, vals + i * N, run);
            std::memcpy(out + i * N, run, sizeof(run));
        }
    }
}

template <int N>
void synth_div(const Field<N>& F, int64_t n, const u64* coeffs,
               const u64* z, u64* quotient, u64* value) {
    // p(X) = q(X)(X - z) + p(z): Horner accumulators ARE the quotient
    // coefficients (kzg.Open quotient, kzg.go dividePolyByXminusA)
    u64 acc[N];
    std::memset(acc, 0, sizeof(acc));
    for (int64_t i = n - 1; i >= 1; i--) {
        u64 t[N];
        F.mulmod(acc, z, t);
        F.add(t, coeffs + i * N, acc);
        std::memcpy(quotient + (i - 1) * N, acc, sizeof(acc));
    }
    u64 t[N];
    F.mulmod(acc, z, t);
    F.add(t, coeffs, value);
}

template <int N>
void batch_inv(const Field<N>& F, int64_t n, const u64* vals, u64* out) {
    // classic Montgomery trick, all regular form (mulmod = 2 REDC):
    // O(n) muls + ONE Fermat inversion; zeros map to zero
    // (fr.BatchInvert semantics)
    u64* prefix = new u64[(n + 1) * N];
    std::memset(prefix, 0, sizeof(u64) * N);
    prefix[0] = 1;
    for (int64_t i = 0; i < n; i++) {
        const u64* v = vals + i * N;
        if (Field<N>::is_zero(v))
            std::memcpy(prefix + (i + 1) * N, prefix + i * N,
                        sizeof(u64) * N);
        else
            F.mulmod(prefix + i * N, v, prefix + (i + 1) * N);
    }
    u64 inv[N];
    F.invmod(prefix + n * N, inv);
    for (int64_t i = n - 1; i >= 0; i--) {
        const u64* v = vals + i * N;
        if (Field<N>::is_zero(v)) {
            std::memset(out + i * N, 0, sizeof(u64) * N);
        } else {
            F.mulmod(prefix + i * N, inv, out + i * N);
            F.mulmod(inv, v, inv);
        }
    }
    delete[] prefix;
}

}  // namespace

extern "C" {

// returns: -1 success; >= 0 failing constraint id; -3 hint error;
//          -2-4k: constraint k has two unknown wires; -4 bad nlimbs
int64_t gnark_solve_r1cs(
    int nlimbs,
    const u64* modulus, const u64* r2, const u64* one_mont,
    int64_t m, int64_t nwires, int64_t ncoeff,
    const int64_t* indptr_l, const int64_t* wires_l, const int64_t* cids_l,
    const int64_t* indptr_r, const int64_t* wires_r, const int64_t* cids_r,
    const int64_t* indptr_o, const int64_t* wires_o, const int64_t* cids_o,
    const u64* coeffs_mont, const u64* coeffs_inv,
    u64* values, uint8_t* solved, const int64_t* wire_to_hint,
    u64* av, u64* bv, u64* cv,
    hint_cb_t hint_cb, void* cb_ctx, int check) {
    SolveArgs A;
    A.m = m; A.nwires = nwires; A.ncoeff = ncoeff;
    A.indptr[0] = indptr_l; A.wires[0] = wires_l; A.cids[0] = cids_l;
    A.indptr[1] = indptr_r; A.wires[1] = wires_r; A.cids[1] = cids_r;
    A.indptr[2] = indptr_o; A.wires[2] = wires_o; A.cids[2] = cids_o;
    A.coeffs_mont = coeffs_mont;
    A.coeffs_inv = coeffs_inv;
    A.values = values; A.solved = solved; A.wire_to_hint = wire_to_hint;
    A.av = av; A.bv = bv; A.cv = cv;
    A.hint_cb = hint_cb; A.cb_ctx = cb_ctx; A.check = check;

    switch (nlimbs) {
#define CASE(NN) case NN: { Field<NN> F; F.init(modulus, r2, one_mont); \
                            return solve_loop<NN>(F, A); }
        CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(8) CASE(10) CASE(12)
#undef CASE
        default: return -4;
    }
}

// PLONK sparse system walk; same return codes as gnark_solve_r1cs,
// plus -6 = gate quadratic in its unknown wire
int64_t gnark_solve_scs(
    int nlimbs,
    const u64* modulus, const u64* r2, const u64* one_mont,
    int64_t m, int64_t nwires, int64_t ncoeff,
    const int64_t* wl, const int64_t* wr, const int64_t* wo,
    const int64_t* ql, const int64_t* qr, const int64_t* qm,
    const int64_t* qo, const int64_t* qc,
    const u64* coeffs_mont, const u64* coeffs_reg,
    const u64* coeffs_neg_inv,
    u64* values, uint8_t* solved, const int64_t* wire_to_hint,
    u64* lv, u64* rv, u64* ov,
    hint_cb_t hint_cb, void* cb_ctx, int check) {
    ScsArgs A;
    A.m = m; A.nwires = nwires; A.ncoeff = ncoeff;
    A.wl = wl; A.wr = wr; A.wo = wo;
    A.ql = ql; A.qr = qr; A.qm = qm; A.qo = qo; A.qc = qc;
    A.coeffs_mont = coeffs_mont; A.coeffs_reg = coeffs_reg;
    A.coeffs_neg_inv = coeffs_neg_inv;
    A.values = values; A.solved = solved; A.wire_to_hint = wire_to_hint;
    A.lv = lv; A.rv = rv; A.ov = ov;
    A.hint_cb = hint_cb; A.cb_ctx = cb_ctx; A.check = check;
    switch (nlimbs) {
#define CASE(NN) case NN: { Field<NN> F; F.init(modulus, r2, one_mont); \
                            return solve_scs_loop<NN>(F, A); }
        CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(8) CASE(10) CASE(12)
#undef CASE
        default: return -4;
    }
}

#define DISPATCH(body) \
    switch (nlimbs) { \
        case 1: { Field<1> F; F.init(modulus, r2, one_mont); body; break; } \
        case 2: { Field<2> F; F.init(modulus, r2, one_mont); body; break; } \
        case 3: { Field<3> F; F.init(modulus, r2, one_mont); body; break; } \
        case 4: { Field<4> F; F.init(modulus, r2, one_mont); body; break; } \
        case 5: { Field<5> F; F.init(modulus, r2, one_mont); body; break; } \
        case 6: { Field<6> F; F.init(modulus, r2, one_mont); body; break; } \
        case 8: { Field<8> F; F.init(modulus, r2, one_mont); body; break; } \
        case 10: { Field<10> F; F.init(modulus, r2, one_mont); body; break; } \
        case 12: { Field<12> F; F.init(modulus, r2, one_mont); body; break; } \
        default: return -4; \
    } \
    return 0;

// out[w] += sum_c coeff_mont[cid] * lag[c] over one CSR matrix — the QAP
// per-wire accumulation of groth16 setup (setup.go:278 evaluation of
// A_i/B_i/C_i at tau via Lagrange values)
int64_t gnark_qap_accumulate(
    int nlimbs, const u64* modulus, const u64* r2, const u64* one_mont,
    int64_t m, const int64_t* indptr, const int64_t* wires,
    const int64_t* cids, const u64* coeffs_mont, const u64* lag,
    u64* out) {
    DISPATCH(qap_accumulate(F, m, indptr, wires, cids, coeffs_mont, lag, out))
}

// out[i] = (ka*A[i] + kb*B[i] + C[i]) * s — the beta*A + alpha*B + C
// key combination of setup.go:300 (ka/kb/s supplied in Montgomery form)
int64_t gnark_lincomb3(
    int nlimbs, const u64* modulus, const u64* r2, const u64* one_mont,
    int64_t n, const u64* A, const u64* B, const u64* C,
    const u64* ka_m, const u64* kb_m, const u64* s_m, u64* out) {
    DISPATCH(lincomb3(F, n, A, B, C, ka_m, kb_m, s_m, out))
}

// out[i] = start * base^i (base in Montgomery form, start/out regular)
int64_t gnark_powers(
    int nlimbs, const u64* modulus, const u64* r2, const u64* one_mont,
    int64_t n, const u64* base_m, const u64* start, u64* out) {
    DISPATCH(powers(F, n, base_m, start, out))
}

// out[i] = a[i] * b[i*stride_b] (regular form; stride_b 0 = broadcast)
int64_t gnark_vecmul(
    int nlimbs, const u64* modulus, const u64* r2, const u64* one_mont,
    int64_t n, const u64* a, const u64* b, int64_t stride_b, u64* out) {
    DISPATCH(vecmul(F, n, a, b, stride_b, out))
}

// out[i] = a[i] + b[i*stride_b] mod p
int64_t gnark_vecadd(
    int nlimbs, const u64* modulus, const u64* r2, const u64* one_mont,
    int64_t n, const u64* a, const u64* b, int64_t stride_b, u64* out) {
    DISPATCH(vecadd(F, n, a, b, stride_b, out))
}

// out[i] = prod_{j<=i} vals[j] (exclusive=1: j<i)
int64_t gnark_prefix_mul(
    int nlimbs, const u64* modulus, const u64* r2, const u64* one_mont,
    int64_t n, const u64* vals, u64* out, int exclusive) {
    DISPATCH(prefix_mul(F, n, vals, out, exclusive))
}

// p(X)/(X-z): quotient coefficients [n-1] + value p(z)
int64_t gnark_synth_div(
    int nlimbs, const u64* modulus, const u64* r2, const u64* one_mont,
    int64_t n, const u64* coeffs, const u64* z, u64* quotient, u64* value) {
    DISPATCH(synth_div(F, n, coeffs, z, quotient, value))
}

// out[i] = vals[i]^{-1} (regular form, zeros -> zeros)
int64_t gnark_batch_inv(
    int nlimbs, const u64* modulus, const u64* r2, const u64* one_mont,
    int64_t n, const u64* vals, u64* out) {
    DISPATCH(batch_inv(F, n, vals, out))
}

#undef DISPATCH

}  // extern "C"
