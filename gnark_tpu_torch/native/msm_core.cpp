// Host MSM core: windowed Pippenger over generic N x 64-bit Montgomery
// fields — the prover path for WIDE-field curves (BW6: 761/633-bit fp),
// where the 16-bit-limb vector representation pays an O(L^2)
// penalty that a 64-bit scalar CIOS does not.  (The narrow-field curves
// BN254/BLS12/BLS24 keep the device MSM — this file is the
// native-runtime fallback that makes one-layer recursion's outer prove
// practical on the host.)  Reference: gnark-crypto MultiExp
// (ecc/bw6-761/multiexp.go bucket method).
//
// Coordinates cross the boundary as [n][N] u64 little-endian REGULAR
// form; they are converted to Montgomery internally once.

#include <cstdint>
#include <cstring>
#include <vector>

// reuse the Field<N> arithmetic by inclusion (single-TU build keeps the
// ctypes surface in one shared object)
#include "field_common.h"

namespace {

template <class FF>
struct Jac {
    u64 X[FF::W], Y[FF::W], Z[FF::W];   // Z == 0 encodes infinity
};

template <class FF>
inline bool jac_is_inf(const Jac<FF>& P) {
    return FF::is_zero(P.Z);
}

template <class FF>
inline void jac_set_inf(const FF& F, Jac<FF>& P) {
    std::memset(&P, 0, sizeof(P));
    std::memcpy(P.Y, F.one, sizeof(P.Y));
}

// dbl-2009-l
template <class FF>
void jac_double(const FF& F, Jac<FF>& P) {
    constexpr int N = FF::W;
    if (jac_is_inf(P)) return;
    u64 A[N], B[N], C[N], D[N], E[N], G[N], t[N], t2[N];
    F.mmul(P.X, P.X, A);
    F.mmul(P.Y, P.Y, B);
    F.mmul(B, B, C);
    F.add(P.X, B, t);
    F.mmul(t, t, t);
    F.sub(t, A, t);
    F.sub(t, C, t);
    F.add(t, t, D);                  // D = 2((X+B)^2 - A - C)
    F.add(A, A, E);
    F.add(E, A, E);                  // E = 3A
    F.mmul(E, E, G);
    F.add(D, D, t2);
    F.sub(G, t2, t2);                // X3 = G - 2D
    u64 X3[N];
    std::memcpy(X3, t2, sizeof(X3));
    F.sub(D, X3, t);
    F.mmul(E, t, t);
    u64 c8[N];
    F.add(C, C, c8);
    F.add(c8, c8, c8);
    F.add(c8, c8, c8);               // 8C
    F.sub(t, c8, t);                 // Y3
    u64 Z3[N];
    F.mmul(P.Y, P.Z, Z3);
    F.add(Z3, Z3, Z3);
    std::memcpy(P.X, X3, sizeof(X3));
    std::memcpy(P.Y, t, sizeof(t));
    std::memcpy(P.Z, Z3, sizeof(Z3));
}

// madd-2007-bl: P += (x2, y2) affine (Montgomery form)
template <class FF>
void jac_add_mixed(const FF& F, Jac<FF>& P, const u64* x2,
                   const u64* y2) {
    constexpr int N = FF::W;
    if (jac_is_inf(P)) {
        std::memcpy(P.X, x2, sizeof(P.X));
        std::memcpy(P.Y, y2, sizeof(P.Y));
        std::memcpy(P.Z, F.one, sizeof(P.Z));
        return;
    }
    u64 Z1Z1[N], U2[N], S2[N], H[N], HH[N], I[N], J[N], r[N], V[N], t[N];
    F.mmul(P.Z, P.Z, Z1Z1);
    F.mmul(x2, Z1Z1, U2);
    F.mmul(y2, P.Z, S2);
    F.mmul(S2, Z1Z1, S2);
    F.sub(U2, P.X, H);
    F.sub(S2, P.Y, r);
    if (FF::is_zero(H)) {
        if (FF::is_zero(r)) {
            jac_double(F, P);
            return;
        }
        jac_set_inf(F, P);
        return;
    }
    F.add(r, r, r);                  // r = 2(S2 - Y1)
    F.mmul(H, H, HH);
    F.add(HH, HH, I);
    F.add(I, I, I);                  // I = 4 HH
    F.mmul(H, I, J);
    F.mmul(P.X, I, V);
    u64 X3[N], Y3[N], Z3[N];
    F.mmul(r, r, X3);
    F.sub(X3, J, X3);
    F.sub(X3, V, X3);
    F.sub(X3, V, X3);
    F.sub(V, X3, t);
    F.mmul(r, t, Y3);
    F.mmul(P.Y, J, t);
    F.add(t, t, t);
    F.sub(Y3, t, Y3);
    F.add(P.Z, H, Z3);
    F.mmul(Z3, Z3, Z3);
    F.sub(Z3, Z1Z1, Z3);
    F.sub(Z3, HH, Z3);
    std::memcpy(P.X, X3, sizeof(X3));
    std::memcpy(P.Y, Y3, sizeof(Y3));
    std::memcpy(P.Z, Z3, sizeof(Z3));
}

// full Jacobian add: P += Q
template <class FF>
void jac_add(const FF& F, Jac<FF>& P, const Jac<FF>& Q) {
    constexpr int N = FF::W;
    if (jac_is_inf(Q)) return;
    if (jac_is_inf(P)) { P = Q; return; }
    u64 Z1Z1[N], Z2Z2[N], U1[N], U2[N], S1[N], S2[N], H[N], I[N], J[N];
    u64 r[N], V[N], t[N];
    F.mmul(P.Z, P.Z, Z1Z1);
    F.mmul(Q.Z, Q.Z, Z2Z2);
    F.mmul(P.X, Z2Z2, U1);
    F.mmul(Q.X, Z1Z1, U2);
    F.mmul(P.Y, Q.Z, S1);
    F.mmul(S1, Z2Z2, S1);
    F.mmul(Q.Y, P.Z, S2);
    F.mmul(S2, Z1Z1, S2);
    F.sub(U2, U1, H);
    F.sub(S2, S1, r);
    if (FF::is_zero(H)) {
        if (FF::is_zero(r)) { jac_double(F, P); return; }
        jac_set_inf(F, P);
        return;
    }
    F.add(r, r, r);
    u64 HH[N];
    F.add(H, H, HH);
    F.mmul(HH, HH, I);
    F.mmul(H, I, J);
    F.mmul(U1, I, V);
    u64 X3[N], Y3[N], Z3[N];
    F.mmul(r, r, X3);
    F.sub(X3, J, X3);
    F.sub(X3, V, X3);
    F.sub(X3, V, X3);
    F.sub(V, X3, t);
    F.mmul(r, t, Y3);
    F.mmul(S1, J, t);
    F.add(t, t, t);
    F.sub(Y3, t, Y3);
    F.add(P.Z, Q.Z, Z3);
    F.mmul(Z3, Z3, Z3);
    F.sub(Z3, Z1Z1, Z3);
    F.sub(Z3, Z2Z2, Z3);
    F.mmul(Z3, H, Z3);
    std::memcpy(P.X, X3, sizeof(X3));
    std::memcpy(P.Y, Y3, sizeof(Y3));
    std::memcpy(P.Z, Z3, sizeof(Z3));
}

// Batch-affine bucket accumulation (the gnark-crypto MultiExp trick,
// restructured as a pairing tree): counting-sort points by window
// digit, then log2(max-bucket-size) rounds of INDEPENDENT affine adds
// within each bucket segment, every round sharing ONE batched modular
// inversion.  An affine add costs ~6 mmuls (incl. the 3-mmul batched
// inversion share) vs ~11 for the Jacobian mixed add.
template <class FF>
struct AffineTree {
    static constexpr int N = FF::W;
    std::vector<u64> wx, wy;       // per-window work coords [n][N]
    std::vector<uint8_t> valid;    // slot holds a point (not infinity)
    std::vector<int64_t> start, cnt, perm, hist;
    std::vector<u64> num, den, pref, dinv;
    std::vector<int64_t> slot;     // inversion-batch slot -> output index

    void init(int64_t n, int64_t nb) {
        wx.resize(n * N); wy.resize(n * N);
        valid.resize(n);
        start.resize(nb + 1); cnt.resize(nb); hist.resize(nb);
        perm.resize(n);
        num.resize(n * N); den.resize(n * N);
        pref.resize((n + 1) * N); dinv.resize(n * N);
        slot.resize(n);
    }
};

inline u64 window_digit(const u64* s, int nlimbs_fr, int bit0, int c) {
    int q = bit0 >> 6, sh = bit0 & 63;
    u64 d = s[q] >> sh;
    if (sh && q + 1 < nlimbs_fr) d |= s[q + 1] << (64 - sh);
    return d & ((u64(1) << c) - 1);
}

// one pairing round over all segments; returns true if another round
// is needed (some segment still has >1 element)
template <class FF>
bool affine_round(const FF& F, AffineTree<FF>& T, int64_t nb) {
    constexpr int N = FF::W;
    int64_t nsched = 0;       // entries in the inversion batch
    bool more = false;
    // schedule: for each segment pair (2j, 2j+1) -> slot j
    for (int64_t b = 0; b < nb; b++) {
        const int64_t k = T.cnt[b];
        if (k < 2) continue;
        const int64_t s0 = T.start[b];
        const int64_t pairs = k / 2;
        for (int64_t j = 0; j < pairs; j++) {
            const int64_t ia = s0 + 2 * j, ib = ia + 1, io = s0 + j;
            u64* xa = T.wx.data() + ia * N; u64* ya = T.wy.data() + ia * N;
            u64* xb = T.wx.data() + ib * N; u64* yb = T.wy.data() + ib * N;
            const bool va = T.valid[ia], vb = T.valid[ib];
            if (!va || !vb) {           // copy the surviving operand
                if (vb && !va) {
                    std::memcpy(xa, xb, sizeof(u64) * N);
                    std::memcpy(ya, yb, sizeof(u64) * N);
                }
                T.valid[io] = va || vb;
                if (io != ia) {
                    std::memcpy(T.wx.data() + io * N, xa, sizeof(u64) * N);
                    std::memcpy(T.wy.data() + io * N, ya, sizeof(u64) * N);
                }
                continue;
            }
            u64 t[N];
            if (std::memcmp(xa, xb, sizeof(u64) * N) == 0) {
                F.add(ya, yb, t);
                if (FF::is_zero(t)) {     // P + (-P): cancels
                    T.valid[io] = 0;
                    continue;
                }
                // doubling: num = 3 x^2, den = 2 y
                u64* nu = T.num.data() + nsched * N;
                u64* de = T.den.data() + nsched * N;
                F.mmul(xa, xa, t);
                F.add(t, t, nu); F.add(nu, t, nu);
                F.add(ya, ya, de);
            } else {
                // chord: num = yb - ya, den = xb - xa
                F.sub(T.wy.data() + ib * N, ya, T.num.data() + nsched * N);
                F.sub(xb, xa, T.den.data() + nsched * N);
            }
            // stage operands at the OUTPUT slot (safe: io <= ia)
            if (io != ia) {
                std::memcpy(T.wx.data() + io * N, xa, sizeof(u64) * N);
                std::memcpy(T.wy.data() + io * N, ya, sizeof(u64) * N);
            }
            // stash the second operand's x at the pair slot for x3
            T.slot[nsched] = (io << 1) | 0;
            // keep xb accessible: move it alongside (reuse num/den
            // staging: store xb into pref scratch region)
            std::memcpy(T.pref.data() + nsched * N, xb, sizeof(u64) * N);
            T.valid[io] = 1;
            nsched++;
        }
        if (k & 1) {                    // odd leftover moves up
            const int64_t ia = s0 + k - 1, io = s0 + pairs;
            if (io != ia) {
                std::memcpy(T.wx.data() + io * N,
                            T.wx.data() + ia * N, sizeof(u64) * N);
                std::memcpy(T.wy.data() + io * N,
                            T.wy.data() + ia * N, sizeof(u64) * N);
                T.valid[io] = T.valid[ia];
            }
        }
        T.cnt[b] = pairs + (k & 1);
        if (T.cnt[b] > 1) more = true;
    }
    if (nsched == 0) return more;
    // batched inversion of the denominators (Montgomery domain):
    // dinv[i] = prod_{j!=i} den[j] * (prod den)^-1
    u64* pp = T.dinv.data();            // reuse dinv as the prefix array
    // forward prefix products into dinv[(i)*N] shifted by one
    u64 run[N];
    std::memcpy(run, F.one, sizeof(run));
    for (int64_t i = 0; i < nsched; i++) {
        std::memcpy(pp + i * N, run, sizeof(run));
        F.mmul(run, T.den.data() + i * N, run);
    }
    u64 treg[N], tinv[N], rinv[N];
    F.from_mont(run, treg);
    F.invmod(treg, tinv);
    F.to_mont(tinv, rinv);
    for (int64_t i = nsched - 1; i >= 0; i--) {
        u64 di[N];
        F.mmul(rinv, pp + i * N, di);                   // 1/den[i]
        F.mmul(rinv, T.den.data() + i * N, rinv);
        // lambda = num * 1/den; x3 = l^2 - xa - xb; y3 = l(xa - x3) - ya
        const int64_t io = T.slot[i] >> 1;
        u64* xa = T.wx.data() + io * N;
        u64* ya = T.wy.data() + io * N;
        const u64* xb = T.pref.data() + i * N;
        u64 lam[N], x3[N], y3[N];
        F.mmul(T.num.data() + i * N, di, lam);
        F.mmul(lam, lam, x3);
        F.sub(x3, xa, x3);
        F.sub(x3, xb, x3);
        F.sub(xa, x3, y3);
        F.mmul(lam, y3, y3);
        F.sub(y3, ya, y3);
        std::memcpy(xa, x3, sizeof(x3));
        std::memcpy(ya, y3, sizeof(y3));
    }
    return more;
}

template <class FF>
int64_t msm_run(const FF& F, int64_t n,
                const u64* xs, const u64* ys, const uint8_t* inf,
                int nlimbs_fr, const u64* scalars, int c,
                int coords_mont, u64* out_xyz) {
    constexpr int N = FF::W;
    const int total_bits = nlimbs_fr * 64;
    const int nwin = (total_bits + c - 1) / c;
    const int64_t nb = (int64_t(1) << c) - 1;

    // convert affine inputs to Montgomery once (unless already there)
    std::vector<u64> mx(n * N), my(n * N);
    if (coords_mont) {
        std::memcpy(mx.data(), xs, n * N * sizeof(u64));
        std::memcpy(my.data(), ys, n * N * sizeof(u64));
    } else {
        for (int64_t i = 0; i < n; i++) {
            F.to_mont(xs + i * N, mx.data() + i * N);
            F.to_mont(ys + i * N, my.data() + i * N);
        }
    }

    AffineTree<FF> T;
    T.init(n, nb);
    Jac<FF> acc;
    jac_set_inf(F, acc);

    for (int w = nwin - 1; w >= 0; w--) {
        if (w != nwin - 1)
            for (int k = 0; k < c; k++) jac_double(F, acc);
        const int bit0 = w * c;
        // counting sort by digit: histogram, offsets, permute coords
        std::fill(T.hist.begin(), T.hist.end(), 0);
        for (int64_t i = 0; i < n; i++) {
            if (inf[i]) continue;
            const u64 d = window_digit(
                scalars + i * nlimbs_fr, nlimbs_fr, bit0, c);
            if (d) T.hist[d - 1]++;
        }
        int64_t off = 0;
        for (int64_t b = 0; b < nb; b++) {
            T.start[b] = off;
            T.cnt[b] = T.hist[b];
            off += T.hist[b];
            T.hist[b] = T.start[b];     // running fill cursor
        }
        T.start[nb] = off;
        for (int64_t i = 0; i < n; i++) {
            if (inf[i]) continue;
            const u64 d = window_digit(
                scalars + i * nlimbs_fr, nlimbs_fr, bit0, c);
            if (!d) continue;
            const int64_t pos = T.hist[d - 1]++;
            std::memcpy(T.wx.data() + pos * N, mx.data() + i * N,
                        sizeof(u64) * N);
            std::memcpy(T.wy.data() + pos * N, my.data() + i * N,
                        sizeof(u64) * N);
            T.valid[pos] = 1;
        }
        // pairing-tree rounds until every segment holds <= 1 element
        while (affine_round(F, T, nb)) {}

        // weighted reduction: running suffix + sum of suffixes
        // (buckets are affine now -> mixed adds)
        Jac<FF> run, sum;
        jac_set_inf(F, run);
        jac_set_inf(F, sum);
        for (int64_t b = nb - 1; b >= 0; b--) {
            if (T.cnt[b] > 0 && T.valid[T.start[b]])
                jac_add_mixed(F, run, T.wx.data() + T.start[b] * N,
                              T.wy.data() + T.start[b] * N);
            jac_add(F, sum, run);
        }
        jac_add(F, acc, sum);
    }
    // output (Montgomery Jacobian -> regular form coordinates)
    F.from_mont(acc.X, out_xyz);
    F.from_mont(acc.Y, out_xyz + N);
    F.from_mont(acc.Z, out_xyz + 2 * N);
    return 0;
}

// Montgomery-domain batch inversion of Jacobian Z coords; zeros skip.
template <class FF>
void batch_inv_mont_z(const FF& F, std::vector<Jac<FF>>& pts,
                      std::vector<u64>& zinv) {
    constexpr int N = FF::W;
    const int64_t n = pts.size();
    std::vector<u64> prefix((n + 1) * N);
    std::memcpy(prefix.data(), F.one, sizeof(u64) * N);
    for (int64_t i = 0; i < n; i++) {
        const u64* z = pts[i].Z;
        if (FF::is_zero(z))
            std::memcpy(prefix.data() + (i + 1) * N, prefix.data() + i * N,
                        sizeof(u64) * N);
        else
            F.mmul(prefix.data() + i * N, z, prefix.data() + (i + 1) * N);
    }
    u64 treg[N], tinv[N], run[N];
    F.from_mont(prefix.data() + n * N, treg);
    F.invmod(treg, tinv);
    F.to_mont(tinv, run);
    for (int64_t i = n - 1; i >= 0; i--) {
        const u64* z = pts[i].Z;
        if (FF::is_zero(z)) {
            std::memset(zinv.data() + i * N, 0, sizeof(u64) * N);
        } else {
            F.mmul(run, prefix.data() + i * N, zinv.data() + i * N);
            F.mmul(run, z, run);
        }
    }
}

template <class FF>
int64_t fixed_base_run(const FF& F, int64_t n, int nlimbs_fr,
                       const u64* scalars, const u64* bx, const u64* by,
                       int c, u64* out_x, u64* out_y, uint8_t* out_inf) {
    constexpr int N = FF::W;
    const int total_bits = nlimbs_fr * 64;
    const int nwin = (total_bits + c - 1) / c;
    const int64_t row = (int64_t(1) << c) - 1;

    // window tables: table[w][d-1] = d * 2^(cw) * B, affine Montgomery
    Jac<FF> step;
    std::memcpy(step.X, bx, sizeof(step.X));
    std::memcpy(step.Y, by, sizeof(step.Y));
    std::memcpy(step.Z, F.one, sizeof(step.Z));
    F.to_mont(bx, step.X);
    F.to_mont(by, step.Y);
    std::vector<Jac<FF>> table(nwin * row);
    for (int w = 0; w < nwin; w++) {
        Jac<FF> acc = step;
        for (int64_t d = 0; d < row; d++) {
            table[w * row + d] = acc;
            jac_add(F, acc, step);
        }
        for (int k = 0; k < c; k++) jac_double(F, step);
    }
    // normalize table to affine for mixed adds
    std::vector<u64> zinv(table.size() * N);
    batch_inv_mont_z(F, table, zinv);
    std::vector<u64> tx(table.size() * N), ty(table.size() * N);
    for (size_t i = 0; i < table.size(); i++) {
        u64 z2[N], z3[N];
        F.mmul(zinv.data() + i * N, zinv.data() + i * N, z2);
        F.mmul(z2, zinv.data() + i * N, z3);
        F.mmul(table[i].X, z2, tx.data() + i * N);
        F.mmul(table[i].Y, z3, ty.data() + i * N);
    }

    std::vector<Jac<FF>> res(n);
    for (int64_t i = 0; i < n; i++) {
        Jac<FF> acc;
        jac_set_inf(F, acc);
        const u64* s = scalars + i * nlimbs_fr;
        for (int w = 0; w < nwin; w++) {
            const int bit0 = w * c;
            int q = bit0 >> 6, sh = bit0 & 63;
            u64 d = s[q] >> sh;
            if (sh && q + 1 < nlimbs_fr) d |= s[q + 1] << (64 - sh);
            d &= (u64(1) << c) - 1;
            if (d)
                jac_add_mixed(F, acc, tx.data() + (w * row + d - 1) * N,
                              ty.data() + (w * row + d - 1) * N);
        }
        res[i] = acc;
    }
    // batch-normalize results to affine MONTGOMERY coords
    std::vector<u64> rzinv(n * N);
    batch_inv_mont_z(F, res, rzinv);
    for (int64_t i = 0; i < n; i++) {
        if (jac_is_inf(res[i])) {
            out_inf[i] = 1;
            std::memset(out_x + i * N, 0, sizeof(u64) * N);
            std::memset(out_y + i * N, 0, sizeof(u64) * N);
            continue;
        }
        out_inf[i] = 0;
        u64 z2[N], z3[N];
        F.mmul(rzinv.data() + i * N, rzinv.data() + i * N, z2);
        F.mmul(z2, rzinv.data() + i * N, z3);
        F.mmul(res[i].X, z2, out_x + i * N);
        F.mmul(res[i].Y, z3, out_y + i * N);
    }
    return 0;
}

}  // namespace

extern "C" {

// out coords are affine MONTGOMERY form [n][W]; base given regular.  W = N
// for fp; with beta != 0 the points lie over fp2 = fp[u]/(u^2 - beta), W =
// 2N words an element (c0 then c1).
int64_t gnark_fixed_base(
    int nlimbs, int beta, const u64* modulus, const u64* r2,
    const u64* one_mont, int64_t n, int nlimbs_fr, const u64* scalars,
    const u64* base_x, const u64* base_y, int c,
    u64* out_x, u64* out_y, uint8_t* out_inf) {
#define RUN(FT, ...) { FT F; F.init(modulus, r2, one_mont __VA_ARGS__); \
        return fixed_base_run(F, n, nlimbs_fr, scalars, base_x, base_y, \
                              c, out_x, out_y, out_inf); }
#define CASE(NN) case NN: if (beta) RUN(Fp2Field<NN>, , beta) \
        else RUN(Field<NN>)
    switch (nlimbs) {
        CASE(4) CASE(5) CASE(6) CASE(8) CASE(10) CASE(12)
        default: return -4;
    }
#undef CASE
#undef RUN
}

// returns 0; out_xyz = [3][W] u64 Jacobian coords, regular form (W as
// above)
int64_t gnark_msm(
    int nlimbs, int beta, const u64* modulus, const u64* r2,
    const u64* one_mont, int64_t n, const u64* xs, const u64* ys,
    const uint8_t* inf, int nlimbs_fr, const u64* scalars, int c,
    int coords_mont, u64* out_xyz) {
#define RUN(FT, ...) { FT F; F.init(modulus, r2, one_mont __VA_ARGS__); \
        return msm_run(F, n, xs, ys, inf, nlimbs_fr, scalars, c, \
                       coords_mont, out_xyz); }
#define CASE(NN) case NN: if (beta) RUN(Fp2Field<NN>, , beta) \
        else RUN(Field<NN>)
    switch (nlimbs) {
        CASE(4) CASE(5) CASE(6) CASE(8) CASE(10) CASE(12)
        default: return -4;
    }
#undef CASE
#undef RUN
}

}  // extern "C"
