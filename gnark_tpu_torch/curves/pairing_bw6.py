"""Host pairing for the BW6 family (embedding degree 6).

Verifier-side only (SURVEY §2.9: pairings run on host; the prover's hot
loops are MSM/NTT device kernels).  Reference counterpart: gnark-crypto
ecc/bw6-761/pairing.go (optimal ate).  This implementation uses the
TATE pairing — e(P, Q) = f_{r,P}(psi(Q))^((p^6-1)/r) — which needs no
Frobenius bookkeeping in the Miller loop and is unconditionally correct
for r-torsion inputs; the loop runs over the 377-bit r, all line
arithmetic in Fp (P and its multiples live on E(Fp)), evaluated at the
untwisted psi(Q) in Fp6 = Fp[w]/(w^6 - xi).

M-twist (b' = b*xi): psi(x', y') = (x'/w^2, y'/w^3) = (x'*w^4/xi,
y'*w^3/xi) since w^6 = xi.

GT inverse-by-conjugation: after the final exponentiation elements are
unitary, so g^{p^3} = g^{-1}; the p^3-Frobenius on Fp[w]/(w^6-xi) maps
w^i coefficients to gamma^i multiples with gamma = xi^((p^3-1)/6) in Fp.
"""

from __future__ import annotations

import functools


class Fp6Poly:
    """Fp[w]/(w^k - xi): elements are k-tuples of ints, index = w power.

    k = 6 for the BW6 family; k = 24 for BLS24 (fp24 = fp[w]/(w^24 - c)
    with the G2 coordinate field fp4 embedded as fp[w^6])."""

    def __init__(self, p: int, xi: int, k: int = 6):
        self.p = p
        self.k = k
        self.xi = xi % p
        # p^(k/2)-Frobenius constants: w^(p^(k/2)) = gamma * w; this
        # Frobenius inverts unitary (post-final-exp) elements
        self.gamma = pow(self.xi, (p ** (k // 2) - 1) // k, p)

    def one(self):
        return (1,) + (0,) * (self.k - 1)

    def from_int(self, v):
        return (v % self.p,) + (0,) * (self.k - 1)

    def add(self, a, b):
        p = self.p
        return tuple((x + y) % p for x, y in zip(a, b))

    def neg(self, a):
        p = self.p
        return tuple((-x) % p for x in a)

    def mul(self, a, b):
        p, xi, k = self.p, self.xi, self.k
        t = [0] * (2 * k - 1)
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    if bj:
                        t[i + j] += ai * bj
        out = list(t[:k])
        for m in range(k, 2 * k - 1):
            out[m - k] += t[m] * xi
        return tuple(v % p for v in out)

    def sqr(self, a):
        return self.mul(a, a)

    def conj(self, a):
        """p^(k/2)-Frobenius = inverse on unitary elements."""
        p, g = self.p, self.gamma
        out, gi = [], 1
        for i in range(self.k):
            out.append(a[i] * gi % p)
            gi = gi * g % p
        return tuple(out)

    def pow(self, a, e: int):
        result = self.one()
        base = a
        while e:
            if e & 1:
                result = self.mul(result, base)
            base = self.sqr(base)
            e >>= 1
        return result

    def inv(self, a):
        """Generic inverse via the norm to Fp: a^{-1} = adj / N(a) with
        adj = prod of conjugates; implemented as pow(a, s) * invN where
        s = (p^6-1)/(p-1) - 1 would be huge — instead use the extended
        Euclid on polynomials (small, host-only)."""
        p, xi, k = self.p, self.xi, self.k
        # polynomial xgcd of a(w) and w^k - xi over Fp
        A = list(a)
        B = [(-xi) % p] + [0] * (k - 1) + [1]
        # invariants: u*a = A (mod modpoly), v*a = B (mod modpoly)
        u = [1] + [0] * k
        v = [0] * (k + 1)
        A = A + [0]

        def deg(f):
            for i in range(len(f) - 1, -1, -1):
                if f[i] % p:
                    return i
            return -1

        while True:
            da, db = deg(A), deg(B)
            if da < 0:
                A, B, u, v = B, A, v, u
                da, db = deg(A), deg(B)
            if da == 0:
                break
            if da < db:
                A, B, u, v = B, A, v, u
                da, db = db, da
            lead = A[da] * pow(B[db], -1, p) % p
            shift = da - db
            for i in range(db + 1):
                A[i + shift] = (A[i + shift] - lead * B[i]) % p
            for i in range(k + 1 - shift):
                u[i + shift] = (u[i + shift] - lead * v[i]) % p
        c_inv = pow(A[0], -1, p)
        return tuple(x * c_inv % p for x in u[:k])

    def eq(self, a, b):
        return all((x - y) % self.p == 0 for x, y in zip(a, b))


class PairingBW6:
    """Tate pairing for a BW6-family CurveSpec (g2_over_fp, sextic_xi)."""

    def __init__(self, curve):
        self.curve = curve
        self.p = curve.fp.modulus
        self.r = curve.fr.modulus
        self.gt = Fp6Poly(self.p, curve.sextic_xi)
        # interface compat with curves/pairing.py (groth16.verify calls
        # pr.fp12.conj): the GT field object under the same attribute
        self.fp12 = self.gt
        p, xi = self.p, self.gt.xi
        self.xi_inv = pow(xi, -1, p)
        # twist type from b2: M (b*xi) or D (b/xi)
        b, b2 = curve.b, curve.b2
        if b2 == b * xi % p:
            self.twist_d = False
        elif b2 == b * self.xi_inv % p:
            self.twist_d = True
        else:
            raise ValueError("b2 is neither b*xi nor b/xi")

    def _untwist(self, Q):
        """E'(Fp) -> E(Fp6).  M-twist: (x*w^4/xi, y*w^3/xi);
        D-twist: (x*w^2, y*w^3)."""
        p = self.p
        x, y = Q
        xq = [0] * 6
        yq = [0] * 6
        if self.twist_d:
            xq[2] = x % p
            yq[3] = y % p
        else:
            xq[4] = x * self.xi_inv % p
            yq[3] = y * self.xi_inv % p
        return tuple(xq), tuple(yq)

    def miller_loop(self, pairs) -> tuple:
        """prod_i f_{r, P_i}(psi(Q_i)) — shared-loop multi-pair Miller.

        P_i in G1 (E(Fp)), Q_i in G2 (E'(Fp)); None entries are skipped
        (pairing with infinity contributes the identity).
        """
        gt, p, r = self.gt, self.p, self.r
        live = [(P, self._untwist(Q)) for P, Q in pairs
                if P is not None and Q is not None]
        f = gt.one()
        if not live:
            return f
        # working points in affine with batched inversions per step
        Ts = [P for P, _ in live]
        bits = bin(r)[3:]          # MSB already consumed by T = P
        for b in bits:
            f = gt.sqr(f)
            # doubling step for every pair: lambda = 3x^2 / 2y
            invs = self._batch_inv([2 * T[1] % p for T in Ts])
            new_Ts = []
            for k, (T, (Pb, QQ)) in enumerate(zip(Ts, live)):
                xT, yT = T
                lam = 3 * xT * xT % p * invs[k] % p
                x3 = (lam * lam - 2 * xT) % p
                y3 = (lam * (xT - x3) - yT) % p
                f = gt.mul(f, self._line_eval(lam, xT, yT, QQ))
                new_Ts.append((x3, y3))
            Ts = new_Ts
            if b == "1":
                invs = self._batch_inv(
                    [(T[0] - P[0]) % p for T, (P, _) in zip(Ts, live)])
                new_Ts = []
                for k, (T, (Pb, QQ)) in enumerate(zip(Ts, live)):
                    xT, yT = T
                    xP, yP = Pb
                    if (xT - xP) % p == 0:
                        # T == -P: the r-th (final) addition.  Its line
                        # is the vertical x - xP; evaluated at psi(Q) it
                        # lies in Fp3 (x-coord has only even w powers),
                        # which the final exponentiation kills — skip it.
                        # T becomes infinity; no further steps follow.
                        new_Ts.append((xT, yT))
                        continue
                    lam = (yT - yP) * invs[k] % p
                    x3 = (lam * lam - xT - xP) % p
                    y3 = (lam * (xT - x3) - yT) % p
                    f = gt.mul(f, self._line_eval(lam, xT, yT, QQ))
                    new_Ts.append((x3, y3))
                Ts = new_Ts
        # note: after the loop T = [r]P = infinity; the final vertical
        # line evaluates into a subfield and is killed by the final
        # exponentiation, so it is omitted (standard Tate optimization)
        return f

    def _line_eval(self, lam, xT, yT, QQ):
        """l(x, y) = (y - yT) - lam*(x - xT) at psi(Q): sparse in GT."""
        p = self.p
        xq, yq = QQ
        out = [0] * self.gt.k
        out[0] = (lam * xT - yT) % p
        for i, v in enumerate(yq):
            if v:
                out[i] = (out[i] + v) % p
        for i, v in enumerate(xq):
            if v:
                out[i] = (out[i] - lam * v) % p
        return tuple(out)

    def _batch_inv(self, vals):
        p = self.p
        n = len(vals)
        prefix = [1] * (n + 1)
        for i, v in enumerate(vals):
            prefix[i + 1] = prefix[i] * (v if v % p else 1) % p
        inv = pow(prefix[n], -1, p)
        out = [0] * n
        for i in range(n - 1, -1, -1):
            v = vals[i] % p
            if v:
                out[i] = prefix[i] * inv % p
                inv = inv * v % p
        return out

    @functools.cached_property
    def _final_e(self):
        return (self.p ** self.gt.k - 1) // self.r

    def final_exp(self, f) -> tuple:
        return self.gt.pow(f, self._final_e)

    def pair(self, P, Q) -> tuple:
        return self.final_exp(self.miller_loop([(P, Q)]))

    def pairing_check(self, pairs) -> bool:
        """prod e(P_i, Q_i) == 1."""
        return self.gt.eq(self.final_exp(self.miller_loop(pairs)),
                          self.gt.one())


class PairingBLS24(PairingBW6):
    """Tate pairing for BLS24 curves (embedding degree 24; G2 on a
    sextic D-twist over fp4 = fp[u]/(u^4 - c), u = w^6 in
    fp24 = fp[w]/(w^24 - c)).  Reference: gnark-crypto
    ecc/bls24-315/pairing.go (optimal ate; Tate chosen here for the
    same reasons as the BW6 backend — see module docstring)."""

    def __init__(self, curve):
        self.curve = curve
        self.p = curve.fp.modulus
        self.r = curve.fr.modulus
        self.gt = Fp6Poly(self.p, curve.g2_tower_c, k=24)
        self.fp12 = self.gt   # interface-compat alias (see PairingBW6)

    def _untwist(self, Q):
        """E'(Fp4) -> E(Fp24), D-twist: (x, y) -> (x*w^2, y*w^3);
        fp4 coefficient i of u = w^6 lands at w^(6i+2) / w^(6i+3)."""
        p = self.p
        x, y = Q
        xq = [0] * 24
        yq = [0] * 24
        for i in range(4):
            xq[6 * i + 2] = x[i] % p
            yq[6 * i + 3] = y[i] % p
        return tuple(xq), tuple(yq)


def naf_digits(n: int):
    """Non-adjacent form of n > 0, LSB first: list of digits in {-1,0,1}."""
    out = []
    while n:
        if n & 1:
            d = 2 - (n % 4)
            out.append(d)
            n -= d
        else:
            out.append(0)
        n //= 2
    return out


class PairingBLS24Ate(PairingBLS24):
    """Optimal-ate pairing for BLS24 curves: f_{x,Q}(P)^((p^24-1)/r)
    with the short Miller loop over the curve seed x (|x| is 32 bits,
    NAF weight 5 for BLS24-315) and the x-chain final exponentiation

        3 (p^8 - p^4 + 1)/r = (x-1)^2 (x+p) (x^2+p^2) (x^4+p^4-1) + 3

    (verified as an integer identity in tests).  Reference:
    gnark-crypto ecc/bls24-315/pairing.go MillerLoop/FinalExponentiation
    — semantics target; this implementation works on untwisted affine
    E(Fp24) points so the in-circuit gadget (std/algebra/sw_bls24315)
    can mirror it operation-for-operation.
    """

    def __init__(self, curve):
        super().__init__(curve)
        self.x_param = curve.x_param
        assert self.x_param < 0, "BLS24-315 seed is negative"
        self._naf = naf_digits(-self.x_param)

    # -- Frobenius powers on the flat basis --------------------------------
    # (sum a_i w^i)^(p^e) = sum a_i * xi^((i p^e) // 24) * w^(i p^e mod 24)

    @functools.lru_cache(maxsize=None)
    def _frob_consts(self, e: int):
        p, xi, k = self.p, self.gt.xi, self.gt.k
        pe = p ** e
        out = []
        for i in range(k):
            out.append(((i * pe) % k, pow(xi, (i * pe) // k, p)))
        return out

    def frob(self, a, e: int = 1):
        p = self.p
        out = [0] * self.gt.k
        for i, (j, c) in enumerate(self._frob_consts(e)):
            out[j] = (out[j] + a[i] * c) % p
        return tuple(out)

    # -- Miller loop --------------------------------------------------------

    def _line_eval_ate(self, lam, T, PP):
        """l(x, y) = (y - yT) - lam*(x - xT) at the embedded G1 point P;
        all values in flat Fp24 (lam/T from the untwisted G2 ladder)."""
        gt = self.gt
        xT, yT = T
        xP, yP = PP
        return gt.add(gt.add(yP, gt.neg(yT)),
                      gt.neg(gt.mul(lam, gt.add(xP, gt.neg(xT)))))

    def miller_loop(self, pairs) -> tuple:
        """prod_i f_{|x|, Q_i}(P_i), conjugated (x < 0)."""
        gt = self.gt
        live = [(p_, q_) for p_, q_ in pairs
                if p_ is not None and q_ is not None]
        f = gt.one()
        if not live:
            return f
        work = []
        for P, Q in live:
            PP = (gt.from_int(P[0]), gt.from_int(P[1]))
            QQ = self._untwist(Q)
            work.append([QQ, QQ, PP])     # [T, Q, P]
        naf = self._naf
        for bit_pos in range(len(naf) - 2, -1, -1):
            f = gt.sqr(f)
            d = naf[bit_pos]
            for st in work:
                T, QQ, PP = st
                # tangent at T
                lam = gt.mul(gt.mul(gt.from_int(3), gt.sqr(T[0])),
                             gt.inv(gt.add(T[1], T[1])))
                x3 = gt.add(gt.sqr(lam), gt.neg(gt.add(T[0], T[0])))
                y3 = gt.add(gt.mul(lam, gt.add(T[0], gt.neg(x3))),
                            gt.neg(T[1]))
                f = gt.mul(f, self._line_eval_ate(lam, T, PP))
                T = (x3, y3)
                if d:
                    S = QQ if d > 0 else (QQ[0], gt.neg(QQ[1]))
                    lam = gt.mul(gt.add(S[1], gt.neg(T[1])),
                                 gt.inv(gt.add(S[0], gt.neg(T[0]))))
                    x3 = gt.add(gt.sqr(lam),
                                gt.neg(gt.add(T[0], S[0])))
                    y3 = gt.add(gt.mul(lam, gt.add(T[0], gt.neg(x3))),
                                gt.neg(T[1]))
                    f = gt.mul(f, self._line_eval_ate(lam, T, PP))
                    T = (x3, y3)
                st[0] = T
        # x < 0: f_{x} = conj(f_{|x|}) up to factors killed by final exp
        return gt.conj(f)

    # -- final exponentiation -----------------------------------------------

    def _powu(self, a):
        """a^x for the SIGNED seed x (a unitary/cyclotomic: inverse is
        conj)."""
        gt = self.gt
        naf = self._naf
        an = gt.conj(a)
        r = a if naf[-1] > 0 else an
        for bit_pos in range(len(naf) - 2, -1, -1):
            r = gt.sqr(r)
            d = naf[bit_pos]
            if d > 0:
                r = gt.mul(r, a)
            elif d < 0:
                r = gt.mul(r, an)
        # naf encodes |x|; x < 0
        return gt.conj(r)

    def final_exp(self, f) -> tuple:
        gt = self.gt
        # easy part: f^((p^12 - 1)(p^4 + 1))
        f = gt.mul(gt.conj(f), gt.inv(f))
        f = gt.mul(self.frob(f, 4), f)
        # hard part: f^((x-1)^2 (x+p) (x^2+p^2) (x^4+p^4-1) + 3)
        t = gt.mul(self._powu(f), gt.conj(f))                  # f^(x-1)
        t = gt.mul(self._powu(t), gt.conj(t))                  # ^(x-1)
        t = gt.mul(self._powu(t), self.frob(t, 1))             # ^(x+p)
        t = gt.mul(self._powu(self._powu(t)), self.frob(t, 2)) # ^(x^2+p^2)
        t4 = self._powu(self._powu(self._powu(self._powu(t))))
        t = gt.mul(gt.mul(t4, self.frob(t, 4)), gt.conj(t))    # ^(x^4+p^4-1)
        return gt.mul(t, gt.mul(gt.sqr(f), f))                 # * f^3
