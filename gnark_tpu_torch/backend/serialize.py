"""gnark-compatible binary serialization: points, proofs, keys
(counterpart of gnark_tpu/backend/serialize.py; the same bytes).

Reference formats (gnark's sources):
  * Groth16 VK follows the bellman-style layout
    [alpha]1 [beta]1 [beta]2 [gamma]2 [delta]1 [delta]2 u32(len K) [K]1...
    (internal/backend/bn254/groth16/marshal.go:93-96).
  * Proof = [Ar]1 [Krs]1 [Bs]2 compressed (marshal.go:27-38).
  * Witness = u32(count) | big-endian fr elements
    (backend/witness/witness.go:19-23) — implemented in backend/witness.py.
  * Cross-implementation vectors: backend/groth16/bellman_test.go:18 ships
    base64 BLS12-381 VKs/proofs that gnark verifies — our test target.

Point compression (gnark-crypto conventions):
  * BLS12-381: 48-byte fp, zcash-style flags in the 3 top bits of the
    first byte: bit7 = compressed, bit6 = infinity, bit5 = y is
    lexicographically largest.
  * BN254: 32-byte fp with 2-bit flags in the top bits:
    00 = uncompressed marker, 01 = compressed infinity,
    10 = compressed smallest-y, 11 = compressed largest-y.
"""

from __future__ import annotations

import struct


def _sqrt_fp(a: int, p: int) -> int | None:
    """Square root mod p (p % 4 == 3 fast path; Tonelli-Shanks otherwise)."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # Tonelli-Shanks
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b % p * b % p, r * b % p
    return r


def _sqrt_fp2(a: tuple, p: int, beta: int) -> tuple | None:
    """Square root in fp2 = fp[u]/(u^2 - beta) (generic norm method)."""
    a0, a1 = a[0] % p, a[1] % p
    if a1 == 0:
        r = _sqrt_fp(a0, p)
        if r is not None:
            return (r, 0)
        # a0 = beta * y^2
        r = _sqrt_fp(a0 * pow(beta % p, -1, p) % p, p)
        return None if r is None else (0, r)
    norm = (a0 * a0 - beta * a1 * a1) % p
    n = _sqrt_fp(norm, p)
    if n is None:
        return None
    inv2 = pow(2, -1, p)
    for sign in (n, (-n) % p):
        x0sq = (a0 + sign) * inv2 % p
        x0 = _sqrt_fp(x0sq, p)
        if x0 is None or x0 == 0:
            continue
        x1 = a1 * pow(2 * x0, -1, p) % p
        # (x0 + u*x1)^2 = (x0^2 + beta*x1^2) + u*(2*x0*x1)
        if (x0 * x0 + beta * x1 * x1) % p == a0 and (2 * x0 * x1) % p == a1:
            return (x0, x1)
    return None


def _fp2_lex_larger(y: tuple, p: int) -> bool:
    """Lexicographic order on (c1, c0) — gnark-crypto's fp2 ordering."""
    y0, y1 = y[0] % p, y[1] % p
    if y1 != 0:
        return y1 > p - y1 if (p - y1) != y1 else y0 > p - y0
    return y0 > p - y0


def _fpk_lex_larger(y: tuple, p: int, order_idx) -> bool:
    """Lexicographic order over tower coefficients, highest first (the
    gnark-crypto E4 LexicographicallyLargest analog): decide on the
    first nonzero coefficient.  Well-defined under y -> -y (same first
    nonzero position, flipped comparison)."""
    for i in order_idx:
        c = y[i] % p
        if c:
            return c > p - c
    return False


def _sqrt_fpk(F, a):
    """Square root in fp^k = fp[u]/(u^k - c) (HostFpK) via generic
    Tonelli-Shanks over the multiplicative group of order p^k - 1.
    Host-side only (deserialization); ~1 ms-scale at k = 4."""
    q = F.p ** F.k
    a = tuple(v % F.p for v in a)
    if a == F.zero:
        return F.zero

    def fpow(x, e):
        r, b = F.one, x
        while e:
            if e & 1:
                r = F.mul(r, b)
            b = F.sqr(b)
            e >>= 1
        return r

    if fpow(a, (q - 1) // 2) != F.one:
        return None
    m, s = q - 1, 0
    while m % 2 == 0:
        m //= 2
        s += 1
    z = None
    for c0 in range(2, 200):
        cand = (c0 % F.p, 1) + (0,) * (F.k - 2)
        if fpow(cand, (q - 1) // 2) != F.one:
            z = cand
            break
    assert z is not None, "no quadratic non-residue found"
    M, c, t, r = s, fpow(z, m), fpow(a, m), fpow(a, (m + 1) // 2)
    while t != F.one:
        i, tt = 0, t
        while tt != F.one:
            tt = F.sqr(tt)
            i += 1
        b = c
        for _ in range(M - i - 1):
            b = F.sqr(b)
        M, c = i, F.sqr(b)
        t, r = F.mul(t, F.sqr(b)), F.mul(r, b)
    return r


class PointCodec:
    """Compressed-point codec for one curve (G1 over fp, G2 over fp2)."""

    def __init__(self, curve):
        self.curve = curve
        self.p = curve.fp.modulus
        self.nbytes = (curve.fp.modulus.bit_length() + 7) // 8
        # zcash-style 3-bit flags need >= 3 spare top bits (BLS12-381:
        # 384-381); gnark 2-bit flags otherwise (BN254: 256-254 = 2)
        spare = 8 * self.nbytes - curve.fp.modulus.bit_length()
        self.zcash = spare >= 3
        # G2 coordinate field: fp2 (default), fp itself (BW6 family's
        # sextic twist over fp), or fp4 (BLS24's quartic tower)
        self.g2_fp = getattr(curve, "g2_over_fp", False)
        self.g2_k = 1 if self.g2_fp else getattr(curve, "g2_tower_k", 2)
        # fp4 coefficient wire order: gnark-crypto writes the E4 tower
        # B1.A1 | B1.A0 | B0.A1 | B0.A0; with u = v^2 that is quartic
        # v-basis indices (3, 1, 2, 0)
        self._fp4_order = (3, 1, 2, 0)

    # ---- G1 -----------------------------------------------------------------

    def g1_compressed_size(self):
        return self.nbytes

    def g1_to_bytes(self, P) -> bytes:
        p, n = self.p, self.nbytes
        if self.zcash:
            if P is None:
                return bytes([0b11000000] + [0] * (n - 1))
            x, y = P
            out = bytearray(x.to_bytes(n, "big"))
            out[0] |= 0b10000000
            if y > p - y:
                out[0] |= 0b00100000
            return bytes(out)
        if P is None:
            return bytes([0b01000000] + [0] * (n - 1))
        x, y = P
        out = bytearray(x.to_bytes(n, "big"))
        out[0] |= 0b11000000 if y > p - y else 0b10000000
        return bytes(out)

    def g1_from_bytes(self, data: bytes):
        p, n = self.p, self.nbytes
        buf = bytearray(data[:n])
        if self.zcash:
            flags = buf[0] >> 5
            buf[0] &= 0x1F
            if flags & 0b010:  # infinity
                return None
            largest = bool(flags & 0b001)
        else:
            flags = buf[0] >> 6
            buf[0] &= 0x3F
            if flags == 0b01:
                return None
            largest = flags == 0b11
        x = int.from_bytes(bytes(buf), "big")
        y2 = (pow(x, 3, p) + self.curve.b) % p
        y = _sqrt_fp(y2, p)
        if y is None:
            raise ValueError("invalid G1 compressed point: x not on curve")
        if (y > p - y) != largest:
            y = (p - y) % p
        P = (x, y)
        if not self.curve.host_g1.is_on_curve(P):
            raise ValueError("invalid G1 point")
        # prime-subgroup check on cofactor curves (gnark-crypto SetBytes
        # subgroup-checks at deserialization; BN G1 has cofactor 1)
        if getattr(self.curve, "family", "bls") != "bn":
            if self.curve.host_g1.scalar_mul(P, self.curve.fr.modulus) is not None:
                raise ValueError("G1 point not in the prime-order subgroup")
        return P

    # ---- G2 -----------------------------------------------------------------

    def g2_compressed_size(self):
        return self.g2_k * self.nbytes

    def _flags_byte(self, larger: bool) -> int:
        if self.zcash:
            return 0b10100000 if larger else 0b10000000
        return 0b11000000 if larger else 0b10000000

    def _parse_flags(self, buf):
        """Strip the flag bits from buf[0]; -> (is_infinity, largest)."""
        if self.zcash:
            flags = buf[0] >> 5
            buf[0] &= 0x1F
            return bool(flags & 0b010), bool(flags & 0b001)
        flags = buf[0] >> 6
        buf[0] &= 0x3F
        return flags == 0b01, flags == 0b11

    def _g2_subgroup_check(self, P):
        if not self.curve.host_g2.is_on_curve(P):
            raise ValueError("invalid G2 point")
        # G2 cofactor is nontrivial on every supported curve
        if self.curve.host_g2.scalar_mul(P, self.curve.fr.modulus) is not None:
            raise ValueError("G2 point not in the prime-order subgroup")
        return P

    def _g2_fp_to_bytes(self, P) -> bytes:
        """BW6 family: G2 lives over fp itself — G1-shaped encoding with
        the twist's curve equation."""
        p, n = self.p, self.nbytes
        if P is None:
            flag = 0b11000000 if self.zcash else 0b01000000
            return bytes([flag] + [0] * (n - 1))
        x, y = P
        out = bytearray(x.to_bytes(n, "big"))
        out[0] |= self._flags_byte(y > p - y)
        return bytes(out)

    def _g2_fp_from_bytes(self, data: bytes):
        p, n = self.p, self.nbytes
        buf = bytearray(data[:n])
        inf, largest = self._parse_flags(buf)
        if inf:
            return None
        x = int.from_bytes(bytes(buf), "big")
        y2 = (pow(x, 3, p) + self.curve.b2) % p
        y = _sqrt_fp(y2, p)
        if y is None:
            raise ValueError("invalid G2 compressed point: x not on twist")
        if (y > p - y) != largest:
            y = (p - y) % p
        return self._g2_subgroup_check((x, y))

    def _g2_fp4_to_bytes(self, P) -> bytes:
        """BLS24: G2 over fp4 (quartic v-basis tuples)."""
        p, n = self.p, self.nbytes
        if P is None:
            flag = 0b11000000 if self.zcash else 0b01000000
            return bytes([flag] + [0] * (4 * n - 1))
        x, y = P
        out = bytearray(b"".join(
            (x[i] % p).to_bytes(n, "big") for i in self._fp4_order))
        out[0] |= self._flags_byte(_fpk_lex_larger(y, p, self._fp4_order))
        return bytes(out)

    def _g2_fp4_from_bytes(self, data: bytes):
        p, n = self.p, self.nbytes
        buf = bytearray(data[:4 * n])
        inf, largest = self._parse_flags(buf)
        if inf:
            return None
        coeffs = [0] * 4
        for slot, i in enumerate(self._fp4_order):
            coeffs[i] = int.from_bytes(bytes(buf[slot * n:(slot + 1) * n]),
                                       "big")
        x = tuple(coeffs)
        F4 = self.curve.host_g2.F
        y2 = F4.add(F4.mul(F4.sqr(x), x), self.curve.b2)
        y = _sqrt_fpk(F4, y2)
        if y is None:
            raise ValueError("invalid G2 compressed point: x not on twist")
        if _fpk_lex_larger(y, p, self._fp4_order) != largest:
            y = F4.neg(y)
        return self._g2_subgroup_check((x, y))

    def g2_to_bytes(self, P) -> bytes:
        if self.g2_fp:
            return self._g2_fp_to_bytes(P)
        if self.g2_k == 4:
            return self._g2_fp4_to_bytes(P)
        p, n = self.p, self.nbytes
        if P is None:
            flag = 0b11000000 if self.zcash else 0b01000000
            return bytes([flag] + [0] * (2 * n - 1))
        (x0, x1), y = P[0], P[1]
        # gnark-crypto serializes x.c1 || x.c0 big-endian
        out = bytearray(x1.to_bytes(n, "big") + x0.to_bytes(n, "big"))
        larger = _fp2_lex_larger(y, p)
        if self.zcash:
            out[0] |= 0b10000000
            if larger:
                out[0] |= 0b00100000
        else:
            out[0] |= 0b11000000 if larger else 0b10000000
        return bytes(out)

    def g2_from_bytes(self, data: bytes):
        if self.g2_fp:
            return self._g2_fp_from_bytes(data)
        if self.g2_k == 4:
            return self._g2_fp4_from_bytes(data)
        p, n = self.p, self.nbytes
        buf = bytearray(data[:2 * n])
        if self.zcash:
            flags = buf[0] >> 5
            buf[0] &= 0x1F
            if flags & 0b010:
                return None
            largest = bool(flags & 0b001)
        else:
            flags = buf[0] >> 6
            buf[0] &= 0x3F
            if flags == 0b01:
                return None
            largest = flags == 0b11
        x1 = int.from_bytes(bytes(buf[:n]), "big")
        x0 = int.from_bytes(bytes(buf[n:]), "big")
        x = (x0, x1)
        F2 = self.curve.host_g2.F
        y2 = F2.add(F2.mul(F2.sqr(x), x), self.curve.b2)
        y = _sqrt_fp2(y2, p, self.curve.fp2_beta % p)
        if y is None:
            raise ValueError("invalid G2 compressed point")
        if _fp2_lex_larger(y, p) != largest:
            y = F2.neg(y)
        P = (x, y)
        if not self.curve.host_g2.is_on_curve(P):
            raise ValueError("invalid G2 point")
        # G2 cofactor is nontrivial on every supported curve
        if self.curve.host_g2.scalar_mul(P, self.curve.fr.modulus) is not None:
            raise ValueError("G2 point not in the prime-order subgroup")
        return P


# ---- Groth16 containers ------------------------------------------------------


def proof_to_bytes(proof, curve) -> bytes:
    """Ar | Bs | Krs compressed (marshal.go writeTo encode order)."""
    c = PointCodec(curve)
    return (c.g1_to_bytes(proof.ar) + c.g2_to_bytes(proof.bs)
            + c.g1_to_bytes(proof.krs))


def proof_from_bytes(data: bytes, curve):
    from gnark_tpu_torch.backend.groth16 import Proof
    c = PointCodec(curve)
    n1, n2 = c.g1_compressed_size(), c.g2_compressed_size()
    ar = c.g1_from_bytes(data[:n1])
    bs = c.g2_from_bytes(data[n1:n1 + n2])
    krs = c.g1_from_bytes(data[n1 + n2:2 * n1 + n2])
    return Proof(ar=ar, bs=bs, krs=krs)


def vk_to_bytes(vk) -> bytes:
    """Bellman-format VK (marshal.go:93-96):
    [alpha]1 [beta]1 [beta]2 [gamma]2 [delta]1 [delta]2 u32(nK) [K...]1."""
    curve = vk.curve
    c = PointCodec(curve)
    beta1 = getattr(vk, "beta_g1", None)
    delta1 = getattr(vk, "delta_g1", None)
    if beta1 is None or delta1 is None:
        raise ValueError(
            "VK is missing beta_g1/delta_g1 (gnark's blob carries them); "
            "re-run setup or deserialize a full VK before serializing")
    out = [c.g1_to_bytes(vk.alpha_g1),
           c.g1_to_bytes(beta1),
           c.g2_to_bytes(vk.beta_g2),
           c.g2_to_bytes(vk.gamma_g2),
           c.g1_to_bytes(delta1),
           c.g2_to_bytes(vk.delta_g2),
           struct.pack(">I", len(vk.K))]
    out += [c.g1_to_bytes(k) for k in vk.K]
    return b"".join(out)


def plonk_proof_to_bytes(proof, curve) -> bytes:
    """PLONK proof: 7 G1 commitments | 6 evals | z(wz) | 2 opening proofs
    (native layout; the reference's plonk marshal.go is per-curve gnark
    format — PLONK cross-serialization parity is not a BASELINE target)."""
    c = PointCodec(curve)
    nb = (curve.fr.modulus.bit_length() + 7) // 8
    out = [c.g1_to_bytes(p) for p in
           (proof.c_l, proof.c_r, proof.c_o, proof.c_z,
            proof.c_h1, proof.c_h2, proof.c_h3)]
    for v in proof.evals + [proof.z_omega_zeta]:
        out.append(int(v).to_bytes(nb, "big"))
    out.append(c.g1_to_bytes(proof.w_zeta))
    out.append(c.g1_to_bytes(proof.w_zeta_omega))
    return b"".join(out)


def plonk_proof_from_bytes(data: bytes, curve):
    from gnark_tpu_torch.backend.plonk import PlonkProof
    c = PointCodec(curve)
    n1 = c.g1_compressed_size()
    nb = (curve.fr.modulus.bit_length() + 7) // 8
    off = 0

    def g1():
        nonlocal off
        P = c.g1_from_bytes(data[off:off + n1])
        off += n1
        return P

    def fr():
        nonlocal off
        v = int.from_bytes(data[off:off + nb], "big")
        off += nb
        return v

    pts = [g1() for _ in range(7)]
    evals = [fr() for _ in range(6)]
    zw = fr()
    w1, w2 = g1(), g1()
    return PlonkProof(c_l=pts[0], c_r=pts[1], c_o=pts[2], c_z=pts[3],
                      c_h1=pts[4], c_h2=pts[5], c_h3=pts[6],
                      evals=evals, w_zeta=w1, z_omega_zeta=zw,
                      w_zeta_omega=w2)


def vk_from_bytes(data: bytes, curve):
    from gnark_tpu_torch.backend.groth16 import VerifyingKey
    from gnark_tpu_torch.curves.pairing import pairing_for
    c = PointCodec(curve)
    n1, n2 = c.g1_compressed_size(), c.g2_compressed_size()
    off = 0

    def g1():
        nonlocal off
        P = c.g1_from_bytes(data[off:off + n1])
        off += n1
        return P

    def g2():
        nonlocal off
        P = c.g2_from_bytes(data[off:off + n2])
        off += n2
        return P

    alpha_g1 = g1()
    beta_g1 = g1()
    beta_g2 = g2()
    gamma_g2 = g2()
    delta_g1 = g1()
    delta_g2 = g2()
    (nk,) = struct.unpack_from(">I", data, off)
    off += 4
    K = [g1() for _ in range(nk)]
    vk = VerifyingKey(
        curve=curve, alpha_g1=alpha_g1, beta_g2=beta_g2, gamma_g2=gamma_g2,
        delta_g2=delta_g2, K=K,
        e_alpha_beta=pairing_for(curve).pair(alpha_g1, beta_g2),
        nb_public=nk)
    vk.beta_g1 = beta_g1
    vk.delta_g1 = delta_g1
    return vk
