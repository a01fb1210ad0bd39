"""EdDSA over the per-snark-curve twisted Edwards curves.

Circuit verify mirrors std/signature/eddsa/eddsa.go:56-101:
  hRAM = MiMC(R.x, R.y, A.x, A.y, msg)
  Q = [S]B - [hRAM]A - R ;  [cofactor]Q must be the identity.
Host signer is the gnark-crypto eddsa analog used to build witnesses
(examples/rollup/operator.go usage pattern).
"""

from __future__ import annotations

import dataclasses
import hashlib

from gnark_tpu_torch.std.mimc import MiMC, MiMCHost
from gnark_tpu_torch.std.twisted_edwards import EdCurve, host_curve


@dataclasses.dataclass
class Signature:
    r: tuple      # R point (x, y)
    s: int


@dataclasses.dataclass
class KeyPair:
    curve_name: str
    secret: int
    public: tuple  # A = secret * Base

    @classmethod
    def generate(cls, snark_curve, seed: bytes):
        ed = host_curve(snark_curve.name)
        h = hashlib.sha512(seed).digest()
        s = int.from_bytes(h[:32], "little") % ed.params.order
        s = s or 1
        return cls(curve_name=snark_curve.name, secret=s,
                   public=ed.scalar_mul(ed.params.base, s))

    def sign(self, msg: int, snark_curve) -> Signature:
        """Deterministic nonce r = SHA512(secret || msg) mod order."""
        ed = host_curve(self.curve_name)
        order = ed.params.order
        nonce_src = hashlib.sha512(
            self.secret.to_bytes(32, "big") + (msg % snark_curve.fr.modulus)
            .to_bytes(32, "big")).digest()
        r = int.from_bytes(nonce_src, "little") % order or 1
        R = ed.scalar_mul(ed.params.base, r)
        hram = _hram_host(snark_curve, R, self.public, msg)
        s = (r + hram * self.secret) % order
        return Signature(r=R, s=s)


def _hram_host(snark_curve, R, A, msg) -> int:
    h = MiMCHost(snark_curve)
    h.write(R[0], R[1], A[0], A[1], msg)
    return h.sum()


def host_verify(sig: Signature, msg: int, public, snark_curve) -> bool:
    ed = host_curve(snark_curve.name)
    hram = _hram_host(snark_curve, sig.r, public, msg)
    lhs = ed.scalar_mul(ed.params.base, sig.s)
    rhs = ed.add(sig.r, ed.scalar_mul(public, hram))
    q = ed.add(lhs, ed.neg(rhs))
    for _ in range(ed.params.cofactor.bit_length() - 1):
        q = ed.double(q)
    return q == ed.identity


def verify(api, sig_r, sig_s, msg, pub_a):
    """In-circuit verification.  sig_r/pub_a: (x, y) variable pairs,
    sig_s/msg: variables."""
    curve = EdCurve(api)
    hasher = MiMC(api)
    hasher.write(sig_r[0], sig_r[1], pub_a[0], pub_a[1], msg)
    hram = hasher.sum()

    base = curve.params.base
    neg_a = curve.neg(pub_a)
    q = curve.double_base_scalar_mul(base, neg_a, sig_s, hram)
    curve.assert_is_on_curve(q)
    q = curve.add(curve.neg(q), sig_r)
    cof = curve.params.cofactor
    while cof > 1:
        q = curve.double(q)
        cof //= 2
    api.assert_is_equal(q[0], 0)
    api.assert_is_equal(q[1], 1)
