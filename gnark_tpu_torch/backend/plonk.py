"""PLONK backend (KZG commitments): Setup / Prove / Verify on PyTorch
(counterpart of gnark_tpu/backend/plonk.py, BN254).

  * Setup — selector polys from gates + public-input placeholder rows,
    copy-constraint permutation, KZG commits into the VK.
  * Prove — the transcript-barriered pipeline of SURVEY §3.3: commit L,R,O
    -> gamma,beta -> Z -> alpha -> quotient on the 4n coset domain in
    bit-reversed layout -> zeta -> openings + linearization.
  * Verify — challenge re-derivation, quotient identity at zeta,
    linearized digest as an MSM over {Ql,Qr,Qm,Qo,Qc,S3,Z,H}, batch KZG
    verification.

Every bulk step runs on the key's device: the interpolations and the 4n
coset evaluations through ``ops.ntt.Domain``, the quotient's pointwise pass
through ``FieldOps`` on limb planes, and the seven commitment MSMs and two
opening MSMs through ``ops.msm.msm`` (the CUDA kernels on a card).  The
host syncs are the Fiat-Shamir barriers, which are inherent to the
protocol.  Sequential O(n) steps (Z running product, linearization combos,
openings) go through the native field core.  With the same ``rng`` the
keys and the proof equal gnark_tpu's: tau and the blinding scalars are
drawn in the same order and the transcript hashes the same bytes.

``host=True`` does the polynomial work on host ints instead (tiny
circuits, protocol tests).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnark_tpu_torch.backend import kzg
from gnark_tpu_torch.backend import scs_solver
from gnark_tpu_torch.backend.groth16 import (
    _Phases, _host_ntt, _sampler, key_planes)
from gnark_tpu_torch.backend.native_field import nat_for
from gnark_tpu_torch.backend.transcript import Transcript
from gnark_tpu_torch.curves import ALL_CURVES
from gnark_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints
from gnark_tpu_torch.ops.msm import _next_pow2
from gnark_tpu_torch.ops.ntt import Domain, bit_reverse_perm
from gnark_tpu_torch.utils.logging import logger

CHALLENGES = ("gamma", "beta", "alpha", "zeta", "eta", "u")


@dataclasses.dataclass
class PlonkVK:
    curve: object
    n: int
    ell: int                # nb public inputs
    k1: int
    k2: int
    generator: int          # omega
    c_ql: tuple; c_qr: tuple; c_qm: tuple; c_qo: tuple; c_qc: tuple
    c_s1: tuple; c_s2: tuple; c_s3: tuple
    g2_gen: tuple
    g2_tau: tuple
    g1_gen: tuple


@dataclasses.dataclass
class PlonkPK:
    curve: object
    srs: kzg.SRS
    vk: PlonkVK
    n: int
    ell: int
    k1: int
    k2: int
    # coefficient forms (host ints, length n)
    ql_c: list; qr_c: list; qm_c: list; qo_c: list; qc_c: list
    s1_c: list; s2_c: list; s3_c: list
    # sigma slot values (host ints, 3 lists of n) and omega powers
    sigma_vals: tuple
    omega_pows: list
    # 4n-coset evaluations: Montgomery limb planes [L, 4n] on one device in
    # bit-reversed order, or host int lists in natural order when host_mode
    sel_E: tuple            # (qlE, qrE, qmE, qoE, qcE)
    sig_E: tuple            # (s1E, s2E, s3E)
    x_E: object             # coset points
    zh_inv_E: object        # 1 / Z_H on the coset
    l1_E: object            # Lagrange L1 on the coset
    host_mode: bool = False

    @property
    def device(self):
        """Where the coset tables live (None for a host-mode key)."""
        return None if self.host_mode else self.x_E.device


@dataclasses.dataclass
class PlonkProof:
    c_l: tuple; c_r: tuple; c_o: tuple
    c_z: tuple
    c_h1: tuple; c_h2: tuple; c_h3: tuple
    # openings at zeta: [r_bar, l_bar, r_bar_, o_bar, s1_bar, s2_bar]
    evals: list
    w_zeta: tuple           # batched opening proof at zeta
    z_omega_zeta: int       # Z(omega * zeta)
    w_zeta_omega: tuple     # opening proof of Z at omega*zeta


# ---- poly helpers (device + host variants) --------------------------------------


class _HostVecF:
    """Pointwise mod-q ops on python int lists (host quotient path);
    scalars broadcast (ints mix with lists)."""

    def __init__(self, q):
        self.q = q

    def _bc(self, a, b):
        if isinstance(a, int) and isinstance(b, list):
            a = [a] * len(b)
        elif isinstance(b, int) and isinstance(a, list):
            b = [b] * len(a)
        return a, b

    def add(self, a, b):
        a, b = self._bc(a, b)
        return [(x + y) % self.q for x, y in zip(a, b)]

    def sub(self, a, b):
        a, b = self._bc(a, b)
        return [(x - y) % self.q for x, y in zip(a, b)]

    def mul(self, a, b):
        a, b = self._bc(a, b)
        return [x * y % self.q for x, y in zip(a, b)]

    def ones_like(self, a):
        return [1] * len(a)


def _big_domain_size(n: int) -> int:
    """Quotient-evaluation domain: deg t = 3n+5 with blinding, so 4n
    suffices only for n >= 8; tiny circuits take 8n (the reference's
    n < 6 exception, internal/backend/bn254/plonk/setup.go:105-110)."""
    return 4 * n if n >= 8 else 8 * n


class _HostPoly:
    """Host-int polynomial helper with the same interface as _Poly
    (natural-order coset layout; order only has to be self-consistent)."""

    _cache = {}

    def __new__(cls, spec, n):
        key = (spec.name, n)
        if key not in cls._cache:
            self = super().__new__(cls)
            self.spec = spec
            self.n = n
            self.big = _big_domain_size(n)
            self.q = spec.modulus
            self.omega = spec.root_of_unity(n)
            self.omega4 = spec.root_of_unity(self.big)
            self.coset = spec.multiplicative_generator % self.q
            self.F = _HostVecF(self.q)
            cls._cache[key] = self
        return cls._cache[key]

    def const(self, v):
        return v % self.q

    def layout(self, vals):
        return list(vals)               # natural order, int lists

    def interpolate(self, evals):
        q = self.q
        vals = [v % q for v in evals] + [0] * (self.n - len(evals))
        return _host_ntt(vals, self.omega, q, inverse=True)

    def eval_coset4(self, coeffs):
        q = self.q
        c = [v % q for v in coeffs] + [0] * (self.big - len(coeffs))
        shifted = [v * pow(self.coset, i, q) % q for i, v in enumerate(c)]
        return _host_ntt(shifted, self.omega4, q)

    def interp_coset4(self, evals):
        q = self.q
        coeffs = _host_ntt(list(evals), self.omega4, q, inverse=True)
        cinv = pow(self.coset, -1, q)
        return [v * pow(cinv, i, q) % q for i, v in enumerate(coeffs)]


class _Poly:
    """Device NTT helper bound to (curve.fr, n, device): interpolation on
    H and evaluation on the 4n coset in bit-reversed order."""

    _cache = {}

    def __new__(cls, spec, n, device):
        device = torch.device(device)
        key = (spec.name, n, str(device))
        if key not in cls._cache:
            self = super().__new__(cls)
            self.spec = spec
            self.n = n
            self.big = _big_domain_size(n)
            self.device = device
            self.domain = Domain(spec, n, device)
            self.domain4 = Domain(spec, self.big, device)
            self.F = self.domain.F
            self.Ls = spec.L
            self.brev = torch.from_numpy(
                bit_reverse_perm(n).astype(np.int64)).to(device)
            self.brev4 = bit_reverse_perm(self.big)
            cls._cache[key] = self
        return cls._cache[key]

    def pack(self, vals, length=None):
        length = length or self.n
        vals = list(vals) + [0] * (length - len(vals))
        arr = ints_to_limbs(vals, self.Ls, q=self.spec.modulus)
        return self.F.to_mont(
            torch.from_numpy(arr.astype(np.int64)).to(self.device))

    def unpack(self, planes):
        return limbs_to_ints(self.F.from_mont(planes).cpu().numpy())

    def const(self, v):
        """One field constant as [L, 1] planes, broadcast by FieldOps."""
        return self.pack([v], 1)

    def layout(self, vals):
        """Natural-order values on the big coset -> bit-reversed planes."""
        return self.pack([vals[i] for i in self.brev4], self.big)

    def interpolate(self, evals_ints) -> list:
        """values on H (natural order) -> coefficients (host ints)."""
        coeffs_brev = self.domain.ifft(self.pack(evals_ints), "DIF")
        return self.unpack(coeffs_brev[:, self.brev])

    def eval_coset4(self, coeffs_ints):
        """coefficients -> evaluations on the big coset, bit-reversed
        order (device planes, Montgomery)."""
        return self.domain4.fft(self.pack(coeffs_ints, self.big), "DIF",
                                coset=True)

    def interp_coset4(self, evals_brev):
        """bit-reversed 4n coset evals -> natural coefficients (host ints)."""
        return self.unpack(self.domain4.ifft(evals_brev, "DIT", coset=True))


# ---- setup -----------------------------------------------------------------------


def setup(cs, curve, srs: kzg.SRS | None = None, rng=None,
          host: bool = False, *, device="cuda"):
    """-> (PlonkPK, PlonkVK).  srs: a kzg.SRS of size >= n+3 (a test SRS
    is generated when omitted — plonk.Setup(ccs, kzgSRS) analog).  The
    key's tables live on ``device``: the card unless the caller names
    another (raises when there is none), the SRS's own when one is given.
    host=True: pure-host math (tiny circuits / protocol tests)."""
    q = cs.field_modulus
    ell = cs.nb_public
    m = cs.nb_constraints
    n = _next_pow2(ell + m)
    if srs is None:
        srs = kzg.new_srs(curve, n + 3, rng=rng, host=host, device=device)
    elif not host:
        if srs.device is None:
            raise ValueError("a host-only SRS serves host=True only")
        device = srs.device
    assert len(srs.g1) >= n + 3, "SRS too small for this circuit"

    coeffs = cs.coeffs
    neg_one = q - 1
    ql = [neg_one] * ell + [coeffs[c] for c in cs.q_l] + [0] * (n - ell - m)
    qr = [0] * ell + [coeffs[c] for c in cs.q_r] + [0] * (n - ell - m)
    qm = [0] * ell + [coeffs[c] for c in cs.q_m] + [0] * (n - ell - m)
    qo = [0] * ell + [coeffs[c] for c in cs.q_o] + [0] * (n - ell - m)
    qc = [0] * ell + [coeffs[c] for c in cs.q_c] + [0] * (n - ell - m)

    # slot wiring: 3 columns x n rows; wire id or -1
    wl = [-1] * n
    wr = [-1] * n
    wo = [-1] * n
    for i in range(ell):
        wl[i] = i
    for j in range(m):
        wl[ell + j] = int(cs.wires_l[j])
        wr[ell + j] = int(cs.wires_r[j])
        wo[ell + j] = int(cs.wires_o[j])

    # permutation: cycle the slots of each wire (setup.go:209-255)
    slots_of = {}
    cols = (wl, wr, wo)
    for col_idx, col in enumerate(cols):
        for row, w in enumerate(col):
            if w >= 0:
                slots_of.setdefault(w, []).append(col_idx * n + row)
    perm = list(range(3 * n))
    for slots in slots_of.values():
        for i, s in enumerate(slots):
            perm[s] = slots[(i + 1) % len(slots)]

    # sigma slot values: id(s) = k_col * omega^row
    P = _HostPoly(curve.fr, n) if host else _Poly(curve.fr, n, device)
    omega = curve.fr.root_of_unity(n)
    nat = nat_for(q)
    omega_pows = nat.unpack(nat.powers(omega, n))
    g = curve.fr.multiplicative_generator % q
    k1, k2 = g, g * g % q
    ks = (1, k1, k2)

    def slot_id(s):
        return ks[s // n] * omega_pows[s % n] % q

    sigma_vals = tuple([slot_id(perm[c * n + r]) for r in range(n)]
                       for c in range(3))

    # interpolate + commit everything
    ql_c, qr_c, qm_c, qo_c, qc_c = (P.interpolate(v)
                                    for v in (ql, qr, qm, qo, qc))
    s1_c, s2_c, s3_c = (P.interpolate(v) for v in sigma_vals)

    commits = [kzg.commit(srs, c, host=host)
               for c in (ql_c, qr_c, qm_c, qo_c, qc_c, s1_c, s2_c, s3_c)]

    vk = PlonkVK(
        curve=curve, n=n, ell=ell, k1=k1, k2=k2, generator=omega,
        c_ql=commits[0], c_qr=commits[1], c_qm=commits[2], c_qo=commits[3],
        c_qc=commits[4], c_s1=commits[5], c_s2=commits[6], c_s3=commits[7],
        g2_gen=srs.g2_gen, g2_tau=srs.g2_tau, g1_gen=curve.g1_gen)

    # big-coset precomputations.  big = 4n normally, 8n for n < 8: the
    # blinded quotient has degree 3n+5, which only fits the 4n domain
    # from n = 8 up (setup.go:105-110 makes the same n<6 exception)
    big = _big_domain_size(n)
    ratio = big // n
    coset = curve.fr.multiplicative_generator % q
    w4 = curve.fr.root_of_unity(big)
    # Z_H(x) = x^n - 1 on the coset: coset^n * w4^{ni} - 1
    # (w4^n has order big/n)
    w4n = pow(w4, n, q)
    cn = pow(coset, n, q)
    ninv = pow(n, -1, q)
    x64 = nat.powers(w4, big, start=coset)
    x_nat = nat.unpack(x64)
    zh_full = [(cn * pow(w4n, i % ratio, q) - 1) % q for i in range(big)]
    zh64 = nat.pack(zh_full)
    zh_inv = nat.unpack(nat.batch_inv(zh64))
    l1_den64 = nat.batch_inv(nat.vecadd(x64, q - 1))
    # L1(x) = (x^n - 1) / (n (x - 1))
    l1_full = nat.unpack(nat.vecmul(nat.vecmul(zh64, l1_den64), ninv))

    pk = PlonkPK(
        curve=curve, srs=srs, vk=vk, n=n, ell=ell, k1=k1, k2=k2,
        ql_c=ql_c, qr_c=qr_c, qm_c=qm_c, qo_c=qo_c, qc_c=qc_c,
        s1_c=s1_c, s2_c=s2_c, s3_c=s3_c,
        sigma_vals=sigma_vals, omega_pows=omega_pows,
        sel_E=tuple(P.eval_coset4(c)
                    for c in (ql_c, qr_c, qm_c, qo_c, qc_c)),
        sig_E=tuple(P.eval_coset4(c) for c in (s1_c, s2_c, s3_c)),
        x_E=P.layout(x_nat),
        zh_inv_E=P.layout(zh_inv),
        l1_E=P.layout(l1_full),
        host_mode=host)
    logger.info(f"plonk setup: {m} gates, {ell} public, domain {n}")
    return pk, vk


def plonk_key_from_jax(pk, device) -> PlonkPK:
    """A gnark_tpu PlonkPK -> this package's key on ``device``.

    Reads the dataclass fields only (no jax import).  A host-mode key's
    coset tables (int lists, natural order) are packed into bit-reversed
    planes; a device-mode key's are expected as numpy arrays already
    (Montgomery uint32 limb planes, bit-reversed order).  The curve
    becomes this package's own spec of the same name."""
    curve = ALL_CURVES[pk.curve.name]
    device = torch.device(device)
    P = _Poly(curve.fr, pk.n, device)
    if pk.host_mode:
        planes = P.layout
    else:
        def planes(v):
            return key_planes([v], device)[0]
    v = pk.vk
    vk = PlonkVK(
        curve=curve, n=v.n, ell=v.ell, k1=v.k1, k2=v.k2,
        generator=v.generator, c_ql=v.c_ql, c_qr=v.c_qr, c_qm=v.c_qm,
        c_qo=v.c_qo, c_qc=v.c_qc, c_s1=v.c_s1, c_s2=v.c_s2, c_s3=v.c_s3,
        g2_gen=v.g2_gen, g2_tau=v.g2_tau, g1_gen=v.g1_gen)
    srs = kzg.SRS(curve=curve, g1=list(pk.srs.g1), g2_gen=pk.srs.g2_gen,
                  g2_tau=pk.srs.g2_tau, device=device)
    return PlonkPK(
        curve=curve, srs=srs, vk=vk, n=pk.n, ell=pk.ell, k1=pk.k1, k2=pk.k2,
        ql_c=pk.ql_c, qr_c=pk.qr_c, qm_c=pk.qm_c, qo_c=pk.qo_c, qc_c=pk.qc_c,
        s1_c=pk.s1_c, s2_c=pk.s2_c, s3_c=pk.s3_c,
        sigma_vals=pk.sigma_vals, omega_pows=pk.omega_pows,
        sel_E=tuple(planes(e) for e in pk.sel_E),
        sig_E=tuple(planes(e) for e in pk.sig_E),
        x_E=planes(pk.x_E), zh_inv_E=planes(pk.zh_inv_E),
        l1_E=planes(pk.l1_E), host_mode=False)


# ---- prove -----------------------------------------------------------------------


def _point_bytes(p, nbytes: int = 48) -> bytes:
    """Uncompressed big-endian point encoding for transcript binding
    (deriveRandomness analog, verify.go:290-308)."""
    if p is None:
        return b"\x00" * (2 * nbytes)
    def enc(c):
        if isinstance(c, tuple):
            return b"".join(x.to_bytes(nbytes, "big") for x in c)
        return c.to_bytes(nbytes, "big")
    return enc(p[0]) + enc(p[1])


def _fp_bytes(curve) -> int:
    return (curve.fp.modulus.bit_length() + 7) // 8


def _fr_bytes(curve) -> int:
    return (curve.fr.modulus.bit_length() + 7) // 8


def _bind_public_data(fs: Transcript, vk: PlonkVK, public_inputs):
    """bindPublicData analog (verify.go:249-288): sigma + selector
    commitments + public inputs bound to the first challenge."""
    nb = _fp_bytes(vk.curve)
    for c in (vk.c_s1, vk.c_s2, vk.c_s3, vk.c_ql, vk.c_qr, vk.c_qm,
              vk.c_qo, vk.c_qc):
        fs.bind("gamma", _point_bytes(c, nb))
    frb = _fr_bytes(vk.curve)
    for x in public_inputs:
        fs.bind("gamma", int(x).to_bytes(frb, "big"))


def prove(cs, pk: PlonkPK, witness_values, rng=None, check: bool = True,
          timings: dict | None = None) -> PlonkProof:
    """witness_values: [public | secret] ints.  Runs on the device that
    holds pk; ``timings`` (a dict) receives per-phase seconds."""
    curve = pk.curve
    q = curve.fr.modulus
    n, ell = pk.n, pk.ell
    host = pk.host_mode
    P = _HostPoly(curve.fr, n) if host else _Poly(curve.fr, n, pk.device)
    rnd = _sampler(rng)
    ph = _Phases(timings, torch.device("cpu") if host else pk.device,
                 "plonk")

    nb_fp, nb_fr = _fp_bytes(curve), _fr_bytes(curve)
    sol = scs_solver.solve(cs, witness_values, check=check)
    public_inputs = [v % q for v in witness_values[:ell]]

    # row value vectors (PI rows then gates, padded)
    lv = public_inputs + sol.l + [0] * (n - ell - len(sol.l))
    rv = [0] * ell + sol.r + [0] * (n - ell - len(sol.r))
    ov = [0] * ell + sol.o + [0] * (n - ell - len(sol.o))
    ph.mark("solve")

    def blind(coeffs, nb):
        bs = [rnd(q) for _ in range(nb)]
        out = list(coeffs) + [0] * (nb)
        for i, b in enumerate(bs):
            out[i] = (out[i] - b) % q
            out[n + i] = (out[n + i] + b) % q
        return out

    l_c = blind(P.interpolate(lv), 2)
    r_c = blind(P.interpolate(rv), 2)
    o_c = blind(P.interpolate(ov), 2)
    ph.mark("interp_lro")

    c_l = kzg.commit(pk.srs, l_c, host=host)
    c_r = kzg.commit(pk.srs, r_c, host=host)
    c_o = kzg.commit(pk.srs, o_c, host=host)
    ph.mark("commit_lro")

    fs = Transcript(*CHALLENGES)
    _bind_public_data(fs, pk.vk, public_inputs)
    for c in (c_l, c_r, c_o):
        fs.bind("gamma", _point_bytes(c, nb_fp))
    gamma = fs.challenge_int("gamma", q)
    beta = fs.challenge_int("beta", q)
    ph.mark("transcript")

    # ---- Z permutation accumulator (computeBlindedZCanonical prove.go:566):
    # numerator/denominator products + running Z on the native core
    ks = (1, pk.k1, pk.k2)
    sig = pk.sigma_vals
    vals = (lv, rv, ov)
    nat = nat_for(q)
    w64 = nat.pack(pk.omega_pows)
    ones64 = nat.pack([1] * n)
    num64 = None
    den64 = None
    for c in range(3):
        v64 = nat.pack(vals[c])
        s64 = nat.pack(sig[c])
        # v + (beta*k_c)*w + gamma  /  v + beta*sigma_c + gamma
        nterm = nat.lincomb3(w64, ones64, v64, beta * ks[c] % q, gamma, 1)
        dterm = nat.lincomb3(s64, ones64, v64, beta, gamma, 1)
        num64 = nterm if num64 is None else nat.vecmul(num64, nterm)
        den64 = dterm if den64 is None else nat.vecmul(den64, dterm)
    ratio = nat.vecmul(num64, nat.batch_inv(den64))
    z64 = nat.prefix_mul(ratio, exclusive=True)
    z = nat.unpack(z64)
    if check:
        closing = nat.unpack(nat.vecmul(z64[-1:], ratio[-1:]))[0]
        assert closing == 1, "permutation argument accumulator must close"
    z_c = blind(P.interpolate(z), 3)
    ph.mark("z")
    c_z = kzg.commit(pk.srs, z_c, host=host)
    ph.mark("commit_z")
    fs.bind("alpha", _point_bytes(c_z, nb_fp))
    alpha = fs.challenge_int("alpha", q)
    ph.mark("transcript")

    # ---- quotient on the 4n coset (device, bit-reversed layout)
    F = P.F
    lE = P.eval_coset4(l_c)
    rE = P.eval_coset4(r_c)
    oE = P.eval_coset4(o_c)
    zE = P.eval_coset4(z_c)
    omega = pk.vk.generator
    zw_c = nat.unpack(nat.vecmul(nat.pack(z_c), nat.powers(omega, len(z_c))))
    zwE = P.eval_coset4(zw_c)

    qlE, qrE, qmE, qoE, qcE = pk.sel_E
    s1E, s2E, s3E = pk.sig_E
    xE = pk.x_E

    pi_vals = public_inputs + [0] * (n - ell)
    piE = P.eval_coset4(P.interpolate(pi_vals))
    ph.mark("coset_evals")

    gammaP, betaP, alphaP = P.const(gamma), P.const(beta), P.const(alpha)
    k1P, k2P = P.const(pk.k1), P.const(pk.k2)

    gate = F.add(F.add(F.add(F.mul(qlE, lE), F.mul(qrE, rE)),
                       F.add(F.mul(F.mul(qmE, lE), rE), F.mul(qoE, oE))),
                 F.add(qcE, piE))
    bx = F.mul(betaP, xE)
    f1 = F.add(F.add(lE, bx), gammaP)
    f2 = F.add(F.add(rE, F.mul(bx, k1P)), gammaP)
    f3 = F.add(F.add(oE, F.mul(bx, k2P)), gammaP)
    g1 = F.add(F.add(lE, F.mul(betaP, s1E)), gammaP)
    g2 = F.add(F.add(rE, F.mul(betaP, s2E)), gammaP)
    g3 = F.add(F.add(oE, F.mul(betaP, s3E)), gammaP)
    perm = F.sub(F.mul(zE, F.mul(F.mul(f1, f2), f3)),
                 F.mul(zwE, F.mul(F.mul(g1, g2), g3)))
    lag1 = F.mul(F.sub(zE, F.ones_like(zE)), pk.l1_E)
    numE = F.add(gate, F.mul(alphaP, F.add(perm, F.mul(alphaP, lag1))))
    tE = F.mul(numE, pk.zh_inv_E)
    ph.mark("pointwise")
    t_c = P.interp_coset4(tE)
    if check:
        assert all(v == 0 for v in t_c[3 * n + 6:]), "quotient degree overflow"
    h1, h2, h3 = (t_c[0:n + 2], t_c[n + 2:2 * n + 4],
                  t_c[2 * n + 4:3 * n + 6])
    ph.mark("interp_quotient")
    c_h1 = kzg.commit(pk.srs, h1, host=host)
    c_h2 = kzg.commit(pk.srs, h2, host=host)
    c_h3 = kzg.commit(pk.srs, h3, host=host)
    ph.mark("commit_h")
    for c in (c_h1, c_h2, c_h3):
        fs.bind("zeta", _point_bytes(c, nb_fp))
    zeta = fs.challenge_int("zeta", q)
    ph.mark("transcript")

    # ---- openings + linearization (computeLinearizedPolynomial prove.go:827)
    def ev(coeffs, x):
        return nat.horner(nat.pack(coeffs), x)

    l_bar = ev(l_c, zeta)
    r_bar = ev(r_c, zeta)
    o_bar = ev(o_c, zeta)
    s1_bar = ev(pk.s1_c, zeta)
    s2_bar = ev(pk.s2_c, zeta)
    zw_bar = ev(z_c, zeta * omega % q)

    zh_zeta = (pow(zeta, n, q) - 1) % q
    zeta_n2 = pow(zeta, n + 2, q)

    # r(X) = gate-with-evals + alpha * perm-with-evals + alpha^2 L1(zeta) Z(X)
    #        - Z_H(zeta) * (h1 + zeta^{n+2} h2 + zeta^{2(n+2)} h3)(X)
    fz = (l_bar + beta * zeta + gamma) % q
    fz = fz * ((r_bar + beta * pk.k1 * zeta + gamma) % q) % q
    fz = fz * ((o_bar + beta * pk.k2 * zeta + gamma) % q) % q
    gz_part = (l_bar + beta * s1_bar + gamma) * (r_bar + beta * s2_bar + gamma) % q
    l1_zeta = zh_zeta * pow(n, -1, q) % q * pow((zeta - 1) % q, -1, q) % q

    # r_poly's highest written index is max(len(z_c), len(s3_c), len(h*))-1,
    # so nlen entries suffice: a longer r_poly would give an opening
    # quotient one coefficient longer than the SRS
    nlen = max(len(z_c), len(pk.s3_c), len(h1), n)
    r_terms = [
        (pk.ql_c, l_bar), (pk.qr_c, r_bar), (pk.qm_c, l_bar * r_bar % q),
        (pk.qo_c, o_bar), (pk.qc_c, 1),
        (z_c, (alpha * fz + alpha * alpha % q * l1_zeta) % q),
        (pk.s3_c, (-alpha * zw_bar % q) * gz_part % q * beta % q),
        (h1, (-zh_zeta) % q),
        (h2, (-zh_zeta) * zeta_n2 % q),
        (h3, (-zh_zeta) * zeta_n2 % q * zeta_n2 % q),
    ]
    r_const = (- alpha * zw_bar % q * gz_part % q
               * ((o_bar + gamma) % q)) % q
    rp = np.zeros((nlen, nat.N), np.uint64)
    for coeffs, k in r_terms:
        arr = nat.pack(list(coeffs) + [0] * (nlen - len(coeffs)))
        rp = nat.vecadd(rp, nat.vecmul(arr, k))
    rp[0:1] = nat.vecadd(rp[0:1], r_const)
    r_poly = nat.unpack(rp)

    r_bar_val = ev(r_poly, zeta)
    if check:
        pi_zeta = _pi_at(public_inputs, zeta, n, omega, q)
        expect = (-pi_zeta + alpha * alpha % q * l1_zeta) % q
        assert r_bar_val == expect, "linearization identity failed"
    ph.mark("linearize")

    evals = [r_bar_val, l_bar, r_bar, o_bar, s1_bar, s2_bar]
    for v in evals + [zw_bar]:
        fs.bind("eta", v.to_bytes(nb_fr, "big"))
    eta = fs.challenge_int("eta", q)
    ph.mark("transcript")
    _, w_zeta = kzg.open_poly(
        pk.srs,
        kzg.fold_polys([r_poly, l_c, r_c, o_c, pk.s1_c, pk.s2_c], eta, q),
        zeta, host=host)
    # the folded claimed value must also be subtracted; open_poly already
    # divides exactly because fold(values) = folded(zeta)
    _, w_zw = kzg.open_poly(pk.srs, z_c, zeta * omega % q, host=host)
    ph.mark("open")

    return PlonkProof(
        c_l=c_l, c_r=c_r, c_o=c_o, c_z=c_z,
        c_h1=c_h1, c_h2=c_h2, c_h3=c_h3,
        evals=evals, w_zeta=w_zeta,
        z_omega_zeta=zw_bar, w_zeta_omega=w_zw)


def _pi_at(public_inputs, x, n, omega, q):
    """PI(x) = sum_i x_i * L_i(x), barycentric (verify.go:91-110)."""
    zh = (pow(x, n, q) - 1) % q
    ninv = pow(n, -1, q)
    acc, w = 0, 1
    for v in public_inputs:
        if v % q:
            acc = (acc + v * zh % q * ninv % q * w % q
                   * pow((x - w) % q, -1, q)) % q
        w = w * omega % q
    return acc


# ---- verify -----------------------------------------------------------------------


def verify(proof: PlonkProof, vk: PlonkVK, public_inputs) -> bool:
    curve = vk.curve
    q = curve.fr.modulus
    n = vk.n
    if len(public_inputs) != vk.ell:
        raise ValueError(f"want {vk.ell} public inputs")
    public_inputs = [v % q for v in public_inputs]
    host1 = curve.host_g1

    # on-curve + prime-subgroup validation of every proof point (the
    # reference subgroup-checks at deserialization, bn254/marshal.go
    # SetBytes; groth16.verify here does the same)
    for p in (proof.c_l, proof.c_r, proof.c_o, proof.c_z, proof.c_h1,
              proof.c_h2, proof.c_h3, proof.w_zeta, proof.w_zeta_omega):
        if p is not None and (
                not host1.is_on_curve(p)
                or host1.scalar_mul(p, q) is not None):
            return False

    nb_fp, nb_fr = _fp_bytes(curve), _fr_bytes(curve)
    fs = Transcript(*CHALLENGES)
    _bind_public_data(fs, vk, public_inputs)
    for c in (proof.c_l, proof.c_r, proof.c_o):
        fs.bind("gamma", _point_bytes(c, nb_fp))
    gamma = fs.challenge_int("gamma", q)
    beta = fs.challenge_int("beta", q)
    fs.bind("alpha", _point_bytes(proof.c_z, nb_fp))
    alpha = fs.challenge_int("alpha", q)
    for c in (proof.c_h1, proof.c_h2, proof.c_h3):
        fs.bind("zeta", _point_bytes(c, nb_fp))
    zeta = fs.challenge_int("zeta", q)

    r_bar, l_bar, rr_bar, o_bar, s1_bar, s2_bar = [v % q for v in proof.evals]
    zw_bar = proof.z_omega_zeta % q
    omega = vk.generator

    zh_zeta = (pow(zeta, n, q) - 1) % q
    if zh_zeta == 0:
        return False
    l1_zeta = zh_zeta * pow(n, -1, q) % q * pow((zeta - 1) % q, -1, q) % q
    pi_zeta = _pi_at(public_inputs, zeta, n, omega, q)

    # quotient identity at zeta (verify.go:117-153)
    if r_bar != (-pi_zeta + alpha * alpha % q * l1_zeta) % q:
        return False

    # rebuild [r] (verify.go:195-206)
    fz = (l_bar + beta * zeta + gamma) % q
    fz = fz * ((rr_bar + beta * vk.k1 * zeta + gamma) % q) % q
    fz = fz * ((o_bar + beta * vk.k2 * zeta + gamma) % q) % q
    gz_part = ((l_bar + beta * s1_bar + gamma)
               * (rr_bar + beta * s2_bar + gamma)) % q
    zeta_n2 = pow(zeta, n + 2, q)

    terms = [
        (vk.c_ql, l_bar),
        (vk.c_qr, rr_bar),
        (vk.c_qm, l_bar * rr_bar % q),
        (vk.c_qo, o_bar),
        (vk.c_qc, 1),
        (proof.c_z, (alpha * fz + alpha * alpha % q * l1_zeta) % q),
        (vk.c_s3, (-alpha * zw_bar % q) * gz_part % q * beta % q),
        (vk.g1_gen, (-alpha * zw_bar % q) * gz_part % q
         * ((o_bar + gamma) % q) % q),
        (proof.c_h1, (-zh_zeta) % q),
        (proof.c_h2, (-zh_zeta) * zeta_n2 % q),
        (proof.c_h3, (-zh_zeta) * zeta_n2 % q * zeta_n2 % q),
    ]
    c_r_lin = None
    for point, scalar in terms:
        if point is not None and scalar % q:
            c_r_lin = host1.add(c_r_lin, host1.scalar_mul(point, scalar % q))

    # fold the batch at zeta (FoldProof analog)
    for v in proof.evals + [zw_bar]:
        fs.bind("eta", int(v).to_bytes(nb_fr, "big"))
    eta = fs.challenge_int("eta", q)
    batch_cs = [c_r_lin, proof.c_l, proof.c_r, proof.c_o, vk.c_s1, vk.c_s2]
    folded_c, folded_v, e = None, 0, 1
    for C, v in zip(batch_cs, proof.evals):
        if C is not None:
            folded_c = host1.add(folded_c, host1.scalar_mul(C, e))
        folded_v = (folded_v + e * v) % q
        e = e * eta % q

    fs.bind("u", _point_bytes(proof.w_zeta, nb_fp))
    fs.bind("u", _point_bytes(proof.w_zeta_omega, nb_fp))
    u = fs.challenge_int("u", q)

    srs_view = kzg.SRS(curve=curve, g1=[vk.g1_gen], g2_gen=vk.g2_gen,
                       g2_tau=vk.g2_tau)
    return kzg.batch_verify_multi_points(
        srs_view,
        [folded_c, proof.c_z],
        [zeta, zeta * omega % q],
        [folded_v, zw_bar],
        [proof.w_zeta, proof.w_zeta_omega],
        u=u)
