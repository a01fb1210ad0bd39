"""Groth16 setup / prove / verify on PyTorch (counterpart of
gnark_tpu/backend/groth16.py, BN254 device path).

  * setup: the native-core QAP at tau, then the key points on the device
    with the plain-torch fixed-base tables and a batch ``to_affine``;
  * prove: the witness solver (backend/solver.py), the quotient by NTT on the device,
    five MSMs (four G1, one G2 over fp2) through ``ops.msm.msm``: the
    ladder below 8192 points, the windowed plan from there (the MSM
    kernels run on a CUDA device), and the host assembly with the
    blinding terms r and s, drawn in the same order as gnark_tpu's;
  * verify: the host pairing check.

The protocol pieces of ``gnark_tpu/backend/groth16.py`` have their
counterparts here: the key and proof dataclasses, ``_sampler``,
``_qap_at_tau_native``, the blinding assembly and ``verify``
(``_next_pow2`` comes from ops/msm.py).
"""

from __future__ import annotations

import dataclasses
import secrets
import time

import numpy as np
import torch

from gnark_tpu_torch.backend.native_field import nat_for
from gnark_tpu_torch.backend.solver import solve
from gnark_tpu_torch.curves import ALL_CURVES
from gnark_tpu_torch.curves.pairing import pairing_for
from gnark_tpu_torch.fields.spec import W
from gnark_tpu_torch.ops.ec import CurveOps, points_to_device
from gnark_tpu_torch.ops.fixed_base import FixedBaseTable
from gnark_tpu_torch.ops.limbs import field_ops, ints_to_limbs, limbs_to_ints
from gnark_tpu_torch.ops.msm import _next_pow2, msm
from gnark_tpu_torch.ops.ntt import Domain, bit_reverse_perm
from gnark_tpu_torch.ops.towers import fp2_ops

__all__ = ["ProvingKey", "VerifyingKey", "Proof", "setup", "prove",
           "verify", "compute_h", "proving_key_from_jax", "ints_to_limbs",
           "limbs_to_ints"]


@dataclasses.dataclass
class VerifyingKey:
    curve: object
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    K: list                 # public-wire commitments (host affine, None=inf)
    e_alpha_beta: tuple     # precomputed GT element
    nb_public: int          # includes the one-wire
    beta_g1: tuple = None
    delta_g1: tuple = None


@dataclasses.dataclass
class ProvingKey:
    curve: object
    domain_n: int
    n_pad: int              # common padded batch size of A/B1/B2/K/Z
    alpha_g1: tuple
    beta_g1: tuple
    delta_g1: tuple
    beta_g2: tuple
    delta_g2: tuple
    # (x, y, inf): affine Montgomery limb planes [L, n_pad] and a [n_pad]
    # bool mask, all on one device
    A: tuple
    B1: tuple
    B2: tuple               # fp2 coordinates [2L, n_pad]
    K: tuple                # private wires only
    Z: tuple                # domain points, bit-reversed order

    @property
    def device(self):
        return self.A[0].device


@dataclasses.dataclass
class Proof:
    ar: tuple               # host affine G1
    bs: tuple               # host affine G2
    krs: tuple              # host affine G1


def _device(device) -> torch.device:
    """The device an entry point was given; the default, the card, must
    be there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "stay on the host")
    return device


def _sampler(rng):
    """rng: None (secure default) or a random.Random (test determinism)."""
    if rng is None:
        return secrets.randbelow
    return lambda q: rng.randrange(q)


class _Groups:
    """G1 over fp and G2 over fp2 for one curve."""

    _cache = {}

    def __new__(cls, curve):
        if curve.name not in cls._cache:
            self = super().__new__(cls)
            self.fr = field_ops(curve.fr)
            self.fp = field_ops(curve.fp)
            self.fp2 = fp2_ops(curve.fp, curve.fp2_beta)
            self.g1 = CurveOps(self.fp, b=curve.b)
            self.g2 = CurveOps(self.fp2, b=curve.b2)
            cls._cache[curve.name] = self
        return cls._cache[curve.name]


# ---- setup ---------------------------------------------------------------------


def _qap_at_tau_native(cs, fr_spec, tau: int, n: int, nat):
    """Per-wire A_i(tau), B_i(tau), C_i(tau) as [nw, N] uint64 limb rows
    (regular form), every O(m)/O(nnz) pass on the native core."""
    q = cs.field_modulus
    m = cs.nb_constraints
    omega = fr_spec.root_of_unity(n)
    wc = nat.powers(omega, m)                       # [m, N]: w^c
    zeros = np.zeros_like(wc)
    tau_b = np.broadcast_to(nat.pack([tau]), wc.shape).copy()
    dens = nat.lincomb3(wc, zeros, tau_b, q - 1, 0, 1)   # tau - w^c
    dens_inv = nat.batch_inv(dens)
    zt = (pow(tau, n, q) - 1) % q
    base = zt * pow(n, -1, q) % q
    lag = nat.vecmul(nat.vecmul(wc, dens_inv), base)
    coeffs_mont = nat.pack_mont(cs.coeffs)
    nw = cs.nb_wires
    A = nat.qap_accumulate(cs.L, coeffs_mont, lag, nw)
    B = nat.qap_accumulate(cs.R, coeffs_mont, lag, nw)
    C = nat.qap_accumulate(cs.O, coeffs_mont, lag, nw)
    return A, B, C, zt


def setup(cs, curve, rng=None, *, device="cuda"):
    """-> (ProvingKey, VerifyingKey) with the key points on ``device``:
    the card unless the caller names another (raises when there is none)."""
    device = _device(device)
    q = curve.fr.modulus
    rnd = _sampler(rng)

    def sample_nonzero():
        while True:
            v = rnd(q)
            if v:
                return v

    tau, alpha, beta, gamma, delta = (sample_nonzero() for _ in range(5))
    n = _next_pow2(cs.nb_constraints)
    gamma_inv = pow(gamma, -1, q)
    delta_inv = pow(delta, -1, q)
    nb_pub = cs.nb_public

    nat = nat_for(q)
    A64, B64, C64, zt = _qap_at_tau_native(cs, curve.fr, tau, n, nat)
    vk_k = nat.unpack(nat.lincomb3(
        A64[:nb_pub], B64[:nb_pub], C64[:nb_pub], beta, alpha, gamma_inv))
    pk_k64 = nat.lincomb3(
        A64[nb_pub:], B64[nb_pub:], C64[nb_pub:], beta, alpha, delta_inv)
    # Z powers tau^j Z(tau)/delta, bit-reversed so the prover's coset-iFFT
    # output feeds the MSM directly
    zs64 = nat.powers(tau, n, start=zt * delta_inv % q)
    zs_brev64 = zs64[np.asarray(bit_reverse_perm(n))]

    n_pad = _next_pow2(max(cs.nb_wires, n, 2))
    Ls = curve.fr.L

    def planes(rows64):
        p = nat.planes(rows64, Ls).astype(np.int64)
        p = np.pad(p, ((0, 0), (0, n_pad - p.shape[1])))
        return torch.from_numpy(p).to(device)

    K = _Groups(curve)
    scalar_bits = curve.fr.L * W
    fb1 = FixedBaseTable(K.g1, curve.host_g1, curve.g1_gen, scalar_bits,
                         device)
    fb2 = FixedBaseTable(K.g2, curve.host_g2, curve.g2_gen, scalar_bits,
                         device)
    A_pts = K.g1.to_affine(fb1(planes(A64)))
    B1_pts = K.g1.to_affine(fb1(planes(B64)))
    K_pts = K.g1.to_affine(fb1(planes(pk_k64)))
    Z_pts = K.g1.to_affine(fb1(planes(zs_brev64)))
    B2_pts = K.g2.to_affine(fb2(planes(B64)))

    host1, host2 = curve.host_g1, curve.host_g2
    g1, g2 = curve.g1_gen, curve.g2_gen
    alpha_g1 = host1.scalar_mul(g1, alpha)
    beta_g1 = host1.scalar_mul(g1, beta)
    delta_g1 = host1.scalar_mul(g1, delta)
    beta_g2 = host2.scalar_mul(g2, beta)
    gamma_g2 = host2.scalar_mul(g2, gamma)
    delta_g2 = host2.scalar_mul(g2, delta)
    vk_k_host = [None if s % q == 0 else host1.scalar_mul(g1, s) for s in vk_k]
    e_ab = pairing_for(curve).pair(alpha_g1, beta_g2)

    pk = ProvingKey(
        curve=curve, domain_n=n, n_pad=n_pad,
        alpha_g1=alpha_g1, beta_g1=beta_g1, delta_g1=delta_g1,
        beta_g2=beta_g2, delta_g2=delta_g2,
        A=A_pts, B1=B1_pts, B2=B2_pts, K=K_pts, Z=Z_pts)
    vk = VerifyingKey(
        curve=curve, alpha_g1=alpha_g1, beta_g2=beta_g2,
        gamma_g2=gamma_g2, delta_g2=delta_g2, K=vk_k_host,
        e_alpha_beta=e_ab, nb_public=nb_pub,
        beta_g1=beta_g1, delta_g1=delta_g1)
    return pk, vk


def proving_key_from_jax(pk, device) -> ProvingKey:
    """A gnark_tpu ProvingKey -> this package's key on ``device``.

    Reads the dataclass fields only (no jax import): host point lists
    (``host=True``) are packed; device arrays are expected as numpy
    arrays already (Montgomery uint32 limb planes and bool masks).  The
    curve becomes this package's own spec of the same name."""
    curve = ALL_CURVES[pk.curve.name]
    K = _Groups(curve)

    def g1(v):
        if pk.host:
            return points_to_device(K.g1, v, 0, device)
        return _planes_from_numpy(v, device)

    def g2(v):
        if pk.host:
            return points_to_device(K.g2, v, (0, 0), device)
        return _planes_from_numpy(v, device)

    return ProvingKey(
        curve=curve, domain_n=pk.domain_n, n_pad=pk.n_pad,
        alpha_g1=pk.alpha_g1, beta_g1=pk.beta_g1, delta_g1=pk.delta_g1,
        beta_g2=pk.beta_g2, delta_g2=pk.delta_g2,
        A=g1(pk.A), B1=g1(pk.B1), B2=g2(pk.B2), K=g1(pk.K), Z=g1(pk.Z))


def _planes_from_numpy(v, device):
    x, y, inf = (np.asarray(a) for a in v)
    return (torch.from_numpy(x.astype(np.int64)).to(device),
            torch.from_numpy(y.astype(np.int64)).to(device),
            torch.from_numpy(inf.astype(bool)).to(device))


# ---- prove ----------------------------------------------------------------------


def compute_h(domain: Domain, a, b, c):
    """Quotient h = (A*B - C)/Z on the device; bit-reversed coefficients.

    iFFT (DIF) -> coset FFT (DIT) -> pointwise (ab - c) / (g^n - 1) ->
    coset iFFT (DIF); Z is the constant g^n - 1 on the coset."""
    F, q = domain.F, domain.spec.modulus
    den = pow(pow(domain.coset_gen, domain.n, q) - 1, -1, q)
    den_pl = F.pack([den], domain.device)

    def coset_evals(x):
        return domain.fft(domain.ifft(x, "DIF"), "DIT", coset=True)

    ae, be, ce = coset_evals(a), coset_evals(b), coset_evals(c)
    h = F.mul(F.sub(F.mul(ae, be), ce), den_pl)
    return domain.ifft(h, "DIF", coset=True)


def _host_ntt(vals, omega, q, inverse=False):
    """Iterative radix-2 NTT on host ints (tiny-circuit / host-path use)."""
    n = len(vals)
    a = [v % q for v in vals]
    # bit-reversal permutation
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    w_base = pow(omega, -1, q) if inverse else omega
    length = 2
    while length <= n:
        wl = pow(w_base, n // length, q)
        for start in range(0, n, length):
            w = 1
            for k in range(start, start + length // 2):
                u, v = a[k], a[k + length // 2] * w % q
                a[k] = (u + v) % q
                a[k + length // 2] = (u - v) % q
                w = w * wl % q
        length <<= 1
    if inverse:
        ninv = pow(n, -1, q)
        a = [x * ninv % q for x in a]
    return a


_domains = {}


def _domain(spec, n, device):
    key = (spec.name, n, str(device))
    if key not in _domains:
        _domains[key] = Domain(spec, n, device)
    return _domains[key]


class _Phases:
    """Seconds per prover phase, synchronised with the device, into
    ``timings`` when the caller passes a dict (a phase marked more than
    once adds up)."""

    def __init__(self, timings, device):
        self.timings, self.device = timings, device
        self.t = time.perf_counter()

    def mark(self, name):
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + now - self.t
        self.t = now


def prove(cs, pk: ProvingKey, witness_values, rng=None, check: bool = True,
          timings: dict | None = None) -> Proof:
    """witness_values: [public (no one-wire) | secret] ints.  Runs on the
    device that holds pk; ``timings`` (a dict) receives per-phase
    seconds."""
    curve = pk.curve
    q = curve.fr.modulus
    rnd = _sampler(rng)
    device = pk.device
    ph = _Phases(timings, device)

    sol = solve(cs, witness_values, check=check)
    ph.mark("solve")
    K = _Groups(curve)
    n, n_pad, Ls = pk.domain_n, pk.n_pad, curve.fr.L

    def limb_planes(name, start, k):
        if sol.limbs is not None:
            arr = np.asarray(sol.limbs[name][:, start:], np.int64)
        else:
            arr = ints_to_limbs(getattr(sol, name)[start:], Ls).astype(
                np.int64)
        arr = np.pad(arr, ((0, 0), (0, k - arr.shape[1])))
        return torch.from_numpy(arr).to(device)

    am = K.fr.to_mont(limb_planes("a", 0, n))
    bm = K.fr.to_mont(limb_planes("b", 0, n))
    cm = K.fr.to_mont(limb_planes("c", 0, n))
    h = K.fr.from_mont(compute_h(_domain(curve.fr, n, device), am, bm, cm))
    h = torch.cat([h, h.new_zeros(Ls, n_pad - n)], 1)
    ph.mark("compute_h")

    wires = limb_planes("values", 0, n_pad)
    priv = limb_planes("values", cs.nb_public, n_pad)
    r, s = rnd(q), rnd(q)

    ar_j = msm(K.g1, *pk.A, wires)
    ph.mark("msm_g1_A")
    bs1_j = msm(K.g1, *pk.B1, wires)
    ph.mark("msm_g1_B1")
    bs2_j = msm(K.g2, *pk.B2, wires)
    ph.mark("msm_g2_B2")
    krs_pk = msm(K.g1, *pk.K, priv)
    ph.mark("msm_g1_K")
    krs_z = msm(K.g1, *pk.Z, h)
    ph.mark("msm_g1_Z")

    # host assembly (small): fold in the blinding terms r, s
    host1, host2 = curve.host_g1, curve.host_g2
    ar_p = _to_host(K.g1, host1, ar_j)
    bs1_p = _to_host(K.g1, host1, bs1_j)
    bs2_p = _to_host(K.g2, host2, bs2_j)
    krs_p = _to_host(K.g1, host1, krs_pk)
    krsz_p = _to_host(K.g1, host1, krs_z)
    ph.mark("to_host")
    ar = host1.add(host1.add(ar_p, pk.alpha_g1),
                   host1.scalar_mul(pk.delta_g1, r))
    bs1 = host1.add(host1.add(bs1_p, pk.beta_g1),
                    host1.scalar_mul(pk.delta_g1, s))
    bs = host2.add(host2.add(bs2_p, pk.beta_g2),
                   host2.scalar_mul(pk.delta_g2, s))
    krs = host1.add(krs_p, krsz_p)
    krs = host1.add(krs, host1.scalar_mul(ar, s))
    krs = host1.add(krs, host1.scalar_mul(bs1, r))
    krs = host1.add(krs, host1.scalar_mul(pk.delta_g1, (-r * s) % q))
    ph.mark("assembly")
    return Proof(ar=ar, bs=bs, krs=krs)


def _to_host(G: CurveOps, host, P):
    """One Jacobian result point -> host affine (None = infinity).  The
    three coordinates are read back and inverted with host ints: a device
    Fermat inversion of a single element is hundreds of dispatch-bound
    products."""
    X, Y, Z = (G.F.unpack(a)[0] for a in P)
    F = host.F
    if F.is_zero(Z):
        return None
    zinv = F.inv(Z)
    zinv2 = F.sqr(zinv)
    return (F.mul(X, zinv2), F.mul(Y, F.mul(zinv2, zinv)))


# ---- verify ---------------------------------------------------------------------


def verify(proof: Proof, vk: VerifyingKey, public_values) -> bool:
    """public_values: the public inputs without the leading one-wire.

    e(Ar, Bs) == e(alpha, beta) * e(kSum, gamma) * e(Krs, delta), as one
    product-is-one check on the host."""
    curve = vk.curve
    q = curve.fr.modulus
    if len(public_values) != vk.nb_public - 1:
        raise ValueError(
            f"got {len(public_values)} public inputs, want {vk.nb_public - 1}")
    host1 = curve.host_g1
    for p, grp in ((proof.ar, host1), (proof.krs, host1),
                   (proof.bs, curve.host_g2)):
        if not grp.is_on_curve(p) or grp.scalar_mul(p, q) is not None:
            return False
    ksum = vk.K[0]
    for point, value in zip(vk.K[1:], public_values):
        if point is not None and value % q:
            ksum = host1.add(ksum, host1.scalar_mul(point, value % q))
    pr = pairing_for(curve)
    f = pr.miller_loop([
        (host1.neg(proof.ar), proof.bs),
        (ksum, vk.gamma_g2),
        (proof.krs, vk.delta_g2),
    ])
    return pr.final_exp(f) == pr.fp12.conj(vk.e_alpha_beta)
