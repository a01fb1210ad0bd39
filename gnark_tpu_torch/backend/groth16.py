"""Groth16 setup / prove / verify on PyTorch (counterpart of
gnark_tpu/backend/groth16.py), over the six curves of ``curves``.

  * setup: the native-core QAP at tau, then the key points: on the device
    with the plain-torch fixed-base tables and a batch ``to_affine``; for
    a base field of 24 or more 16-bit limbs (BLS12-381, BLS12-377, BW6-761,
    BW6-633) on the native core, as gnark_tpu routes them; with
    ``host=True`` as host point lists;
  * prove: the witness solver (backend/solver.py), the quotient by NTT on
    the device, five MSMs (four G1, one G2) through ``ops.msm.msm``: the
    ladder below 8192 points, the windowed plan from there (the MSM
    kernels run on a CUDA device); for ``fp.L >= 24`` all five on the
    native core's Pippenger; then the host assembly with the blinding
    terms r and s, drawn in the same order as gnark_tpu's.  A host key
    proves on host ints and the native core (``_prove_host``).  With
    ``mesh=``, the quotient and the MSMs are split over a mesh axis
    (parallel/);
  * verify: the host pairing check.

G2 lives over fp2 (BN254, BLS12-381, BLS12-377), over fp4 (BLS24-315)
or over fp itself (BW6-761, BW6-633).  gnark_tpu's native route sends
BLS12's G2 to a native core that only knew fp and fails there
(``TypeError`` in ``native_fixed_base``); the port's native core takes
fp2 too, so the route runs on every curve it names.

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

from gnark_tpu_torch.backend.native_field import (
    nat_for, native_fixed_base, native_fixed_base_affine, native_msm)
from gnark_tpu_torch.backend.solver import solve
from gnark_tpu_torch.curves import ALL_CURVES
from gnark_tpu_torch.curves.pairing import pairing_for
from gnark_tpu_torch.fields.spec import W
from gnark_tpu_torch.ops.ec import CurveOps, points_to_device
from gnark_tpu_torch.ops.fixed_base import FixedBaseTable
from gnark_tpu_torch.ops.limbs import field_ops, ints_to_limbs, limbs_to_ints
from gnark_tpu_torch.ops.msm import _next_pow2, msm
from gnark_tpu_torch.ops.ntt import Domain, bit_reverse_perm, fr_pointwise
from gnark_tpu_torch.ops.towers import fp2_ops, fpk_ops
from gnark_tpu_torch.utils import profiling

__all__ = ["ProvingKey", "VerifyingKey", "Proof", "setup", "prove",
           "verify", "compute_h", "proving_key_from_jax", "pk_to_device",
           "key_planes",
           "ints_to_limbs", "limbs_to_ints"]


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
    # bool mask, tensors on ``device``, or numpy arrays on the native route
    # (the native core's MSMs read them); with host=True, lists of host
    # affine points (None = infinity)
    A: tuple
    B1: tuple
    B2: tuple               # G2 coordinates ([2L, n_pad] over fp2)
    K: tuple                # private wires only
    Z: tuple                # domain points, bit-reversed order
    host: bool = False
    device: object = None   # where the prove runs; None for a host key


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
    """G1 over fp and G2 over its coordinate field for one curve, as
    gnark_tpu's ``_CurveKernels`` picks it (groth16.py:198-224): fp itself
    for BW6, fp4 for BLS24, fp2 with the curve's beta otherwise.  G2 keeps
    its curve coefficient b on every curve: the MSM runs on the complete
    formulas, which need it (gnark_tpu drops it for fp4 G2, whose Jacobian
    ladder does not)."""

    _cache = {}

    def __new__(cls, curve):
        if curve.name not in cls._cache:
            self = super().__new__(cls)
            self.fr = field_ops(curve.fr)
            self.fp = field_ops(curve.fp)
            # g2_beta: the native core's field for G2, fp (0) or fp2
            self.g2_beta = 0
            if curve.g2_over_fp:
                self.fp2, self.g2_zero = self.fp, 0
            elif curve.g2_tower_k == 4:
                self.fp2 = fpk_ops(curve.fp, 4, curve.g2_tower_c)
                self.g2_zero = (0, 0, 0, 0)
            else:
                self.fp2 = fp2_ops(curve.fp, curve.fp2_beta)
                self.g2_zero, self.g2_beta = (0, 0), curve.fp2_beta
            self.g1 = CurveOps(self.fp, b=curve.b)
            self.g2 = CurveOps(self.fp2, b=curve.b2)
            cls._cache[curve.name] = self
        return cls._cache[curve.name]


def native_route(curve) -> bool:
    """gnark_tpu's cut (groth16.py:415, 688; kzg.py:124): key points and
    MSMs of a base field of 24 or more 16-bit limbs go to the native core;
    only the quotient's NTTs stay on the device.  By the curve alone."""
    return curve.fp.L >= 24


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


# Columns of one fixed-base slice: one kernel launch on the card, one
# batch of the plain version on the CPU, whose [L^2, m] int64 and float64
# product temporaries (18 fp2 base elements a column at once in a G2
# addition) come near 20 GB at 2^18 columns.  A column's point does not
# depend on its slice.
SETUP_COLUMNS = 1 << 18


def setup(cs, curve, rng=None, host: bool = False, *, device="cuda",
          timings: dict | None = None):
    """-> (ProvingKey, VerifyingKey).  The key points go to ``device``:
    the card unless the caller names another (raises when there is none);
    on the native core for ``native_route(curve)``, on the device's
    fixed-base tables otherwise, SETUP_COLUMNS scalars at a time.
    ``host=True`` keeps host point lists and touches no device (tiny
    circuits, protocol tests).  ``timings`` (a dict) receives the seconds
    of each part: ``qap`` (the native QAP at tau and the key scalars),
    ``tables`` (the fixed-base window tables, on the host), one
    ``fixed_base_<group>_<name>`` a key batch, ``to_affine`` (the device
    route's batch inversions) and ``vk`` (the host scalar multiplications
    and the pairing)."""
    if not host:
        device = _device(device)
    ph = _Phases(timings, torch.device("cpu") if host else device,
                 scheme="groth16_setup")
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
    ph.mark("qap")

    n_pad = _next_pow2(max(cs.nb_wires, n, 2))
    Ls = curve.fr.L
    K = _Groups(curve)

    def rows_padded(rows64):
        return np.concatenate([rows64, np.zeros(
            (n_pad - rows64.shape[0], rows64.shape[1]), np.uint64)])

    if host:
        def g1_batch(rows64):
            return native_fixed_base_affine(
                curve, nat.unpack(rows_padded(rows64)), curve.g1_gen)

        def g2_batch(rows64):
            vals = nat.unpack(rows_padded(rows64))
            if curve.g2_tower_k == 4:        # fp4: no native core
                return [None if v % q == 0 else
                        curve.host_g2.scalar_mul(curve.g2_gen, v % q)
                        for v in vals]
            return native_fixed_base_affine(curve, vals, curve.g2_gen,
                                            beta=K.g2_beta)
    elif native_route(curve):
        def g1_batch(rows64):
            return native_fixed_base(curve, rows_padded(rows64),
                                     curve.g1_gen)

        def g2_batch(rows64):
            return native_fixed_base(curve, rows_padded(rows64),
                                     curve.g2_gen, beta=K.g2_beta)
    else:
        def planes(rows64):
            p = nat.planes(rows64, Ls).astype(np.int64)
            p = np.pad(p, ((0, 0), (0, n_pad - p.shape[1])))
            return torch.from_numpy(p).to(device)

        scalar_bits = curve.fr.L * W
        # the table's 8-bit windows at every size, as gnark_tpu's: no
        # wider window pays for its 2^c host entries at these sizes
        fb1 = FixedBaseTable(K.g1, curve.host_g1, curve.g1_gen, scalar_bits,
                             device)
        fb2 = FixedBaseTable(K.g2, curve.host_g2, curve.g2_gen, scalar_bits,
                             device)
        ph.mark("tables")

        def sliced(fb):
            def batch(rows64):
                sc = planes(rows64)
                return tuple(torch.cat(t, -1) for t in zip(*(
                    fb(sc[:, j:j + SETUP_COLUMNS])
                    for j in range(0, n_pad, SETUP_COLUMNS))))
            return batch

        g1_batch, g2_batch = sliced(fb1), sliced(fb2)

    jacobian = not (host or native_route(curve))     # the device's tables
    pts = {}
    for name, G, batch, rows64 in (("g1_A", K.g1, g1_batch, A64),
                                   ("g1_B1", K.g1, g1_batch, B64),
                                   ("g1_K", K.g1, g1_batch, pk_k64),
                                   ("g1_Z", K.g1, g1_batch, zs_brev64),
                                   ("g2_B2", K.g2, g2_batch, B64)):
        pts[name] = batch(rows64)
        ph.mark(f"fixed_base_{name}")
        if jacobian:
            pts[name] = G.to_affine(pts[name])
            ph.mark("to_affine")
    A_pts, B1_pts, K_pts, Z_pts, B2_pts = pts.values()

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
    ph.mark("vk")

    pk = ProvingKey(
        curve=curve, domain_n=n, n_pad=n_pad,
        alpha_g1=alpha_g1, beta_g1=beta_g1, delta_g1=delta_g1,
        beta_g2=beta_g2, delta_g2=delta_g2,
        A=A_pts, B1=B1_pts, B2=B2_pts, K=K_pts, Z=Z_pts, host=host,
        device=None if host else device)
    vk = VerifyingKey(
        curve=curve, alpha_g1=alpha_g1, beta_g2=beta_g2,
        gamma_g2=gamma_g2, delta_g2=delta_g2, K=vk_k_host,
        e_alpha_beta=e_ab, nb_public=nb_pub,
        beta_g1=beta_g1, delta_g1=delta_g1)
    return pk, vk


_KEY_POINTS = ("A", "B1", "B2", "K", "Z")


def dummy_setup(cs, curve, *, device="cuda") -> ProvingKey:
    """A fake proving key, every point the generator, for timing the
    prover without a trusted setup (gnark_tpu's dummy_setup; gnark's
    DummySetup, internal/backend/bn254/groth16/setup.go:411).  Its proofs
    do NOT verify.  The points go to ``device`` (the card by default), as
    numpy planes on the native route."""
    device = _device(device)
    K = _Groups(curve)
    n = _next_pow2(cs.nb_constraints)
    n_pad = _next_pow2(max(cs.nb_wires, n, 2))
    native = native_route(curve)
    g1, g2 = curve.g1_gen, curve.g2_gen

    def batch(G, point, zero):
        one = points_to_device(G, [point], zero,
                               "cpu" if native else device)
        planes = tuple(t.expand(*t.shape[:-1], n_pad).contiguous()
                       for t in one)
        return tuple(t.numpy() for t in planes) if native else planes

    g1_pts = batch(K.g1, g1, 0)
    return ProvingKey(
        curve=curve, domain_n=n, n_pad=n_pad,
        alpha_g1=g1, beta_g1=g1, delta_g1=g1, beta_g2=g2, delta_g2=g2,
        A=g1_pts, B1=g1_pts, B2=batch(K.g2, g2, K.g2_zero), K=g1_pts,
        Z=g1_pts, device=device)


def pk_to_device(pk: ProvingKey, device) -> ProvingKey:
    """A host key (setup(host=True)) -> the same key proved on ``device``
    (gnark_tpu's pk_to_device): its points packed as limb planes there, or
    as numpy planes on the native route.  Packing only."""
    if not pk.host:
        return pk
    K = _Groups(pk.curve)
    device = torch.device(device)
    native = native_route(pk.curve)
    pts = {}
    for name in _KEY_POINTS:
        planes = points_to_device(K.g2 if name == "B2" else K.g1,
                                  getattr(pk, name),
                                  K.g2_zero if name == "B2" else 0,
                                  "cpu" if native else device)
        pts[name] = (tuple(a.numpy() for a in planes) if native
                     else planes)
    return dataclasses.replace(pk, host=False, device=device, **pts)


def proving_key_from_jax(pk, device=None) -> ProvingKey:
    """A gnark_tpu ProvingKey -> this package's key, on any curve.

    Reads the dataclass fields only (no jax import).  A host key
    (``host=True``) stays a host key when ``device`` is None and is packed
    onto ``device`` otherwise; device arrays are expected as numpy arrays
    already (Montgomery uint32 limb planes and bool masks).  The curve
    becomes this package's own spec of the same name."""
    curve = ALL_CURVES[pk.curve.name]
    if device is None and not pk.host:
        raise ValueError("a device key needs a device")
    native = native_route(curve)
    key = ProvingKey(
        curve=curve, domain_n=pk.domain_n, n_pad=pk.n_pad,
        alpha_g1=pk.alpha_g1, beta_g1=pk.beta_g1, delta_g1=pk.delta_g1,
        beta_g2=pk.beta_g2, delta_g2=pk.delta_g2, host=bool(pk.host),
        device=None if pk.host else torch.device(device),
        **{name: (list(getattr(pk, name)) if pk.host
                  else key_planes(getattr(pk, name), device, native))
           for name in _KEY_POINTS})
    return key if device is None else pk_to_device(key, device)


def key_planes(arrays, device, native=False) -> tuple:
    """A key's arrays as numpy (16-bit Montgomery limb planes of any integer
    type, bool masks: gnark_tpu's key or a key file's) -> this package's:
    int64 tensors and bool masks on ``device``, one copy an array; on the
    native route numpy as given (its MSMs read them on the host).  The one
    array-to-key step of ``proving_key_from_jax``,
    ``plonk.plonk_key_from_jax`` and ``key_io``'s readers."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        if native:
            out.append(a)
        elif a.dtype == bool:
            out.append(torch.from_numpy(a).to(device))
        else:
            out.append(torch.from_numpy(a.astype(np.int64)).to(device))
    return tuple(out)


# ---- prove ----------------------------------------------------------------------


def compute_h(domain: Domain, a, b, c, regular: bool = False):
    """Quotient h = (A*B - C)/Z on the device; bit-reversed coefficients.

    iFFT (DIF) -> coset FFT (DIT) -> pointwise (ab - c) / (g^n - 1) ->
    coset iFFT (DIF); Z is the constant g^n - 1 on the coset.  On the
    card every transform and the pointwise step are kernels
    (ops/ntt.py).  Montgomery planes in and out, as gnark_tpu's
    _compute_h; ``regular`` (prove's form): a, b and c in regular form
    and h returned in it, the to_mont of each input folded into its iFFT's
    pre-scale and h's from_mont into the coset iFFT's post-scale, the
    same limbs as from_mont(compute_h(to_mont(a), ...))."""
    q = domain.spec.modulus
    den_pl = domain.scalar(pow(pow(domain.coset_gen, domain.n, q) - 1, -1, q))

    def coset_evals(x):
        return domain.fft(domain.ifft(x, "DIF", regular_in=regular), "DIT",
                          coset=True)

    ae, be, ce = coset_evals(a), coset_evals(b), coset_evals(c)
    h = fr_pointwise(domain.spec, ae, be, ce, den_pl)
    return domain.ifft(h, "DIF", coset=True, regular_out=regular)


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


_sharded_domains = {}


def _sharded_domain_cache(spec, n, mesh, axis, device):
    from gnark_tpu_torch.parallel.sharded_ntt import ShardedDomain
    key = (spec.name, n, id(mesh), axis, str(device))
    if key not in _sharded_domains:
        _sharded_domains[key] = ShardedDomain(spec, n, mesh, axis, device)
    return _sharded_domains[key]


class _Phases:
    """Seconds per prover phase, synchronised with the device, into
    ``timings`` when the caller passes a dict and into
    ``profiling.last_profile`` as ``<scheme>.<phase>`` (gnark_tpu's
    ``profiling.phase`` names), which then holds the last prove's phases
    alone; a phase marked more than once in a prove adds up."""

    def __init__(self, timings, device, scheme="groth16"):
        self.device, self.scheme = device, scheme
        self.seconds = {} if timings is None else timings
        for key in [k for k in profiling.last_profile
                    if k.startswith(f"{scheme}.")]:
            del profiling.last_profile[key]
        self.t = time.perf_counter()

    def mark(self, name):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.t
        profiling.last_profile[f"{self.scheme}.{name}"] = self.seconds[name]
        self.t = now


def prove(cs, pk: ProvingKey, witness_values, rng=None, check: bool = True,
          timings: dict | None = None, mesh=None,
          mesh_axis: str = "shard") -> Proof:
    """witness_values: [public (no one-wire) | secret] ints.  Runs on the
    key's device (a host key on host ints and the native core);
    ``timings`` (a dict) receives per-phase seconds.

    mesh: a DeviceMesh (parallel/multihost.py's ``init_mesh``), every rank
    calling with the same arguments: the quotient runs the four-step NTT
    over ``mesh_axis`` when n % A == 0 and (n / A) % A == 0 (A its ranks),
    and the five MSMs split their points over it (parallel/sharded_msm;
    the NbTasks analog), except on the native route, whose MSMs stay on
    the native core.  Every rank returns the same proof."""
    curve = pk.curve
    q = curve.fr.modulus
    rnd = _sampler(rng)
    device = pk.device
    ph = _Phases(timings, device or torch.device("cpu"))

    sol = solve(cs, witness_values, check=check)
    ph.mark("solve")
    if pk.host:
        return _prove_host(cs, pk, sol, rnd, ph)
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

    abc = [limb_planes(name, 0, n) for name in ("a", "b", "c")]
    n_dev = 0 if mesh is None else mesh.get_group(mesh_axis).size()
    if mesh is not None and n % n_dev == 0 and (n // n_dev) % n_dev == 0:
        # the four-step NTT chain: both all_to_all stages of every
        # transform cross the mesh axis; the strided output is gathered
        # and permuted to the bit-reversed order the Z key points use
        sd = _sharded_domain_cache(curve.fr, n, mesh, mesh_axis, device)
        h_strided = sd.gather(sd.compute_h(
            *(sd.block(K.fr.to_mont(t)) for t in abc)))
        perm = torch.from_numpy(sd.strided_to_brev_perm().astype(np.int64))
        h = K.fr.from_mont(h_strided[:, perm.to(device)])
    else:
        # regular form in and out: the conversions ride on the first and
        # last passes of the quotient's transforms
        h = compute_h(_domain(curve.fr, n, device), *abc, regular=True)
    h = torch.cat([h, h.new_zeros(Ls, n_pad - n)], 1)
    ph.mark("compute_h")

    wires = limb_planes("values", 0, n_pad)
    priv = limb_planes("values", cs.nb_public, n_pad)
    r, s = rnd(q), rnd(q)
    native = native_route(curve)

    if mesh is not None and not native:
        from gnark_tpu_torch.parallel.sharded_msm import ShardedMSM
        plans = {G: ShardedMSM(G, mesh, mesh_axis, n_pad, Ls)
                 for G in (K.g1, K.g2)}

    def run(name, G, scalars):
        """One MSM: a Jacobian point on the device, or the native core's
        host affine point (None = infinity) over the key's numpy planes."""
        if not native:
            if mesh is not None:
                return plans[G](*getattr(pk, name), scalars)
            return msm(G, *getattr(pk, name), scalars)
        x, y, inf = getattr(pk, name)
        sc = scalars.cpu().numpy()
        k = min(sc.shape[1], x.shape[1])
        return native_msm(curve, x[:, :k], y[:, :k], inf[:k], sc[:, :k],
                          coords_mont=True,
                          beta=K.g2_beta if G is K.g2 else 0)

    out = {}
    for name, G, scalars in (("A", K.g1, wires), ("B1", K.g1, wires),
                             ("B2", K.g2, wires), ("K", K.g1, priv),
                             ("Z", K.g1, h)):
        out[name] = run(name, G, scalars)
        ph.mark(f"msm_{'g2' if G is K.g2 else 'g1'}_{name}")
    if not native:
        for name in out:
            G = K.g2 if name == "B2" else K.g1
            out[name] = _to_host(G, curve.host_g2 if name == "B2"
                                 else curve.host_g1, out[name])
        ph.mark("to_host")
    ar_p, bs1_p, bs2_p, krs_p, krsz_p = out.values()
    proof = _assemble(pk, ar_p, bs1_p, bs2_p, krs_p, krsz_p, r, s)
    ph.mark("assembly")
    return proof


def _assemble(pk, ar_p, bs1_p, bs2_p, krs_p, krsz_p, r, s) -> Proof:
    """The host assembly (small): fold in the blinding terms r, s."""
    curve = pk.curve
    q = curve.fr.modulus
    host1, host2 = curve.host_g1, curve.host_g2
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
    return Proof(ar=ar, bs=bs, krs=krs)


def _prove_host(cs, pk, sol, rnd, ph):
    """A host key's prove (gnark_tpu's ``_prove_host``): the quotient on
    host ints, the MSMs on the native core (G2 over fp4 by host scalar
    multiplications), the same blinding draws."""
    curve = pk.curve
    q = curve.fr.modulus
    n = pk.domain_n
    spec = curve.fr
    omega = spec.root_of_unity(n)
    g = spec.multiplicative_generator % q

    def pad(v):
        return [x % q for x in v] + [0] * (n - len(v))

    def coset_evals(vals):
        coeffs = _host_ntt(pad(vals), omega, q, inverse=True)
        shifted = [c * pow(g, i, q) % q for i, c in enumerate(coeffs)]
        return _host_ntt(shifted, omega, q)

    ae, be, ce = (coset_evals(v) for v in (sol.a, sol.b, sol.c))
    den = pow(pow(g, n, q) - 1, -1, q)
    he = [(a * b - c) % q * den % q for a, b, c in zip(ae, be, ce)]
    h_shift = _host_ntt(he, omega, q, inverse=True)
    ginv = pow(g, -1, q)
    h = [c * pow(ginv, i, q) % q for i, c in enumerate(h_shift)]
    h_brev = [h[i] for i in bit_reverse_perm(n)]
    ph.mark("compute_h")
    K = _Groups(curve)

    def hmsm(points, scalars, g2=False):
        k = min(len(points), len(scalars))
        if g2 and curve.g2_tower_k == 4:
            host2, acc = curve.host_g2, None
            for P, v in zip(points[:k], scalars[:k]):
                if P is not None and v % q:
                    acc = host2.add(acc, host2.scalar_mul(P, v % q))
            return acc
        zero = K.g2_zero if g2 else 0
        pts = [(zero, zero) if P is None else P for P in points[:k]]
        beta = K.g2_beta if g2 else 0

        def coords(i):
            vals = [P[i] for P in pts]
            if beta:
                return np.concatenate([ints_to_limbs([v[j] for v in vals],
                                                     curve.fp.L)
                                       for j in range(2)])
            return ints_to_limbs(vals, curve.fp.L)

        inf = np.array([P is None or v % q == 0
                        for P, v in zip(points[:k], scalars[:k])])
        sc = ints_to_limbs([v % q for v in scalars[:k]], curve.fr.L)
        return native_msm(curve, coords(0), coords(1), inf, sc, beta=beta)

    wires = sol.values
    r, s = rnd(q), rnd(q)
    ar_p = hmsm(pk.A, wires)
    bs1_p = hmsm(pk.B1, wires)
    bs2_p = hmsm(pk.B2, wires, g2=True)
    krs_p = hmsm(pk.K, wires[cs.nb_public:])
    krsz_p = hmsm(pk.Z, h_brev)
    ph.mark("msm")
    proof = _assemble(pk, ar_p, bs1_p, bs2_p, krs_p, krsz_p, r, s)
    ph.mark("assembly")
    return proof


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
