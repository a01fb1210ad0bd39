"""KZG polynomial commitments over the device MSM (counterpart of
gnark_tpu/backend/kzg.py), over the six curves of ``curves``.

Reference surface (SURVEY §2.9): kzg.{NewSRS, Commit, Open,
BatchOpenSinglePoint, FoldProof, BatchVerifyMultiPoints} called from the
PLONK backend.

Commit = MSM over the SRS G1 powers through ``ops.msm.msm`` (the CUDA
kernels when the SRS lives on a card); quotient-poly synthetic division is
on the native core (O(n) mulmods — cheap beside the MSM); pairing checks
are host-side.  ``host=True`` keeps everything off the device: the SRS by
the native fixed-base, commits by the native Pippenger.  Commits over a
base field of 24 or more 16-bit limbs (``groth16.native_route``) take the
native Pippenger too, as gnark_tpu's do (kzg.py:124).
"""

from __future__ import annotations

import dataclasses
import functools
import secrets

import numpy as np
import torch

from gnark_tpu_torch.backend.groth16 import (
    _Groups, _device, _to_host, native_route)
from gnark_tpu_torch.backend.native_field import (
    nat_for, native_fixed_base_affine, native_msm)
from gnark_tpu_torch.curves.pairing import pairing_for
from gnark_tpu_torch.fields.spec import W
from gnark_tpu_torch.ops.ec import points_to_device
from gnark_tpu_torch.ops.fixed_base import FixedBaseTable
from gnark_tpu_torch.ops.limbs import ints_to_limbs
from gnark_tpu_torch.ops.msm import msm


@dataclasses.dataclass
class SRS:
    """Structured reference string: [tau^i]G1 (host affine) + [tau]G2.
    ``device`` is where ``device_g1`` lives (None: a host-only SRS)."""
    curve: object
    g1: list          # host affine points, g1[i] = tau^i * G1
    g2_gen: tuple
    g2_tau: tuple
    device: object = None

    @functools.cached_property
    def device_g1(self):
        """(x, y, inf): affine Montgomery limb planes [L, size] and a bool
        mask on ``device``."""
        if self.device is None:
            raise ValueError("this SRS is host-only: it has no device")
        return points_to_device(_Groups(self.curve).g1, self.g1, 0,
                                self.device)

    @functools.cached_property
    def host_planes(self):
        """Regular-form 16-bit limb planes of g1 as numpy (the native
        commit path; building these touches no device)."""
        L = self.curve.fp.L
        zero = (0, 0)
        xs = ints_to_limbs([(p or zero)[0] for p in self.g1], L)
        ys = ints_to_limbs([(p or zero)[1] for p in self.g1], L)
        inf = np.array([p is None for p in self.g1], bool)
        return xs, ys, inf


def new_srs(curve, size: int, tau: int | None = None, rng=None,
            host: bool = False, *, device="cuda") -> SRS:
    """Deterministic test SRS (tau fixed or rng-sampled) — the analog of
    the reference's cached test SRS (test/kzg_srs.go:35).  A production SRS
    would come from a ceremony file.  The powers of tau go through the
    fixed-base table on ``device`` (the card unless the caller names
    another), or through the native core with ``host=True`` and, for
    an SRS still held on ``device``, over a base field of 24 or more
    16-bit limbs (``groth16.native_route``, the cut of gnark_tpu's
    commit, kzg.py:124): the fixed-base kernel has no kind there."""
    q = curve.fr.modulus
    if tau is None:
        tau = (rng.randrange(q) if rng is not None else secrets.randbelow(q))
    powers, t = [], 1
    for _ in range(size):
        powers.append(t)
        t = t * tau % q
    g2_tau = curve.host_g2.scalar_mul(curve.g2_gen, tau)
    if host or native_route(curve):
        g1 = native_fixed_base_affine(curve, powers, curve.g1_gen)
        return SRS(curve=curve, g1=g1, g2_gen=curve.g2_gen, g2_tau=g2_tau,
                   device=None if host else _device(device))
    device = _device(device)
    K = _Groups(curve)
    fb = FixedBaseTable(K.g1, curve.host_g1, curve.g1_gen, curve.fr.L * W,
                        device)
    sc = torch.from_numpy(ints_to_limbs(powers, curve.fr.L).astype(
        np.int64)).to(device)
    x, y, inf = K.g1.to_affine(fb(sc))
    xs, ys, infs = K.g1.F.unpack(x), K.g1.F.unpack(y), inf.cpu().tolist()
    g1 = [None if infs[i] else (xs[i], ys[i]) for i in range(size)]
    srs = SRS(curve=curve, g1=g1, g2_gen=curve.g2_gen, g2_tau=g2_tau,
              device=device)
    srs.device_g1 = (x, y, inf)      # already there: no second upload
    return srs


def commit_device(srs: SRS, coeffs_regular):
    """coeffs: [Ls, k] regular-form limb planes on the SRS's device -> one
    Jacobian point there.

    Degree bound is enforced, never silently truncated (a quotient longer
    than the SRS would otherwise commit to the wrong polynomial)."""
    k = coeffs_regular.shape[-1]
    if k > len(srs.g1):
        raise ValueError(
            f"polynomial has {k} coefficients but SRS only supports "
            f"{len(srs.g1)} (kzg.Commit degree check, kzg.go ErrInvalidPolynomialSize)")
    xs, ys, inf = srs.device_g1
    return msm(_Groups(srs.curve).g1, xs[:, :k].contiguous(),
               ys[:, :k].contiguous(), inf[:k].contiguous(), coeffs_regular)


def commit(srs: SRS, coeffs: list, host: bool = False):
    """Host int coefficients -> host affine commitment point."""
    if not coeffs:
        return None
    curve = srs.curve
    q = curve.fr.modulus
    # trim trailing zero coefficients (degree may be lower than the list
    # length), then enforce the SRS degree bound on what remains
    top = len(coeffs)
    while top > 1 and coeffs[top - 1] % q == 0:
        top -= 1
    coeffs = coeffs[:top]
    if len(coeffs) > len(srs.g1):
        raise ValueError(
            f"polynomial degree {len(coeffs) - 1} exceeds SRS size {len(srs.g1)}")
    sc = ints_to_limbs(coeffs, curve.fr.L, q=q)
    if host or native_route(curve):
        # native C Pippenger, device-free
        k = len(coeffs)
        xs, ys, inf = srs.host_planes
        return native_msm(curve, xs[:, :k], ys[:, :k], inf[:k], sc,
                          coords_mont=False)
    K = _Groups(curve)
    arr = torch.from_numpy(sc.astype(np.int64)).to(srs.device)
    return _to_host(K.g1, curve.host_g1, commit_device(srs, arr))


def open_poly(srs: SRS, coeffs: list, z: int, host: bool = False):
    """-> (value p(z), proof [q(tau)]G1) with q = (p - p(z))/(X - z),
    by synthetic division on the native core."""
    q = srs.curve.fr.modulus
    nat = nat_for(q)
    quot64, value = nat.synth_div(nat.pack([c % q for c in coeffs]), z % q)
    return value, commit(srs, nat.unpack(quot64), host=host)


def fold_polys(polys: list, gamma: int, q: int) -> list:
    """sum gamma^i * p_i as one coefficient list."""
    nat = nat_for(q)
    L = max(len(p) for p in polys)
    out = np.zeros((L, nat.N), np.uint64)
    g = 1
    for p in polys:
        arr = nat.pack(list(p) + [0] * (L - len(p)))
        out = nat.vecadd(out, nat.vecmul(arr, g))
        g = g * gamma % q
    return nat.unpack(out)


def batch_open_single_point(srs: SRS, polys: list, z: int, gamma: int,
                            host: bool = False):
    """-> (values [p_i(z)], proof of the gamma-folded poly at z)."""
    q = srs.curve.fr.modulus
    nat = nat_for(q)
    values = [nat.horner(nat.pack(p), z % q) for p in polys]
    _, proof = open_poly(srs, fold_polys(polys, gamma, q), z, host=host)
    return values, proof


def verify_opening(srs: SRS, commitment, z: int, value: int, proof) -> bool:
    """e(W, [tau]2 - z[1]2) == e(C - v[1]1, [1]2), as a 2-pair product."""
    return batch_verify_multi_points(
        srs, [commitment], [z], [value], [proof], u=1)


def batch_verify_multi_points(srs: SRS, commitments, points, values, proofs,
                              u: int | None = None) -> bool:
    """Random-linear-combination batch verification of openings at
    (possibly distinct) points (kzg.BatchVerifyMultiPoints analog):

      e(sum u^i W_i, [tau]2) == e(sum u^i (z_i W_i + C_i - v_i G), [1]2)
    """
    curve = srs.curve
    q = curve.fr.modulus
    host1 = curve.host_g1
    if u is None:
        u = 1 + secrets.randbelow(q - 1)
    w_acc = None
    rhs_acc = None
    ui = 1
    for C, z, v, W_i in zip(commitments, points, values, proofs):
        w_acc = host1.add(w_acc, host1.scalar_mul(W_i, ui))
        term = host1.scalar_mul(W_i, z % q)
        term = host1.add(term, C)
        term = host1.add(term, host1.scalar_mul(host1.neg(curve.g1_gen), v % q))
        rhs_acc = host1.add(rhs_acc, host1.scalar_mul(term, ui))
        ui = ui * u % q
    pr = pairing_for(curve)
    return pr.pairing_check([
        (w_acc, srs.g2_tau),
        (host1.neg(rhs_acc), srs.g2_gen),
    ])
