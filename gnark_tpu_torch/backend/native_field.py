"""ctypes bridge to the native field-vector helpers (solver_core.cpp):
powers, batch inversion, QAP accumulation, 3-term linear combination.

These are the host-side O(n) passes of Groth16 setup (setup.go:278-355)
and the PLONK prover's coefficient bookkeeping, moved off python ints
(~1-3us/op) onto the C Montgomery core (~60ns/op).

All values cross the boundary as [n, N] uint64 little-endian limb rows,
regular form; `Nat.planes`/`Nat.from_planes` convert to/from the 16-bit
limb-plane layout shared with np_field and the device kernels.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _nlimbs64(q: int) -> int:
    n = -(-q.bit_length() // 64)
    for cand in (1, 2, 3, 4, 5, 6, 8, 10, 12):
        if cand >= n:
            return cand
    raise ValueError(f"modulus too wide: {q.bit_length()} bits")


class Nat:
    """Native field-vector ops for one modulus."""

    def __init__(self, q: int):
        from gnark_tpu_torch.native import solver_lib
        self.lib = solver_lib()
        self.q = q
        self.N = _nlimbs64(q)
        R = pow(2, 64 * self.N, q)
        self.R = R
        self._mod = self.pack([q])
        self._r2 = self.pack([R * R % q])
        self._one = self.pack([R % q])

    # -- conversions -----------------------------------------------------------

    def pack(self, ints) -> np.ndarray:
        buf = b"".join(int(v).to_bytes(8 * self.N, "little") for v in ints)
        return np.frombuffer(buf, dtype="<u8").reshape(len(ints), self.N).copy()

    def pack_mont(self, ints) -> np.ndarray:
        q, R = self.q, self.R
        return self.pack([int(v) % q * R % q for v in ints])

    def unpack(self, arr) -> list:
        raw = np.ascontiguousarray(arr, dtype="<u8").tobytes()
        nb = 8 * arr.shape[1]
        return [int.from_bytes(raw[i * nb:(i + 1) * nb], "little")
                for i in range(arr.shape[0])]

    def planes(self, arr64, L16) -> np.ndarray:
        """[n, N] u64 -> [L16, n] u64 16-bit limb planes (np_field layout)."""
        import sys
        assert sys.byteorder == "little"
        n, N = arr64.shape
        u16 = np.ascontiguousarray(arr64).view(np.uint16).reshape(n, 4 * N)
        k = min(L16, 4 * N)
        if k == L16:
            return u16[:, :k].T.astype(np.uint64)
        out = np.zeros((L16, n), np.uint64)
        out[:k] = u16[:, :k].T
        return out

    def _hdr(self):
        return (ctypes.c_int(self.N), self._ptr(self._mod),
                self._ptr(self._r2), self._ptr(self._one))

    @staticmethod
    def _ptr(a):
        return a.ctypes.data_as(_U64P)

    # -- vector ops -------------------------------------------------------------

    def powers(self, base: int, n: int, start: int = 1) -> np.ndarray:
        """[start, start*base, ..., start*base^(n-1)] as [n, N] regular."""
        out = np.zeros((n, self.N), np.uint64)
        base_m = self.pack_mont([base])
        st = self.pack([start])
        rc = self.lib.gnark_powers(*self._hdr(), ctypes.c_int64(n),
                                   self._ptr(base_m), self._ptr(st),
                                   self._ptr(out))
        assert rc == 0
        return out

    def batch_inv(self, vals: np.ndarray) -> np.ndarray:
        out = np.zeros_like(vals)
        rc = self.lib.gnark_batch_inv(*self._hdr(),
                                      ctypes.c_int64(vals.shape[0]),
                                      self._ptr(vals), self._ptr(out))
        assert rc == 0
        return out

    def qap_accumulate(self, mat, coeffs_mont: np.ndarray,
                       lag: np.ndarray, nw: int) -> np.ndarray:
        """CSR matrix + per-constraint Lagrange values -> per-wire sums."""
        out = np.zeros((nw, self.N), np.uint64)
        indptr = np.ascontiguousarray(np.asarray(mat.indptr), np.int64)
        wires = np.ascontiguousarray(np.asarray(mat.wires), np.int64)
        cids = np.ascontiguousarray(np.asarray(mat.coeffs), np.int64)
        m = len(indptr) - 1
        rc = self.lib.gnark_qap_accumulate(
            *self._hdr(), ctypes.c_int64(m),
            indptr.ctypes.data_as(_I64P), wires.ctypes.data_as(_I64P),
            cids.ctypes.data_as(_I64P),
            self._ptr(coeffs_mont), self._ptr(lag), self._ptr(out))
        assert rc == 0
        return out

    def vecmul(self, a: np.ndarray, b) -> np.ndarray:
        """Elementwise a[i]*b[i] (or a[i]*b if b is a scalar int)."""
        out = np.zeros_like(a)
        if isinstance(b, int):
            barr, stride = self.pack([b % self.q]), 0
        else:
            barr, stride = np.ascontiguousarray(b), 1
        rc = self.lib.gnark_vecmul(
            *self._hdr(), ctypes.c_int64(a.shape[0]),
            self._ptr(np.ascontiguousarray(a)), self._ptr(barr),
            ctypes.c_int64(stride), self._ptr(out))
        assert rc == 0
        return out

    def vecadd(self, a: np.ndarray, b) -> np.ndarray:
        out = np.zeros_like(a)
        if isinstance(b, int):
            barr, stride = self.pack([b % self.q]), 0
        else:
            barr, stride = np.ascontiguousarray(b), 1
        rc = self.lib.gnark_vecadd(
            *self._hdr(), ctypes.c_int64(a.shape[0]),
            self._ptr(np.ascontiguousarray(a)), self._ptr(barr),
            ctypes.c_int64(stride), self._ptr(out))
        assert rc == 0
        return out

    def prefix_mul(self, vals: np.ndarray, exclusive=False) -> np.ndarray:
        out = np.zeros_like(vals)
        rc = self.lib.gnark_prefix_mul(
            *self._hdr(), ctypes.c_int64(vals.shape[0]),
            self._ptr(np.ascontiguousarray(vals)), self._ptr(out),
            ctypes.c_int(1 if exclusive else 0))
        assert rc == 0
        return out

    def synth_div(self, coeffs: np.ndarray, z: int):
        """p(X)/(X - z) -> (quotient [n-1, N], value int)."""
        n = coeffs.shape[0]
        quotient = np.zeros((max(n - 1, 1), self.N), np.uint64)
        value = np.zeros((1, self.N), np.uint64)
        rc = self.lib.gnark_synth_div(
            *self._hdr(), ctypes.c_int64(n),
            self._ptr(np.ascontiguousarray(coeffs)), self._ptr(self.pack([z])),
            self._ptr(quotient), self._ptr(value))
        assert rc == 0
        return quotient, self.unpack(value)[0]

    def horner(self, coeffs: np.ndarray, z: int) -> int:
        return self.synth_div(coeffs, z)[1]

    def lincomb3(self, A, B, C, ka: int, kb: int, s: int) -> np.ndarray:
        """(ka*A + kb*B + C) * s elementwise over [n, N] regular arrays."""
        out = np.zeros_like(A)
        rc = self.lib.gnark_lincomb3(
            *self._hdr(), ctypes.c_int64(A.shape[0]),
            self._ptr(np.ascontiguousarray(A)),
            self._ptr(np.ascontiguousarray(B)),
            self._ptr(np.ascontiguousarray(C)),
            self._ptr(self.pack_mont([ka])), self._ptr(self.pack_mont([kb])),
            self._ptr(self.pack_mont([s])), self._ptr(out))
        assert rc == 0
        return out


@functools.lru_cache(maxsize=None)
def nat_for(q: int) -> Nat:
    return Nat(q)


def _msm_window(n: int, total_bits: int) -> int:
    """Window width minimizing nwin*(n*A + 2*2^c*J) mmul-units for the
    batch-affine core (A ~ 6.5 mmuls per leaf add incl. the batched-
    inversion share, J ~ 16 per Jacobian bucket op).  Measured at
    n = 2^17 / 377-bit scalars: c=12 -> 13.8 s vs the old fixed c=10's
    21.3 s (docs/PERF.md)."""
    def cost(cc):
        nwin = -(-total_bits // cc)
        return nwin * (n * 6.5 + 2 * (1 << cc) * 16)
    return min(range(4, 17), key=cost)


def _split_rows(a, parts):
    """[n, parts * N] rows -> ``parts`` int lists (one per coefficient)."""
    return [a[:, i * (a.shape[1] // parts):(i + 1) * (a.shape[1] // parts)]
            for i in range(parts)]


def _pack_el(nat_p, v, beta):
    """One fp (beta = 0) or fp2 element -> [1, W] u64 words."""
    if beta:
        return np.concatenate([nat_p.pack([v[0]]), nat_p.pack([v[1]])], 1)
    return nat_p.pack([v])


def native_msm(curve, xs_planes, ys_planes, inf_mask, scalars_planes,
               c: int | None = None, coords_mont: bool = False,
               beta: int = 0):
    """Host Pippenger MSM on the C core for wide-field curves.

    xs/ys: [Lp16, n] uint32/uint64 16-bit limb planes (regular form), or
    with ``beta`` != 0 points over fp2 = fp[u]/(u^2 - beta): [2 Lp16, n],
    c0's planes over c1's; scalars: [Lr16, n] planes (regular form).
    Returns a host affine point or None.  Reference: gnark-crypto MultiExp
    (bucket method) -- this is the CPU path the 16-bit limb layout can't
    beat at 761-bit field widths.  Bucket accumulation is batch-affine (a
    pairing tree with one shared inversion per round — msm_core.cpp);
    GLV is deliberately NOT used here: halving the scalar bits doubles
    the point count, so the dominant bits*n/c leaf term is invariant
    (it only pays for single scalar-mul, where gnark-crypto uses it).
    """
    import sys
    assert sys.byteorder == "little"
    if c is None:
        c = _msm_window(xs_planes.shape[1], curve.fr.L * 16)
    from gnark_tpu_torch.native import solver_lib
    lib = solver_lib()
    p = curve.fp.modulus
    nat_p = nat_for(p)
    nat_r = nat_for(curve.fr.modulus)
    n = xs_planes.shape[1]
    parts = 2 if beta else 1

    def planes_to_rows(planes, N):
        a = np.ascontiguousarray(
            np.asarray(planes, np.uint16).T)          # [n, L16]
        L16 = a.shape[1]
        pad = 4 * N - L16
        if pad:
            a = np.concatenate(
                [a, np.zeros((n, pad), np.uint16)], axis=1)
        return np.ascontiguousarray(a).view(np.uint64).reshape(n, N)

    def coords(planes):
        L16 = planes.shape[0] // parts
        return np.ascontiguousarray(np.concatenate(
            [planes_to_rows(planes[i * L16:(i + 1) * L16], nat_p.N)
             for i in range(parts)], 1))

    xs64, ys64 = coords(xs_planes), coords(ys_planes)
    sc64 = planes_to_rows(scalars_planes, nat_r.N)
    infu = np.ascontiguousarray(np.asarray(inf_mask, np.uint8))
    out = np.zeros((3, parts * nat_p.N), np.uint64)
    rc = lib.gnark_msm(
        ctypes.c_int(nat_p.N), ctypes.c_int(beta), nat_p._ptr(nat_p._mod),
        nat_p._ptr(nat_p._r2), nat_p._ptr(nat_p._one), ctypes.c_int64(n),
        nat_p._ptr(xs64), nat_p._ptr(ys64),
        infu.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(nat_r.N), nat_r._ptr(sc64),
        ctypes.c_int(c), ctypes.c_int(1 if coords_mont else 0),
        nat_p._ptr(out))
    assert rc == 0, rc
    X, Y, Z = (list(zip(*(nat_p.unpack(h) for h in _split_rows(
        out[i:i + 1], parts)))) [0] for i in range(3))
    if not beta:
        X, Y, Z = X[0], Y[0], Z[0]
        if Z == 0:
            return None
        zinv = pow(Z, -1, p)
        z2 = zinv * zinv % p
        return (X * z2 % p, Y * z2 % p * zinv % p)
    from gnark_tpu_torch.curves.host import HostFp2
    F = HostFp2(p, beta)
    if F.is_zero(Z):
        return None
    zinv = F.inv(Z)
    z2 = F.sqr(zinv)
    return (F.mul(X, z2), F.mul(Y, F.mul(z2, zinv)))


def native_fixed_base_affine(curve, scalars_ints, base, beta: int = 0):
    """Batch scalar*base -> list of host affine points (None = inf); with
    ``beta`` != 0 over fp2 (see native_msm).

    Modulus-generic C-core route for the host=True setup/SRS paths
    (the python scalar-mul loop is far slower)."""
    q = curve.fr.modulus
    nat_r = nat_for(q)
    nat_p = nat_for(curve.fp.modulus)
    rows = nat_r.pack([s % q for s in scalars_ints])
    x_pl, y_pl, inf = native_fixed_base(curve, rows, base, beta=beta)
    # coords come back in Montgomery form: one plain vecmul by R^{-1}
    rinv = pow(1 << (64 * nat_p.N), -1, curve.fp.modulus)
    parts = 2 if beta else 1

    def to_ints(planes):
        L16 = planes.shape[0] // parts
        cols = []
        for i in range(parts):
            a = np.ascontiguousarray(
                np.asarray(planes[i * L16:(i + 1) * L16], np.uint16).T)
            pad = 4 * nat_p.N - a.shape[1]
            if pad:
                a = np.concatenate(
                    [a, np.zeros((a.shape[0], pad), np.uint16)], axis=1)
            rows64 = np.ascontiguousarray(a).view(np.uint64).reshape(
                a.shape[0], nat_p.N)
            cols.append(nat_p.unpack(nat_p.vecmul(rows64, rinv)))
        return cols[0] if parts == 1 else list(zip(*cols))

    xs, ys = to_ints(x_pl), to_ints(y_pl)
    return [None if inf[i] else (xs[i], ys[i])
            for i in range(len(scalars_ints))]


def native_fixed_base(curve, scalars_rows, base, c: int = 8, beta: int = 0):
    """Batch scalar*base on the C core (wide-field setup path).

    scalars_rows: [n, Nr] u64 regular; base: host affine (x, y), ints or,
    with ``beta`` != 0, fp2 pairs.  Returns (x_planes, y_planes, inf) with
    coords in MONTGOMERY form, matching the device fixed-base output
    layout (uint32 planes; fp2: c0's planes over c1's).
    """
    from gnark_tpu_torch.native import solver_lib
    lib = solver_lib()
    nat_p = nat_for(curve.fp.modulus)
    nat_r = nat_for(curve.fr.modulus)
    parts = 2 if beta else 1
    W = parts * nat_p.N
    n = scalars_rows.shape[0]
    out_x = np.zeros((n, W), np.uint64)
    out_y = np.zeros((n, W), np.uint64)
    out_inf = np.zeros(n, np.uint8)
    rc = lib.gnark_fixed_base(
        ctypes.c_int(nat_p.N), ctypes.c_int(beta), nat_p._ptr(nat_p._mod),
        nat_p._ptr(nat_p._r2), nat_p._ptr(nat_p._one), ctypes.c_int64(n),
        ctypes.c_int(nat_r.N),
        nat_r._ptr(np.ascontiguousarray(scalars_rows)),
        nat_p._ptr(_pack_el(nat_p, base[0], beta)),
        nat_p._ptr(_pack_el(nat_p, base[1], beta)),
        ctypes.c_int(c), nat_p._ptr(out_x), nat_p._ptr(out_y),
        out_inf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    assert rc == 0, rc
    L16 = curve.fp.L

    def planes(rows):
        return np.concatenate([nat_p.planes(np.ascontiguousarray(h), L16)
                               for h in _split_rows(rows, parts)]
                              ).astype(np.uint32)

    return planes(out_x), planes(out_y), out_inf.astype(bool)
