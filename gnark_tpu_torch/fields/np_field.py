"""Vectorized host field arithmetic: Montgomery limb planes in numpy.

The witness solver's host-side analog of ops/limbs.py: element batches are
``uint64[L, n]`` (16-bit limbs in uint64 lanes, LSB first).  uint64 lanes
give enough headroom that full schoolbook product columns AND long
segment-sums accumulate lazily without carry management.

This is the vectorization backbone of the leveled witness solver
(SURVEY §2.8 P2; reference parallelSolve internal/backend/bn254/cs/
r1cs.go:127-238) and of the setup/PLONK host passes: it replaces
per-element python-int mulmods with whole-level numpy sweeps.
"""

from __future__ import annotations

import functools

import numpy as np

from gnark_tpu_torch.fields.spec import FieldSpec, MASK, W

_U64 = np.uint64


class NpField:
    """Prime-field ops on numpy uint64 limb planes for one FieldSpec.

    Conventions:
      * "regular" = plain residue; "mont" = residue * R mod p.
      * mmul(a, b) is a Montgomery product a*b*R^{-1} mod p: multiplying a
        regular value by a mont-form value yields their regular product —
        the solver keeps wire values regular and coefficients mont-form so
        every term product is ONE mmul.
    """

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.p = spec.modulus
        self.L = spec.L
        self._p = np.array(
            [(self.p >> (W * i)) & MASK for i in range(self.L)], _U64)
        pinv = (-pow(self.p, -1, 1 << (W * self.L))) % (1 << (W * self.L))
        self._pinv = np.array(
            [(pinv >> (W * i)) & MASK for i in range(self.L)], _U64)
        self._r2 = self.pack([spec.R2])
        self._one_mont = self.pack([spec.R % self.p])

    # -- host int <-> limb planes --------------------------------------------

    def pack(self, ints, mont: bool = False) -> np.ndarray:
        """list[int] -> [L, n] uint64 limb planes (regular form unless mont)."""
        p = self.p
        if mont:
            R = self.spec.R
            ints = [v % p * R % p for v in ints]
        else:
            ints = [v % p for v in ints]
        n = len(ints)
        out = np.empty((self.L, n), _U64)
        # bulk path: fixed-width big-endian bytes -> uint16 limbs
        nb = 2 * self.L
        buf = b"".join(v.to_bytes(nb, "little") for v in ints)
        arr = np.frombuffer(buf, dtype="<u2").reshape(n, self.L)
        out[:] = arr.T.astype(_U64)
        return out

    def unpack(self, arr: np.ndarray) -> list:
        """[L, n] canonical limb planes -> list[int]."""
        a = np.ascontiguousarray(arr.T.astype("<u2"))  # [n, L]
        raw = a.tobytes()
        nb = 2 * self.L
        return [int.from_bytes(raw[i * nb:(i + 1) * nb], "little")
                for i in range(a.shape[0])]

    def zeros(self, n: int) -> np.ndarray:
        return np.zeros((self.L, n), _U64)

    # -- canonicalization ------------------------------------------------------

    def _propagate(self, cols: np.ndarray, L_out: int) -> np.ndarray:
        """Carry-propagate lazy uint64 columns into canonical 16-bit limbs
        of length L_out (any residual carry spills into extra rows)."""
        n = cols.shape[1:]
        out = np.zeros((L_out,) + n, _U64)
        carry = np.zeros(n, _U64)
        m = np.uint64(MASK)
        w = np.uint64(W)
        for i in range(L_out):
            v = (cols[i] if i < cols.shape[0] else 0) + carry
            out[i] = v & m
            carry = v >> w
        return out, carry

    def _cond_sub_p(self, x: np.ndarray) -> np.ndarray:
        L = self.L
        d = x.astype(np.int64) - self._p.reshape(L, *([1] * (x.ndim - 1))).astype(np.int64)
        # sequential borrow propagation
        borrow = np.zeros(x.shape[1:], np.int64)
        out = np.empty_like(x)
        for i in range(L):
            v = d[i] - borrow
            out[i] = (v & np.int64(MASK)).astype(_U64)
            borrow = (v < 0).astype(np.int64)
        return np.where(borrow == 0, out, x)

    # -- ring ops ----------------------------------------------------------------

    def add(self, a, b):
        s, _ = self._propagate(a + b, self.L)
        return self._cond_sub_p(s)

    def sub(self, a, b):
        a, b = np.broadcast_arrays(a, b)
        d = a.astype(np.int64) - b.astype(np.int64)
        borrow = np.zeros(a.shape[1:], np.int64)
        out = np.empty_like(a)
        for i in range(self.L):
            v = d[i] - borrow
            out[i] = (v & np.int64(MASK)).astype(_U64)
            borrow = (v < 0).astype(np.int64)
        # add p back where we borrowed
        plus, _ = self._propagate(
            out + self._p.reshape(self.L, *([1] * (a.ndim - 1))), self.L)
        return np.where(borrow == 0, out, plus)

    def neg(self, a):
        z = self.is_zero(a)
        pb = np.broadcast_to(
            self._p.reshape(self.L, *([1] * (a.ndim - 1))), a.shape)
        return np.where(z, a, self.sub(pb, a))

    def is_zero(self, a):
        return np.all(a == 0, axis=0)

    def _conv(self, a, b_limbs):
        """Full product columns [2L, n] of canonical a against canonical
        b (either [L, n] planes or an [L] constant)."""
        L = self.L
        n = a.shape[1:]
        t = np.zeros((2 * L,) + n, _U64)
        if b_limbs.ndim == 1:
            for i in range(L):
                bi = b_limbs[i]
                if bi:
                    t[i:i + L] += a * bi
        else:
            for i in range(L):
                t[i:i + L] += a[i] * b_limbs
        return t

    def _redc_wide(self, t):
        """t (wide columns, value < p*R) -> t * R^{-1} mod p, canonical."""
        L = self.L
        t_low, c_low = self._propagate(t[:L], L)
        m_cols = self._conv(t_low, self._pinv)
        m, _ = self._propagate(m_cols[:L], L)     # m mod R
        mp = self._conv(m, self._p)
        _, carry = self._propagate(t_low + mp[:L], L)
        high = t[L:2 * L].copy() if t.shape[0] > L else np.zeros_like(t_low)
        if high.shape[0] < L:
            pad = np.zeros((L - high.shape[0],) + t.shape[1:], _U64)
            high = np.concatenate([high, pad], axis=0)
        high = high + mp[L:2 * L]
        high[0] = high[0] + c_low + carry
        res, _ = self._propagate(high, L)
        return self._cond_sub_p(res)

    def mmul(self, a, b):
        """Montgomery product (a * b * R^{-1} mod p) of canonical inputs."""
        if b.ndim == 1:
            t = self._conv(a, b)
        else:
            a, b = np.broadcast_arrays(a, b)
            t = self._conv(a, b)
        return self._redc_wide(t)

    def to_mont(self, a):
        return self.mmul(a, self._r2[:, 0])

    def from_mont(self, a):
        one = np.zeros((self.L,), _U64)
        one[0] = 1
        return self.mmul(a, one)

    def reduce_sum_lazy(self, lazy):
        """Lazy uint64 limb sums (limbs < 2^48) -> canonical mod-p values.

        Used after np.add.reduceat row sums: value < K*p for K terms.
        """
        L = self.L
        ext, carry = self._propagate(lazy, L + 3)
        assert not carry.any(), "segment sum overflowed the wide window"
        wide = np.zeros((2 * L,) + ext.shape[1:], _U64)
        wide[:L + 3] = ext
        u = self._redc_wide(wide)                  # sum * R^{-1} mod p
        return self.mmul(u, self._r2[:, 0])        # back to regular

    def _scan_mmul(self, a, reverse: bool = False):
        """Inclusive Hillis-Steele product scan along axis 1 (log-depth,
        fully vectorized; identity = mont one on rolled-in lanes)."""
        L, n = a.shape
        x = a.copy()
        one = self._one_mont
        idx = np.arange(n)
        shift = 1
        while shift < n:
            if reverse:
                rolled = np.roll(x, -shift, axis=1)
                valid = idx < n - shift
            else:
                rolled = np.roll(x, shift, axis=1)
                valid = idx >= shift
            rolled = np.where(valid, rolled, one)
            x = self.mmul(x, rolled)
            shift *= 2
        return x

    def batch_inv_mont(self, a_mont):
        """Montgomery-form batch inversion along axis 1; zeros -> zeros.

        Log-depth scans (2 log n vectorized mmuls) + ONE host inversion —
        the Montgomery trick shaped for numpy (fr.BatchInvert analog).
        """
        L, n = a_mont.shape
        zero = self.is_zero(a_mont)
        one = np.broadcast_to(self._one_mont, (L, n))
        safe = np.where(zero, one, a_mont)
        prefix = self._scan_mmul(safe)
        suffix = self._scan_mmul(safe, reverse=True)
        total = self.unpack(self.from_mont(prefix[:, n - 1:n]))[0]
        inv_total = pow(total, -1, self.p) if total else 0
        inv_t = self.pack([inv_total], mont=True)
        # inv_i = prefix_{i-1} * suffix_{i+1} * inv_total  (mont domain:
        # three mont values multiply to a mont value with two mmuls)
        pre = np.concatenate([one[:, :1], prefix[:, :-1]], axis=1)
        suf = np.concatenate([suffix[:, 1:], one[:, :1]], axis=1)
        out = self.mmul(self.mmul(pre, suf), np.broadcast_to(inv_t, (L, n)))
        return np.where(zero, np.zeros_like(a_mont), out)


@functools.lru_cache(maxsize=None)
def np_field(spec: FieldSpec) -> NpField:
    return NpField(spec)
