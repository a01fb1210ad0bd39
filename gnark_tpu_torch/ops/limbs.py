"""Montgomery limb-plane field arithmetic in plain PyTorch.

Counterpart of gnark_tpu/ops/limbs.py.  An element batch is an
``int64[L, ...]`` tensor: L limbs of 16 bits, least significant first, in
Montgomery form with R = 2^(16L) — the JAX package's layout, held in int64
because torch on the CPU has no ``+`` or ``>>`` for uint32 and int64 keeps
the lazy schoolbook columns (< 2^37) exact.  The CUDA kernels (csrc/) read the same tensors and work on
L/2 32-bit limbs; R is the same, so the Montgomery values are identical.

Every operation ends canonical (< p), as gnark_tpu's ``_cond_sub_p`` does,
so any two correct implementations of an operation give the same limbs.

Carries are resolved without a per-limb Python loop: a few vectorized
passes bring every limb to at most 2^16, then the remaining 0/1 ripple is
solved at once by carry-lookahead on a bitmask of the limbs (one integer
add).  Subtractions run through the same path by adding an offset of
2^(16L+1) that keeps every column nonnegative; the carry out then says
whether the difference went negative.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gnark_tpu_torch.fields.spec import FieldSpec, MASK, W

_I64 = torch.int64


def ints_to_limbs(values, L: int, q: int | None = None) -> np.ndarray:
    """Python ints -> uint32[L, n] regular-form 16-bit limb planes
    (copy of gnark_tpu.backend.groth16.ints_to_limbs)."""
    nbytes = 2 * L
    if q is None:
        buf = b"".join(v.to_bytes(nbytes, "little") for v in values)
    else:
        buf = b"".join((v % q).to_bytes(nbytes, "little") for v in values)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(values), L)
    return np.ascontiguousarray(arr.T).astype(np.uint32)


def limbs_to_ints(arr) -> list:
    """uint32/int64[L, n] regular-form limb planes -> python ints
    (copy of gnark_tpu.backend.groth16.limbs_to_ints)."""
    arr = np.asarray(arr).astype(np.uint16)
    le = np.ascontiguousarray(arr.T)
    data = le.tobytes()
    nbytes = 2 * arr.shape[0]
    return [int.from_bytes(data[i * nbytes:(i + 1) * nbytes], "little")
            for i in range(arr.shape[1])]


def _col(c: torch.Tensor, ndim: int) -> torch.Tensor:
    """[K] constant -> [K, 1, ...] for broadcasting against ndim dims."""
    return c.reshape((c.shape[0],) + (1,) * (ndim - 1))


def _limb_list(v: int, K: int) -> list:
    return [(v >> (W * i)) & MASK for i in range(K)]


def _offset(K: int) -> list:
    """Per-limb offset worth 2^(16K+1): 2^17 in limb 0, 2^17 - 2 above
    (each 2^17 at limb i is repaid by the -2 at limb i+1)."""
    return [1 << (W + 1)] + [(1 << (W + 1)) - 2] * (K - 1)


@functools.lru_cache(maxsize=None)
def _lookahead_consts(K: int, device: torch.device):
    shifts = torch.arange(K, dtype=_I64, device=device)
    return shifts, torch.ones(K, dtype=_I64, device=device) << shifts


def _carry(v: torch.Tensor, passes: int):
    """Lazy nonnegative columns [K, ...] -> (canonical limbs [K, ...],
    carry out [...]).  ``passes`` must bring every limb to <= 2^16: three
    for columns < 2^37, two for < 2^18."""
    K = v.shape[0]
    assert K <= 62, "carry-lookahead bitmask must fit an int64"
    zero = torch.zeros_like(v[:1])
    co = None
    for _ in range(passes):
        hi = v >> W
        v = (v & MASK) + torch.cat([zero, hi[:-1]])
        co = hi[-1] if co is None else co + hi[-1]
    # limbs are now <= 2^16: limb == 2^16 generates a carry, limb ==
    # 2^16 - 1 propagates one; one add of the bitmasks resolves the chain
    shifts, weights = _lookahead_consts(K, v.device)
    w = _col(weights, v.ndim)
    G = ((v > MASK) * w).sum(0)
    A = G | ((v == MASK) * w).sum(0)
    S = A + G
    cin = S ^ A ^ G
    v = (v + ((cin.unsqueeze(0) >> _col(shifts, v.ndim)) & 1)) & MASK
    return v, co + (S >> K)


@functools.lru_cache(maxsize=None)
def _select_matrix(La: int, Lb: int, device: torch.device):
    """[La + Lb - 1, La * Lb] 0/1 float64: column i*Lb + j feeds row i + j."""
    sel = torch.zeros(La + Lb - 1, La * Lb, dtype=torch.float64)
    for i in range(La):
        for j in range(Lb):
            sel[i + j, i * Lb + j] = 1
    return sel.to(device)


def _skew(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns of canonical [La, ...] and [Lb, ...]
    limb planes (broadcast over the batch): [La + Lb - 1, ...], lazy
    (< L * 2^32).

    The [La, Lb] outer product goes through one float64 matmul with a 0/1
    matrix that adds entry (i, j) into column i + j (exact: every partial
    sum is an integer below 2^53), which keeps the torch call count low
    where dispatch dominates."""
    La, Lb = a.shape[0], b.shape[0]
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    K = La + Lb - 1
    prod = (a.unsqueeze(1) * b.unsqueeze(0)).reshape(La * Lb, -1)
    cols = (_select_matrix(La, Lb, a.device) @ prod.double()).long()
    return cols.reshape((K,) + batch)


def _const_matrix(c: int, L: int, K: int, device) -> torch.Tensor:
    """[K, L] float64 Toeplitz matrix of a constant's 16-bit limbs: row k
    holds limb k - i in column i, so T @ x gives the product columns of
    x * c below K."""
    cl = _limb_list(c, L)
    T = torch.zeros(K, L, dtype=torch.float64)
    for k in range(K):
        for i in range(L):
            if 0 <= k - i < L:
                T[k, i] = cl[k - i]
    return T.to(device)


def _cmul(x: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Product columns of canonical limb planes x [L, ...] with the
    constant of T (see _const_matrix); exact in float64 (< 2^36)."""
    cols = T @ x.reshape(x.shape[0], -1).double()
    return cols.long().reshape((T.shape[0],) + x.shape[1:])


class FieldOps:
    """Vectorized prime-field ops bound to a FieldSpec (counterpart of
    gnark_tpu.ops.limbs.FieldOps).  Holds no device: constants are built
    on first use for each device an operand lives on."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.L = spec.L
        p = spec.modulus
        R = 1 << (W * spec.L)
        self._pinv = (-pow(p, -1, R)) % R
        self._consts = {}

    # -- constants ---------------------------------------------------------

    def _c(self, device) -> dict:
        device = torch.device(device)
        c = self._consts.get(device)
        if c is None:
            L, p = self.L, self.spec.modulus
            off = _offset(L)

            def t(vals):
                return torch.tensor(vals, dtype=_I64, device=device)

            pl = _limb_list(p, L)
            c = {
                "p_T": _const_matrix(p, L, 2 * L - 1, device),
                "pinv_T": _const_matrix(self._pinv, L, L, device),
                "r2": t(_limb_list(self.spec.R2, L)),
                "one": t(_limb_list(self.spec.R % p, L)),
                "e0": t([1] + [0] * (L - 1)),
                "off": t(off),
                "p_off": t([x + o for x, o in zip(pl, off)]),
                "off_p": t([o - x for x, o in zip(pl, off)]),
            }
            self._consts[device] = c
        return c

    # -- constructors ------------------------------------------------------

    def zeros(self, n, device):
        shape = (n,) if isinstance(n, int) else tuple(n)
        return torch.zeros((self.L,) + shape, dtype=_I64, device=device)

    def ones(self, n, device):
        shape = (n,) if isinstance(n, int) else tuple(n)
        one = self._c(device)["one"]
        return _col(one, len(shape) + 1).expand((self.L,) + shape).clone()

    def ones_like(self, a):
        return _col(self._c(a.device)["one"], a.ndim).expand(a.shape).clone()

    def pack(self, ints, device):
        """Host ints -> Montgomery limb planes [L, n] on ``device``."""
        p, R = self.spec.modulus, self.spec.R
        vals = [int(v) % p * R % p for v in ints]
        arr = ints_to_limbs(vals, self.L).astype(np.int64)
        return torch.from_numpy(arr).to(device)

    def unpack(self, arr) -> list:
        """Montgomery limb planes [L, n] -> host ints (canonical)."""
        p = self.spec.modulus
        rinv = pow(self.spec.R, -1, p)
        a = arr.detach().cpu().numpy()
        if a.ndim == 1:
            a = a[:, None]
        return [v * rinv % p for v in limbs_to_ints(a.reshape(a.shape[0], -1))]

    # -- ring ops ----------------------------------------------------------

    def _cond_sub_p(self, x):
        """x - p if x >= p else x (x < 2p, canonical limbs)."""
        d, co = _carry(x + _col(self._c(x.device)["off_p"], x.ndim), 2)
        return torch.where((co == 2).unsqueeze(0), d, x)

    def _pick(self, v, first_ok):
        """Carry both halves of v = cat([u, w], -1); keep u where
        ``first_ok(carry out of u, carry out of w)`` holds, else w."""
        lim, co = _carry(v, 2)
        n = v.shape[-1] // 2
        keep = first_ok(co[..., :n], co[..., n:])
        return torch.where(keep.unsqueeze(0), lim[..., :n], lim[..., n:])

    def add(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        s = a + b
        c = _col(self._c(s.device)["off_p"], s.ndim)
        # second half is s - p + 2^(16L+1): carry out 2 iff s >= p
        return self._pick(torch.cat([s, s + c], -1),
                          lambda c1, c2: c2 != 2)

    def sub(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        d = a - b
        c = self._c(d.device)
        # first half a - b + 2^(16L+1): carry out 2 iff a >= b; else a - b + p
        return self._pick(
            torch.cat([d + _col(c["off"], d.ndim),
                       d + _col(c["p_off"], d.ndim)], -1),
            lambda c1, c2: c1 == 2)

    def neg(self, a):
        d, _ = _carry(_col(self._c(a.device)["p_off"], a.ndim) - a, 2)
        return torch.where(self.is_zero(a).unsqueeze(0), a, d)  # -0 stays 0

    def double(self, a):
        return self.add(a, a)

    def mul_small(self, a, k: int):
        """a * k for a small plain int 0 <= k < 2^12 (the b3 = 3b const-mul),
        by a per-limb product and a cascade of conditional subtractions
        of 2^j p, as gnark_tpu's mul_small (limbs.py:262)."""
        if k == 0:
            return torch.zeros_like(a)
        if k == 1:
            return a
        assert 2 <= k < (1 << 12)
        L = self.L
        v = torch.cat([a * k, torch.zeros_like(a[:1])])
        r, _ = _carry(v, 2)                                # [L + 1, ...]
        off = _offset(L + 1)
        for j in range(k.bit_length() - 1, -1, -1):
            mp = _limb_list(self.spec.modulus << j, L + 1)
            c = torch.tensor([o - x for x, o in zip(mp, off)], dtype=_I64,
                             device=a.device)
            d, co = _carry(r + _col(c, r.ndim), 2)
            r = torch.where((co == 2).unsqueeze(0), d, r)
        return r[:L]

    def mul(self, a, b):
        """Montgomery product aR * bR -> abR mod p (separated REDC).

        t = a*b; m = (t mod R) * (-p^-1) mod R; u = (t + m*p) / R, whose
        low L limbs vanish by construction; u < 2p, one conditional
        subtraction finishes."""
        L = self.L
        c = self._c(a.device)
        t = _skew(a, b)                                    # [2L - 1], < 2^36
        t_low, _ = _carry(t[:L], 3)
        m, _ = _carry(_cmul(t_low, c["pinv_T"]), 3)        # m mod R
        s = t + _cmul(m, c["p_T"])
        s, _ = _carry(torch.cat([s, torch.zeros_like(s[:1])]), 3)
        return self._cond_sub_p(s[L:])

    def sqr(self, a):
        return self.mul(a, a)

    # -- predicates --------------------------------------------------------

    def is_zero(self, a):
        return (a == 0).all(0)

    def select(self, mask, a, b):
        """mask [...] ? a : b (elementwise over the batch axes)."""
        return torch.where(mask.unsqueeze(0), a, b)

    # -- inversion -----------------------------------------------------------

    def exp_const(self, a, e: int):
        """a^e for a fixed python-int exponent (square and multiply)."""
        result = self.ones_like(a)
        base = a
        while e:
            if e & 1:
                result = self.mul(result, base)
            e >>= 1
            if e:
                base = self.sqr(base)
        return result

    def inv(self, a):
        """a^-1 via Fermat (a^(p-2)); 0 maps to 0."""
        return self.exp_const(a, self.spec.modulus - 2)

    def _scan_mul(self, x):
        """Inclusive prefix products along axis 1 (Hillis-Steele)."""
        n, s = x.shape[1], 1
        while s < n:
            x = torch.cat([x[:, :s], self.mul(x[:, s:], x[:, :-s])], dim=1)
            s *= 2
        return x

    def batch_inv(self, a):
        """Montgomery-trick batch inversion of [L, n] along axis 1, with
        log-depth prefix and suffix products.  Zeros map to zero."""
        zero = self.is_zero(a)
        a_safe = torch.where(zero.unsqueeze(0), self.ones_like(a), a)
        prefix = self._scan_mul(a_safe)
        total_inv = self.inv(prefix[:, -1:])
        suffix = self._scan_mul(a_safe.flip(1)).flip(1)
        one = self.ones_like(a[:, :1])
        prefix_excl = torch.cat([one, prefix[:, :-1]], dim=1)
        suffix_excl = torch.cat([suffix[:, 1:], one], dim=1)
        out = self.mul(self.mul(prefix_excl, suffix_excl), total_inv)
        return torch.where(zero.unsqueeze(0), torch.zeros_like(a), out)

    # -- Montgomery form conversion ----------------------------------------

    def to_mont(self, a_regular):
        return self.mul(a_regular, _col(self._c(a_regular.device)["r2"],
                                        a_regular.ndim))

    def from_mont(self, a_mont):
        return self.mul(a_mont, _col(self._c(a_mont.device)["e0"],
                                     a_mont.ndim))


@functools.lru_cache(maxsize=None)
def field_ops(spec: FieldSpec) -> FieldOps:
    return FieldOps(spec)
