"""Mesh-sharded NTT: Bailey's four-step transform with all-to-all
transposes (counterpart of gnark_tpu/parallel/sharded_ntt.py).

The reference's butterflies run inside one address space (gnark-crypto
fft.Domain); here the polynomial axis is split over the ranks of one mesh
axis, and the cross-rank butterfly super-stage becomes data movement
(``dist.all_to_all_single`` on the axis's process group), the classic
distributed-NTT transpose.

Decomposition (n = A * B, A = ranks on the axis, x row-major [A, B], row
a on rank a):

    X[k1 + A*k2] = FFT_B over b of ( w_n^(k1*b) * FFT_A over a of x[a,b] )

  1. all_to_all: re-shard so each rank holds all A rows for B/A columns
  2. local size-A column DFT + twiddle w_n^(k1*b)
  3. all_to_all back: rank k1 holds row k1
  4. local size-B NTT along the row (ops/ntt.py's Domain)

Each rank passes and gets its own [L, B] block: natural-order row a in
(coeffs[a*B + b]); row k1, holding X[k1 + A*k2] for all k2, out (the
strided layout).  ``gather`` all-gathers the global [L, n];
``interleave``/``deinterleave`` convert between the strided and natural
layouts on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from gnark_tpu_torch.fields.spec import FieldSpec
from gnark_tpu_torch.ops.limbs import field_ops
from gnark_tpu_torch.ops.ntt import Domain, bit_reverse_perm, fr_pointwise


class ShardedDomain:
    """Forward/inverse NTT of size n over a mesh axis (natural order in,
    strided order out; see the module docstring).  Every table is built on
    the host once, here, for this rank's block on ``device``."""

    def __init__(self, spec: FieldSpec, n: int, mesh, axis: str, device):
        self.spec = spec
        self.n = n
        self.mesh = mesh
        self.axis = axis
        self.device = torch.device(device)
        self.group = mesh.get_group(axis)
        self.A = self.group.size()
        self.d = mesh.get_local_rank(axis)
        assert n % self.A == 0 and (n & (n - 1)) == 0
        assert (n // self.A) % self.A == 0, "4-step NTT needs n >= A^2"
        self.B = n // self.A
        self.F = field_ops(spec)
        self.local_domain = Domain(spec, self.B, self.device)
        self.local_domain.table("tw")
        self.local_domain.table("itw")
        q = spec.modulus
        self.omega_n = spec.root_of_unity(n)
        self.omega_n_inv = pow(self.omega_n, -1, q)
        self._brev_B = torch.from_numpy(
            bit_reverse_perm(self.B).astype(np.int64)).to(self.device)
        self._dft = {inv: self._col_dft_mat(inv) for inv in (False, True)}
        self._tw = {inv: self._twiddle_block(inv) for inv in (False, True)}
        # the local ifft already scales by 1/B; the remaining factor is 1/A
        self._ainv = self.F.pack([pow(self.A, -1, q)], self.device)
        g = spec.multiplicative_generator % q
        self._den = self.F.pack([pow(pow(g, n, q) - 1, -1, q)], self.device)
        self._gs = {inv: self.block(self.coset_scale_strided(inv))
                    for inv in (False, True)}

    # ---- twiddle tables (host ints, then Montgomery planes on device) ----

    def _col_dft_mat(self, inverse):
        """w_A^(jk) as Montgomery planes [L, A, A, 1] (row j = output)."""
        q = self.spec.modulus
        w = pow(self.omega_n, self.B, q)
        if inverse:
            w = pow(w, -1, q)
        vals = [pow(w, j * k, q) for j in range(self.A) for k in range(self.A)]
        return self.F.pack(vals, self.device).reshape(self.spec.L, self.A, self.A, 1)

    def _twiddle_block(self, inverse):
        """w_n^(k1*b) for every k1 in [A] and this rank's columns b =
        d*(B/A) + j, j in [B/A]: [L, A, B/A] planes."""
        q = self.spec.modulus
        w = self.omega_n_inv if inverse else self.omega_n
        C = self.B // self.A
        vals = []
        for k1 in range(self.A):
            base = pow(w, k1, q)
            t = pow(base, self.d * C, q)
            for _ in range(C):
                vals.append(t)
                t = t * base % q
        return self.F.pack(vals, self.device).reshape(self.spec.L, self.A, C)

    # ---- the collectives -------------------------------------------------

    def _transpose(self, x):
        """[L, A, C] -> [L, A, C]: slice i of axis 1 goes to rank i, and
        slice i of the result came from rank i."""
        send = x.permute(1, 0, 2).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return recv.permute(1, 0, 2)

    def _col_dft(self, x, inverse):
        """[L, A, C] -> [L, A, C]: out[k] = sum_a w_A^(k a) x[a]."""
        F = self.F
        prods = F.mul(x.unsqueeze(1), self._dft[inverse])   # [L, A, A, C]
        acc = prods[:, :, 0]
        for a in range(1, self.A):
            acc = F.add(acc, prods[:, :, a])
        return acc

    def gather(self, block):
        """This rank's [L, B] block -> the global [L, n] on every rank."""
        parts = [torch.empty_like(block) for _ in range(self.A)]
        dist.all_gather(parts, block.contiguous(), group=self.group)
        return torch.cat(parts, 1)

    def block(self, x):
        """The global [L, n] -> this rank's [L, B] block."""
        return x[:, self.d * self.B:(self.d + 1) * self.B]

    # ---- the transforms --------------------------------------------------

    def _four_step(self, x, inverse):
        F, A, B, L = self.F, self.A, self.B, self.spec.L
        # 1) re-shard: this rank ends with all A rows of its column chunk
        xs = self._transpose(x.reshape(L, A, B // A))
        # 2) column DFT of size A, twiddle w_n^(k1 * b)
        ys = F.mul(self._col_dft(xs, inverse), self._tw[inverse])
        # 3) back: rank k1 gets its row, column chunk c at [:, c]
        row = self._transpose(ys).reshape(L, B)
        # 4) local size-B NTT (natural in -> natural out)
        dom = self.local_domain
        if inverse:
            return F.mul(dom.ifft(row[:, self._brev_B], "DIT"), self._ainv)
        return dom.fft(row[:, self._brev_B], "DIT")

    def fft(self, x):
        """x: this rank's [L, B] row of natural-order coefficients ->
        its row of strided evaluations (rank k1 holds X[k1 + A*k2])."""
        return self._four_step(x, inverse=False)

    def ifft(self, x):
        return self._four_step(x, inverse=True)

    def fft_from_strided(self, u):
        """Strided coefficients (rank k1 holds c[k1 + A*k2]) -> natural
        evaluations (rank d holds E[d*B .. (d+1)*B)).  The mirror of the
        four steps: local size-B NTT first, then transpose, twiddle and
        size-A column DFT, transpose back.

          E[d*B + t] = sum_k1 w^(k1*(d*B+t)) * NTT_B(row k1)[t]
        """
        F, A, B, L = self.F, self.A, self.B, self.spec.L
        # 1) local size-B NTT with root w^A (natural in/out)
        S = self.local_domain.fft(u[:, self._brev_B], "DIT")
        # 2) transpose: rank c receives S_k1[t] for its t-chunk
        Ss = self._transpose(S.reshape(L, A, B // A))
        # 3) twiddle by w^(k1 * t), then the column DFT over k1
        Es = self._col_dft(F.mul(Ss, self._tw[False]), inverse=False)
        # 4) transpose back: rank dd collects its t-chunks
        return self._transpose(Es).reshape(L, B)

    # ---- sharded Groth16 quotient (computeH, prove.go:275) -----------------

    def coset_scale_strided(self, inverse=False):
        """g^j (or g^-j) in the strided layout as a global [L, n] (Montgomery
        form) on the device, for scaling coefficients that live in the
        strided order the ifft produces."""
        q = self.spec.modulus
        g = self.spec.multiplicative_generator % q
        if inverse:
            g = pow(g, -1, q)
        vals, t = [], 1
        for _ in range(self.n):
            vals.append(t)
            t = t * g % q
        nat = self.F.pack(vals, "cpu").numpy()
        return torch.from_numpy(self.interleave(nat)).to(self.device)

    def compute_h(self, a, b, c):
        """Sharded quotient h = (A*B - C)/Z_H on the coset.

        a/b/c: this rank's [L, B] blocks of the Montgomery evaluations on H,
        natural order.  Returns this rank's block of h's coefficients in
        the strided order (the caller gathers them and permutes to the
        order its Z key points use).  Both all_to_all stages of each
        four-step transform cross the mesh axis.  The pointwise step (a b -
        c) / Z_H goes through ops/ntt.py's fr_pointwise (its kernel on CUDA
        tensors), as the unsharded compute_h's does."""
        F = self.F

        def coset_evals(x):
            return self.fft_from_strided(F.mul(self.ifft(x), self._gs[False]))

        ae, be, ce = coset_evals(a), coset_evals(b), coset_evals(c)
        he = fr_pointwise(self.spec, ae, be, ce, self._den)
        return F.mul(self.ifft(he), self._gs[True])

    def strided_to_brev_perm(self) -> np.ndarray:
        """Permutation taking the strided layout to bit-reversed order:
        out[i] = strided_index_of(brev(i))."""
        n, A, B = self.n, self.A, self.B
        brev = bit_reverse_perm(n)
        # natural index j lives at strided position (j % A) * B + j // A
        pos = (brev % A) * B + brev // A
        return pos.astype(np.int32)

    # ---- host order conversion helpers ------------------------------------

    def deinterleave(self, X_strided: np.ndarray) -> np.ndarray:
        """[L, n] strided output rows -> natural order (host numpy)."""
        L = X_strided.shape[0]
        m = X_strided.reshape(L, self.A, self.B)
        return np.ascontiguousarray(
            np.moveaxis(m, 1, 2).reshape(L, self.n))

    def interleave(self, X_natural: np.ndarray) -> np.ndarray:
        L = X_natural.shape[0]
        m = X_natural.reshape(L, self.B, self.A)
        return np.ascontiguousarray(
            np.moveaxis(m, 2, 1).reshape(L, self.n))
