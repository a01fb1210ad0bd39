"""Multi-scalar multiplication: the signed windowed Pippenger plan of
gnark_tpu/ops/msm.py (``MSM._run_window_pallas``) and its double-and-add
ladder (``MSM._run_ladder_pallas``), in PyTorch with seven kernels in CUDA.

``msm`` sends fewer than LADDER_MAX points to the ladder: each scalar cut
into K chunks of B bits, and per (point, chunk) the chunk's multiple of
the point by w-bit windows over a table of multiples          [kernel]
then per chunk the sum of those points                         [kernel]
then the fold sum_j 2^(jB) T_j of the chunk sums               [kernel: Horner].
It sends the rest to the windowed plan.

Per window of c-bit signed digits (|d| <= 2^(c-1), negatives by free EC
negation):
  1. sort the points by (|digit|, sign) and gather them into R lanes of
     C = n/R sorted points each;
  2. leaf: per lane, the running sum of complete mixed adds    [kernel]
  3. lane offsets: exclusive scan of the R lane totals (a
     Brent-Kung scan, R a power of two)                         [kernel]
  4. bucket sums as differences of global prefixes at the digit
     boundaries (a binary search, a leaf row plus its lane's
     offset)                                                     [kernel]
  5. S_w = sum_b b * bucket_b by a halving fold                 [kernel]
then a Horner fold over the windows, its sum leaving in the Jacobian
form the MSM returns                                            [kernel].
Steps 1-5 run on the windows in chunks (gnark_tpu's window chunking,
msm.py:248-285): a chunk's sorted points and leaf rows, about
n_pad x 5L int64 a window, stay under a share of the card's memory, and
its intermediates are released before the next chunk starts.

Each kernel wrapper runs its plain PyTorch version when given CPU tensors
and launches the CUDA kernel (ops/_cuda.py) when given CUDA tensors; any
other device raises.  There is no fallback from a kernel to its plain
version.  ``plain_on_cuda`` counts plain versions run on CUDA tensors (by
a comparison, never by the MSM itself).

Field elements are int64 limb planes (ops/limbs.py).  A kernel's stacked
point tensor is [3L, ...]: X over Y over Z.
"""

from __future__ import annotations

import functools

import torch

from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops.ec import CurveOps
from gnark_tpu_torch.ops.ec_complete import CompleteOps

plain_on_cuda = {k: 0 for k in _cuda.KERNELS}


def window_digits(scalars, c: int, nwin: int | None = None):
    """int64[Ls, n] regular-form 16-bit scalar limbs -> int64[nwin, n]
    unsigned c-bit window digits."""
    Ls, n = scalars.shape[0], scalars.shape[1:]
    if nwin is None:
        nwin = -(-(Ls * 16) // c)
    pad_limbs = -(-(nwin * c) // 16) + 1 - Ls
    padded = torch.cat([scalars, scalars.new_zeros((max(1, pad_limbs),) + n)])
    bit = torch.arange(nwin, device=scalars.device) * c
    q, sh = bit // 16, (bit % 16).reshape((nwin,) + (1,) * len(n))
    d = (padded[q] >> sh) | (padded[q + 1] << (16 - sh))
    return d & ((1 << c) - 1)


def window_digits_signed(scalars, c: int):
    """Signed-digit recoding: scalar = sum_w d_w 2^(cw), d_w in
    (-2^(c-1), 2^(c-1)].  Returns (|d| int64[nwin, n], sign int64[nwin, n]);
    nwin has one slack bit so the final carry is never dropped."""
    nwin = -(-(scalars.shape[0] * 16 + 1) // c)
    u = window_digits(scalars, c, nwin)
    half, full = 1 << (c - 1), 1 << c
    carry = torch.zeros_like(u[0])
    absd, signs = [], []
    for w in range(nwin):
        t = u[w] + carry
        neg = t > half
        absd.append(torch.where(neg, full - t, t))
        signs.append(neg.to(torch.int64))
        carry = signs[-1]
    return torch.stack(absd), torch.stack(signs)


def choose_c(n: int, total_bits: int, lanes: int) -> int:
    """gnark_tpu's signed-plan cost model (msm.py:211-219), in field muls."""
    def cost(cc):
        nwin = -(-(total_bits + 1) // cc)
        nb = 1 << (cc - 1)
        lane = max(1, (lanes - 1).bit_length()) * lanes * 26
        bucket = 4 * nb * 26
        return nwin * (n * 11 + lane + bucket)

    return min(range(6, 15), key=cost)


def split_points(t, L):
    """[3L, ...] stacked point tensor -> (X, Y, Z)."""
    return t[:L], t[L:2 * L], t[2 * L:]


def _device_route(t: torch.Tensor, name: str) -> bool:
    """True for a kernel launch, False for the plain version; raises on a
    device that has neither."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for {t.device}")


def _count_plain(t, name):
    if t.is_cuda:
        plain_on_cuda[name] += 1


# ---- kernel 1: leaf prefix ------------------------------------------------

def leaf_prefix_plain(sx, sy, GC: CompleteOps, acc=None):
    """sx, sy: [nw, C, L, R], sorted position r*C + cs at [w, cs, :, r];
    bit 16 of y limb 0 flags infinity, bit 17 a negative digit.
    Returns rows [nw, C*R, 3L]: row cs*R + r is the running sum of lane r
    after step cs, from ``acc`` ([3L, nw, R] projective; the identity by
    default)."""
    _count_plain(sx, "leaf_prefix")
    F = GC.F
    nw, C, L, R = sx.shape
    acc = (GC.inf((nw, R), sx.device) if acc is None
           else split_points(acc, L))
    out = []
    for cs in range(C):
        px = sx[:, cs].permute(1, 0, 2)
        yr = sy[:, cs].permute(1, 0, 2)
        flags = yr[0] >> 16
        py = torch.cat([yr[:1] & 0xFFFF, yr[1:]])
        py = F.select((flags & 2) != 0, F.neg(py), py)
        acc = GC.add_mixed(acc, (px, py), (flags & 1) != 0)
        out.append(torch.cat(acc).permute(1, 2, 0))        # [nw, R, 3L]
    return torch.stack(out, 1).reshape(nw, C * R, 3 * L)


def leaf_prefix(sx, sy, GC: CompleteOps):
    if _device_route(sx, "leaf_prefix"):
        return _cuda.leaf_prefix(sx, sy, _cuda.kind_of(GC))
    return leaf_prefix_plain(sx, sy, GC)


# ---- kernel 2: lane offsets -------------------------------------------------

def check_lanes(R: int):
    """The lane offsets scan R = 2^K lanes: raise on any other R."""
    if R < 1 or R & (R - 1):
        raise ValueError(f"lane count {R} is not a power of two")


def scan_steps(R: int):
    """(2^d, first lane, additions) of each step of a Brent-Kung inclusive
    scan over R = 2^K lanes (msm_kernels.cu's scan_step): the up-sweep's
    levels d = 0 .. K-1, then the down-sweep's d = K-2 .. 0.  A step adds
    A[i - 2^d] to A[i] for i = first, first + 2^(d+1), ... below R."""
    K = R.bit_length() - 1
    for s in range(2 * K - 1):
        up = s < K
        d = s if up else 2 * K - 2 - s
        first = (2 if up else 3) * (1 << d) - 1
        yield 1 << d, first, (R - 1 - first) // (2 << d) + 1


def lane_offsets_plain(tot, GC: CompleteOps):
    """tot: [3L, nw, R] lane totals, R a power of two -> [3L, nw, R]
    exclusive prefix sums over the lane axis: lane r holds tot[0] + ... +
    tot[r-1], lane 0 the identity class (0 : 1 : 0).  A Brent-Kung scan in
    place (scan_steps), each step one batched complete addition of the
    left operands A[i - 2^d] and the right ones A[i], then the exclusive
    shift: the kernel's additions in the kernel's order.  gnark_tpu's
    Hillis-Steele scan gives the same group elements, other
    representatives."""
    _count_plain(tot, "lane_offsets")
    L = GC.F.L
    R = tot.shape[-1]
    check_lanes(R)
    A = tot.clone()
    for half, first, count in scan_steps(R):
        right = A[..., first::2 * half]
        left = A[..., first - half::2 * half][..., :count]
        right.copy_(torch.cat(GC.add(split_points(left, L),
                                     split_points(right, L))))
    ident = torch.cat(GC.inf(tot.shape[1:-1] + (1,), tot.device))
    return torch.cat([ident, A[..., :R - 1]], -1)


def lane_offsets(tot, GC: CompleteOps):
    if _device_route(tot, "lane_offsets"):
        return _cuda.lane_offsets(tot, _cuda.kind_of(GC))
    return lane_offsets_plain(tot, GC)


# ---- kernel 3: the bucket step -----------------------------------------------

def buckets_plain(rows, offs, d_sorted, C: int, R: int, nb: int,
                  GC: CompleteOps):
    """rows: [nw, C*R, 3L] leaf rows, offs: [3L, nw, R] lane offsets,
    d_sorted: [nw, C*R] each window's sorted digits -> [3L, nw, nb]
    buckets (gnark_tpu's _window_chunk, msm.py:887-909).  Bucket b =
    (global prefix at the end of digit b) minus (at the end of digit
    b - 1): one boundary array E_b, b = 0..nb, from searchsorted; a global
    prefix is a leaf row plus its lane's offset."""
    _count_plain(rows, "buckets")
    L = GC.F.L
    nw = rows.shape[0]
    bvals = torch.arange(nb + 1, device=rows.device).expand(
        nw, nb + 1).contiguous()
    ends = torch.searchsorted(d_sorted, bvals, right=True) - 1
    gi = ends.clamp(min=0)
    w = torch.arange(nw, device=rows.device).unsqueeze(1)
    P = split_points(rows[w, (gi % C) * R + gi // C].permute(2, 0, 1), L)
    orows = offs.permute(1, 2, 0)                       # [nw, R, 3L]
    O = split_points(orows[w, gi // C].permute(2, 0, 1), L)
    T = GC.add(P, O)
    # nothing at or below this digit -> the identity class (X = Z = 0;
    # Y is a point's Y, nonzero)
    valid = (ends >= 0).unsqueeze(0)
    PE = (torch.where(valid, T[0], 0), T[1], torch.where(valid, T[2], 0))
    bk = GC.add(tuple(a[..., 1:] for a in PE),
                GC.neg(tuple(a[..., :-1] for a in PE)))
    return torch.cat(bk).contiguous()


def buckets(rows, offs, d_sorted, C: int, R: int, nb: int, GC: CompleteOps):
    if _device_route(rows, "buckets"):
        return _cuda.buckets(rows, offs, d_sorted, C, R, nb, _cuda.kind_of(GC))
    return buckets_plain(rows, offs, d_sorted, C, R, nb, GC)


# ---- kernel 4: weighted bucket sum ------------------------------------------

def weighted_sum_plain(bk, GC: CompleteOps):
    """bk: [3L, nw, nb] buckets (bucket j holds digit j + 1; nb a power of
    two) -> [3L, nw] with S_w = sum_j (j+1) * B_j, by the halving fold

      sum_{j<m} (j+1) B_j = sum_{j<H} (j+1)(B_j + B_{H+j}) + H sum_{j<H} B_{H+j}

    (gnark_tpu msm.py:623-702, carried down to one lane)."""
    _count_plain(bk, "weighted_sum")
    L = GC.F.L
    nb = bk.shape[-1]
    assert nb & (nb - 1) == 0, "bucket count must be a power of two"
    B = split_points(bk, L)
    W = None
    m = nb
    while m > 1:
        H = m // 2
        low = tuple(a[..., :H] for a in B)
        high = tuple(a[..., H:m] for a in B)
        T, t = high, H
        while t > 1:
            T = GC.add(tuple(a[..., :t // 2] for a in T),
                       tuple(a[..., t // 2:t] for a in T))
            t //= 2
        for _ in range(H.bit_length() - 1):            # T *= H
            T = GC.double(T)
        W = T if W is None else GC.add(W, T)
        B = GC.add(low, high)
        m = H
    S = B if W is None else GC.add(B, W)
    return torch.cat([a[..., 0] for a in S])


def weighted_sum(bk, GC: CompleteOps):
    if _device_route(bk, "weighted_sum"):
        return _cuda.weighted_sum(bk, _cuda.kind_of(GC))
    return weighted_sum_plain(bk, GC)


# ---- kernel 5: Horner fold ----------------------------------------------------

def horner_fold_plain(S, c: int, GC: CompleteOps, jacobian=False):
    """S: [3L, nw] window sums -> [3L, 1] = sum_w 2^(cw) S_w (most
    significant window first: c doublings, then one add).  The fold starts
    at the highest window that is not the identity (Z != 0), or at window
    0 when all are, as the kernel does.  With ``jacobian`` the sum comes
    out as GC.to_jacobian gives it, (XZ, YZ^2, Z)."""
    _count_plain(S, "horner_fold")
    L = GC.F.L
    X, Y, Z = split_points(S, L)
    live = (Z != 0).any(0).nonzero()
    top = int(live[-1]) if len(live) else 0
    acc = (X[:, top:top + 1], Y[:, top:top + 1], Z[:, top:top + 1])
    for w in range(top - 1, -1, -1):
        for _ in range(c):
            acc = GC.double(acc)
        acc = GC.add(acc, (X[:, w:w + 1], Y[:, w:w + 1], Z[:, w:w + 1]))
    return torch.cat(GC.to_jacobian(acc) if jacobian else acc)


# the kernel's plain version: the fold in the Jacobian form
horner_fold_jacobian_plain = functools.partial(horner_fold_plain,
                                               jacobian=True)


def horner_fold(S, c: int, GC: CompleteOps):
    """The Horner fold in the Jacobian form (X Z, Y Z^2, Z)."""
    if _device_route(S, "horner_fold"):
        return _cuda.horner_fold(S, c, _cuda.kind_of(GC))
    return horner_fold_jacobian_plain(S, c, GC)


# ---- kernel 6: the chunked, windowed ladder ----------------------------------

# 16 chunks of 16 bits: 16 n threads (65,536 at 4096 points, enough to fill
# the card), and 4-bit windows (a table of 16 entries, 4 windows a chunk)
LADDER_CHUNKS = _cuda.LADDER_CHUNKS
LADDER_WINDOW = _cuda.LADDER_WINDOW


def chunk_bits(scalar_limbs: int) -> int:
    """B, the bits of one chunk of a scalar of ``scalar_limbs`` 16-bit limbs."""
    return 16 * scalar_limbs // LADDER_CHUNKS


def ladder_digits(scalars):
    """int64[Ls, n] scalar limbs -> the windows' digits, lowest first, each
    int64[K, n]: bits [jB + mw, jB + min((m + 1) w, B)) of scalar i at
    [j, i] for window m; the top window of a chunk may be narrower."""
    Ls, n = scalars.shape
    B, w = chunk_bits(Ls), LADDER_WINDOW
    shifts = torch.arange(16, device=scalars.device).reshape(1, 16, 1)
    bits = ((scalars.unsqueeze(1) >> shifts) & 1).reshape(LADDER_CHUNKS, B, n)
    out = []
    for lo in range(0, B, w):
        hi = min(B, lo + w)
        weights = 1 << torch.arange(hi - lo, device=scalars.device)
        out.append((bits[:, lo:hi] * weights.reshape(1, -1, 1)).sum(1))
    return out


def ladder_table(xs, ys, inf_mask, GC: CompleteOps):
    """[2^w, 3L, n]: entry e = e * P_i, projective: T[0] the identity
    (0 : 1 : 0), T[1] = (x : y : 1) or the identity where flagged infinite,
    T[2k] = 2 T[k], T[2k+1] = T[2k] + T[1] (the kernel's recipe)."""
    F = GC.F
    n = xs.shape[-1]
    ident = GC.inf(n, xs.device)
    T = [ident, GC.select(inf_mask, ident, (xs, ys, F.ones(n, xs.device)))]
    for e in range(2, 1 << LADDER_WINDOW):
        T.append(GC.add(T[e - 1], T[1]) if e & 1 else GC.double(T[e >> 1]))
    return torch.stack([torch.cat(t) for t in T])


def ladder_plain(xs, ys, inf_mask, scalars, GC: CompleteOps):
    """Per point i and chunk j, d_ij * P_i, where d_ij is bits [jB, (j+1)B)
    of s_i (B = 16 Ls / K): from the top window of the chunk, acc = T[d];
    per further window, w complete doublings and acc + T[d], T[0] the
    identity, so every column runs the same steps.  xs, ys: [L, n] affine;
    inf_mask: [n] bool; scalars: [Ls, n] regular-form limbs.  Returns
    [3L, K, n] projective."""
    _count_plain(xs, "ladder")
    L = GC.F.L
    n = xs.shape[-1]
    digits = ladder_digits(scalars)
    tab = ladder_table(xs, ys, inf_mask, GC)
    cols = torch.arange(n, device=xs.device).repeat(LADDER_CHUNKS)  # j*n + i -> i

    def lookup(d):
        return split_points(tab[d.reshape(-1), :, cols].T, L)

    acc = lookup(digits[-1])
    for d in reversed(digits[:-1]):
        for _ in range(LADDER_WINDOW):
            acc = GC.double(acc)
        acc = GC.add(acc, lookup(d))
    return torch.cat(acc).reshape(3 * L, LADDER_CHUNKS, n)


def ladder(xs, ys, inf_mask, scalars, GC: CompleteOps):
    if _device_route(xs, "ladder"):
        return _cuda.ladder(xs, ys, inf_mask, scalars, _cuda.kind_of(GC))
    return ladder_plain(xs, ys, inf_mask, scalars, GC)


# ---- kernel 7: the per-chunk sums of the ladder's points --------------------------

def reduce_plain(pts, GC: CompleteOps):
    """pts: [3L, K, n] projective points -> [3L, K], each chunk's sum (the
    ladder's reduction; gnark_tpu's ``_reduce``, msm.py:124, is XLA).
    Lane t of REDUCE_LANES sums points t, t + 256, ... in order over n
    padded to a multiple of 256 with the identity (0 : 1 : 0), then a
    halving tree over the lanes."""
    _count_plain(pts, "reduce")
    L, T = GC.F.L, _cuda.REDUCE_LANES
    _, K, n = pts.shape
    pad = -n % T
    if pad:
        pts = torch.cat([pts, torch.cat(GC.inf((K, pad), pts.device))], -1)
    cols = split_points(pts.reshape(3 * L, K, -1, T), L)
    acc = tuple(a[:, :, 0] for a in cols)
    for j in range(1, cols[0].shape[2]):
        acc = GC.add(acc, tuple(a[:, :, j] for a in cols))
    t = T
    while t > 1:
        t //= 2
        acc = GC.add(tuple(a[..., :t] for a in acc),
                     tuple(a[..., t:2 * t] for a in acc))
    return torch.cat(acc)[..., 0]


def reduce(pts, GC: CompleteOps):
    if _device_route(pts, "reduce"):
        return _cuda.reduce(pts, _cuda.kind_of(GC))
    return reduce_plain(pts, GC)


@functools.lru_cache(maxsize=None)
def complete_ops(G: CurveOps) -> CompleteOps:
    """The complete-formula ops over G's field and curve."""
    return CompleteOps(G.F, G.b)


def ladder_msm(G: CurveOps, xs, ys, inf_mask, scalars):
    """The ladder MSM: per (point, chunk) the ladder, per chunk the
    reduction, then the Horner fold of the chunk sums with c = B.  Returns
    one Jacobian point (coordinates [L, 1])."""
    GC = complete_ops(G)
    P = ladder(xs.contiguous(), ys.contiguous(), inf_mask.contiguous(),
               scalars.contiguous(), GC)
    S = horner_fold(reduce(P, GC), chunk_bits(scalars.shape[0]), GC)
    return split_points(S, G.F.L)


# ---- the windowed plan ---------------------------------------------------------

def _call(_name, fn):
    return fn()


def window_bytes(n_pad: int, L: int) -> int:
    """A window's live bytes in a chunk: its leaf rows [n_pad, 3L] beside
    its sorted points sx, sy [n_pad, L] each, int64."""
    return n_pad * 5 * L * 8


# The share of the card's memory one chunk's windows may take.  The rest
# holds what lives beside a chunk: the proving key (3.2 GB at 2^21 BN254
# points), the plan's padded inputs, point rows and digits (about
# n_pad x (4L + 2 nwin) int64), the sort's and the bucket additions'
# temporaries, and blocks the caching allocator keeps from earlier MSMs
# of other shapes.  Half of an 80 GB card runs a 2^21-point G1 MSM (25.5
# GB) in one chunk and BN254's G2 (51 GB) in two.
MEMORY_SHARE = 0.5


def memory_cap(total_memory: int) -> int:
    """Bytes one chunk's windows may take on a card of ``total_memory``."""
    return int(MEMORY_SHARE * total_memory)


def window_chunks(nwin: int, per_window: int, cap: int | None):
    """[(w0, w1)]: the windows in chunks of at most ``cap`` bytes at
    ``per_window`` each, balanced as gnark_tpu balances them (msm.py:
    270-277: 17 + 15 -> 16 + 16), the last chunk the smaller; one chunk
    when ``cap`` is None."""
    wmax = nwin if cap is None else max(1, cap // per_window)
    nchunks = -(-nwin // wmax)
    wchunk = -(-nwin // nchunks)
    return [(w0, min(nwin, w0 + wchunk)) for w0 in range(0, nwin, wchunk)]


class MSM:
    """A signed windowed MSM plan for a fixed (curve ops, n, c, lanes).

    The plan holds no device: it runs where its inputs live, its windows
    in chunks under ``max_bytes`` when given, else under ``memory_cap``
    of a CUDA input's card (one chunk on the CPU)."""

    def __init__(self, G: CurveOps, n: int, scalar_limbs: int,
                 c: int | None = None, lanes: int | None = None,
                 max_bytes: int | None = None):
        self.G = G
        self.GC = complete_ops(G)
        self.n = n
        self.scalar_limbs = scalar_limbs
        total_bits = scalar_limbs * 16
        # 512 lanes of C = 128 points at 2^16; below 2^12 points, lanes
        # of 8 points (a short leaf chain)
        self.R = lanes or min(512, _next_pow2(max(1, n // 8)))
        check_lanes(self.R)
        self.c = c or choose_c(n, total_bits, self.R)
        self.nwin = -(-(total_bits + 1) // self.c)
        self.nb = 1 << (self.c - 1)
        self.C = -(-n // self.R)
        self.n_pad = self.C * self.R
        self.max_bytes = max_bytes

    def chunks(self, device) -> list:
        """[(w0, w1)]: the window ranges this plan runs on ``device``."""
        cap = self.max_bytes
        if cap is None and torch.device(device).type == "cuda":
            cap = memory_cap(
                torch.cuda.get_device_properties(device).total_memory)
        return window_chunks(self.nwin, window_bytes(self.n_pad, self.G.F.L),
                             cap)

    def __call__(self, xs, ys, inf_mask, scalars):
        """xs, ys: [L, n] affine Montgomery coordinates; inf_mask: [n]
        bool; scalars: [Ls, n] regular-form limbs.  Returns one Jacobian
        point (coordinates [L, 1])."""
        return self.run(xs, ys, inf_mask, scalars, WRAPPERS)

    def run(self, xs, ys, inf_mask, scalars, impl, step=None):
        """The plan with the five steps taken from ``impl`` (WRAPPERS, or
        PLAIN to time the plain versions on a device): recode once, the
        windows chunk by chunk (sort and gather, the leaf, the lane
        offsets, the buckets and the weighted sum, each intermediate
        released once the next step has read it), then one Horner fold
        over every window's sum, into the Jacobian form.  A window's sum
        does not depend on its chunk, so the limbs are the one-chunk
        plan's.  ``step(name, fn)``, when given, runs each step as
        ``fn()`` and returns its output (the smoke run times the steps and
        keeps the kernels' inputs so)."""
        step = step or _call
        leaf, lanes, bucket, wsum, horner = impl
        GC = self.GC
        ptrows, digits, signs = step("recode", lambda: self._prep_window(
            xs, ys, inf_mask, scalars))
        S = []
        for w0, w1 in self.chunks(xs.device):
            sx, sy, ds = step("sort_gather", lambda: self._sort_gather(
                ptrows, digits[w0:w1], signs[w0:w1]))
            rows = step("leaf_prefix", lambda: leaf(sx, sy, GC))
            del sx, sy
            offs = step("lane_offsets", lambda: lanes(
                self.lane_totals(rows), GC))
            bk = step("buckets", lambda: bucket(
                rows, offs, ds, self.C, self.R, self.nb, GC))
            del rows, offs, ds
            S.append(step("weighted_sum", lambda: wsum(bk, GC)))
            del bk
        S = torch.cat(S, 1)
        P = step("horner_fold", lambda: horner(S, self.c, GC))
        return split_points(P, self.G.F.L)

    def lane_totals(self, rows):
        """Leaf rows -> [3L, nw, R] lane totals (the rows of step C-1)."""
        return rows[:, (self.C - 1) * self.R:, :].permute(2, 0, 1).contiguous()

    def _prep_window(self, xs, ys, inf_mask, scalars):
        """Pad to n_pad, recode the scalars, and build the row-major point
        mirror [n_pad, 2L] with the infinity flag in bit 16 of y limb 0."""
        pad = self.n_pad - xs.shape[-1]
        if pad:
            xs = torch.cat([xs, xs.new_zeros(xs.shape[0], pad)], 1)
            ys = torch.cat([ys, ys.new_zeros(ys.shape[0], pad)], 1)
            inf_mask = torch.cat([inf_mask, inf_mask.new_ones(pad)])
            scalars = torch.cat(
                [scalars, scalars.new_zeros(scalars.shape[0], pad)], 1)
        digits, signs = window_digits_signed(scalars, self.c)
        digits = torch.where(inf_mask.unsqueeze(0), 0, digits)
        ysf = ys.clone()
        ysf[0] += inf_mask.to(torch.int64) << 16
        return torch.cat([xs.T, ysf.T], 1), digits, signs

    def _sort_gather(self, ptrows, dg, signs):
        """Sort each window by the packed key (|digit|, sign, index) and
        gather the point rows into the leaf's [nw, C, L, R] layout (sorted
        position r*C + cs at [w, cs, :, r]); the sorted sign goes to bit 17
        of y limb 0.  Returns (sx, sy, d_sorted [nw, n_pad])."""
        n_pad, R, C = self.n_pad, self.R, self.C
        nw = dg.shape[0]
        L = ptrows.shape[1] // 2
        idx_bits = max(1, (n_pad - 1).bit_length())
        iota = torch.arange(n_pad, device=dg.device)
        key = (dg << (idx_bits + 1)) | (signs << idx_bits) | iota
        skey = torch.sort(key, dim=1).values
        orders = skey & ((1 << idx_bits) - 1)
        d_sorted = skey >> (idx_bits + 1)
        ssgn = (skey >> idx_bits) & 1
        g = ptrows[orders]                                  # [nw, n_pad, 2L]
        g = g.reshape(nw, R, C, 2 * L).permute(0, 2, 3, 1)
        sx = g[:, :, :L].contiguous()
        sy = g[:, :, L:].contiguous()
        sy[:, :, 0, :] += ssgn.reshape(nw, R, C).permute(0, 2, 1) << 17
        return sx, sy, d_sorted

    def _buckets(self, rows, offs, d_sorted):
        """The bucket step's wrapper at this plan's C, R and nb."""
        return buckets(rows, offs, d_sorted, self.C, self.R, self.nb,
                       self.GC)


WRAPPERS = (leaf_prefix, lane_offsets, buckets, weighted_sum, horner_fold)
PLAIN = (leaf_prefix_plain, lane_offsets_plain, buckets_plain,
         weighted_sum_plain, horner_fold_jacobian_plain)


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


# Below this many points the ladder: gnark_tpu routes G1 so on the TPU
# (msm.py:171), and G2 so when the windowed fp2 route is on (msm.py:165).
LADDER_MAX = 8192


@functools.lru_cache(maxsize=None)
def _plan(G, n, scalar_limbs):
    return MSM(G, n, scalar_limbs)


def msm(G: CurveOps, xs, ys, inf_mask, scalars):
    """One-shot MSM: the ladder below LADDER_MAX points, else the windowed
    plan (cached per (G, n)).  Returns one Jacobian point."""
    n = xs.shape[-1]
    if n < LADDER_MAX:
        return ladder_msm(G, xs, ys, inf_mask, scalars)
    return _plan(G, n, scalars.shape[0])(xs, ys, inf_mask, scalars)
