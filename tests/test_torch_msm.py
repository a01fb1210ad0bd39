"""gnark_tpu_torch.ops.msm: the signed windowed plan and its four kernels.

  * window recoding and the sort/gather stage against the JAX package's
    own functions (gnark_tpu/ops/msm.py:70, :759), byte for byte;
  * the full MSM (plain path) for G1 and G2 against the native C
    Pippenger and the host curves, with zero scalars, infinity points and
    repeated points;
  * the CUDA kernel sources, compiled for the host with g++ and run one
    thread at a time, against their plain versions, bit for bit, and the
    leaf at the card's group width with its lanes on host threads
    (tests/test_torch_cuda.py runs the kernels themselves on a card).

Tolerance: none.  Limbs compare exactly; result points compare as Python
ints after conversion to affine.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gnark_tpu.backend.native_field import native_msm
from gnark_tpu.curves import BN254
from gnark_tpu.ops import msm as jax_msm
from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops import msm as M
from gnark_tpu_torch.ops.ec import CurveOps, points_to_host
from gnark_tpu_torch.ops.limbs import field_ops, ints_to_limbs
from gnark_tpu_torch.ops.towers import fp2_ops

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "gnark_tpu_torch", "csrc")
R_MOD = BN254.fr.modulus


def _scalar_limbs(vals):
    return ints_to_limbs(vals, BN254.fr.L)


def _edge_scalars(seed, n):
    rng = np.random.default_rng(seed)
    vals = [0, 1, R_MOD - 1, (1 << 256) - 1, 1 << 255]
    vals += [int.from_bytes(rng.bytes(32), "little") for _ in range(n - 5)]
    return vals


# ---- recoding and sort/gather vs the JAX package --------------------------

@pytest.mark.parametrize("c", [5, 9, 11])
def test_window_digits_signed_matches_jax(c):
    limbs = _scalar_limbs(_edge_scalars(13, 32))
    ja, js = jax_msm.window_digits_signed(jnp.asarray(limbs), c)
    ta, ts = M.window_digits_signed(torch.from_numpy(limbs.astype(np.int64)), c)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("c", [4, 8, 13])
def test_window_digits_matches_jax(c):
    limbs = _scalar_limbs(_edge_scalars(14, 32))
    want = jax_msm.window_digits(jnp.asarray(limbs), c)
    got = M.window_digits(torch.from_numpy(limbs.astype(np.int64)), c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sort_gather_matches_jax():
    """Same point rows, digits and signs in; the same [nw, C, L, R]
    blocks (sign in bit 17 of y limb 0) and sorted digits out."""
    n, c, R = 1024, 9, 128
    rng = np.random.default_rng(23)
    L = BN254.fp.L
    xs = rng.integers(0, 1 << 16, (L, n), dtype=np.uint32)
    ys = rng.integers(0, 1 << 16, (L, n), dtype=np.uint32)
    inf = rng.random(n) < 0.1
    scalars = rng.integers(0, 1 << 16, (BN254.fr.L, n), dtype=np.uint32)
    absd, sign = jax_msm.window_digits_signed(jnp.asarray(scalars), c)
    absd = np.where(inf[None], 0, np.asarray(absd))
    sign = np.asarray(sign)
    ysf = ys.copy()
    ysf[0] += inf.astype(np.uint32) << 16
    ptrows = np.concatenate([xs.T, ysf.T], axis=1)

    jplan = jax_msm.MSM.__new__(jax_msm.MSM)
    jplan.c, jplan.R, jplan.C = c, R, n // R
    jplan.n_pad, jplan.nb, jplan.signed = n, 1 << (c - 1), True
    jx, jy, jd = jplan._sort_gather(jnp.asarray(ptrows), jnp.asarray(absd),
                                    absd.shape[0], jnp.asarray(sign))

    tplan = M.MSM.__new__(M.MSM)
    tplan.R, tplan.C, tplan.n_pad = R, n // R, n
    tx, ty, td = tplan._sort_gather(
        torch.from_numpy(ptrows.astype(np.int64)),
        torch.from_numpy(absd.astype(np.int64)),
        torch.from_numpy(sign.astype(np.int64)))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_plan_shape_at_2e16():
    """The cost model picks c = 11 at 2^16: 24 windows, 1024 buckets,
    512 lanes of 128 points."""
    G = CurveOps(field_ops(BN254.fp), b=BN254.b)
    plan = M.MSM(G, 1 << 16, BN254.fr.L)
    assert (plan.c, plan.nwin, plan.nb, plan.R, plan.C) == (11, 24, 1024, 512, 128)


# ---- the plain pipeline against the oracles --------------------------------

def _group(kind):
    if kind == "g1":
        F = field_ops(BN254.fp)
        return CurveOps(F, b=BN254.b), BN254.host_g1, BN254.g1_gen, 0
    F = fp2_ops(BN254.fp, BN254.fp2_beta)
    return CurveOps(F, b=BN254.b2), BN254.host_g2, BN254.g2_gen, (0, 0)


class _Run:
    """One plain-path MSM, step by step, with its intermediates."""

    def __init__(self, kind, n=48, c=6, lanes=8):
        G, H, gen, zero = _group(kind)
        self.G, self.H = G, H
        rng = np.random.default_rng(31 if kind == "g1" else 37)
        pts, P = [], gen
        for _ in range(n):
            pts.append(P)
            P = H.add(P, gen)
        pts[3] = pts[2]                                   # repeated point
        scalars = _edge_scalars(41, n)
        scalars = [s % R_MOD for s in scalars]
        scalars[6] = scalars[7] = 0                       # zero scalars
        inf = np.zeros(n, bool)
        inf[9] = inf[10] = True                           # infinity points
        self.pts, self.scalars, self.inf = pts, scalars, inf
        self.xs = G.F.pack([p[0] for p in pts], "cpu")
        self.ys = G.F.pack([p[1] for p in pts], "cpu")
        self.sc = torch.from_numpy(_scalar_limbs(scalars).astype(np.int64))
        plan = self.plan = M.MSM(G, n, BN254.fr.L, c=c, lanes=lanes)
        GC = plan.GC
        ptrows, dg, sg = plan._prep_window(self.xs, self.ys,
                                           torch.from_numpy(inf), self.sc)
        self.sx, self.sy, d_sorted = plan._sort_gather(ptrows, dg, sg)
        self.rows = M.leaf_prefix_plain(self.sx, self.sy, GC)
        self.tot = plan.lane_totals(self.rows)
        self.offs = M.lane_offsets_plain(self.tot, GC)
        self.bk = plan._buckets(self.rows, self.offs, d_sorted)
        self.S = M.weighted_sum_plain(self.bk, GC)
        self.P = M.horner_fold_plain(self.S, plan.c, GC)
        self.result = points_to_host(
            G, GC.to_jacobian(M.split_points(self.P, G.F.L)))

    def want(self):
        acc = None
        for p, s, i in zip(self.pts, self.scalars, self.inf):
            if not i:
                acc = self.H.add(acc, self.H.scalar_mul(p, s))
        return acc


@pytest.fixture(scope="module")
def runs():
    return {kind: _Run(kind) for kind in ("g1", "g2")}


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_msm_plain_matches_host_curve(runs, kind):
    run = runs[kind]
    assert run.result == [run.want()]


def test_msm_plain_g1_matches_native_msm(runs):
    run = runs["g1"]
    p = BN254.fp.modulus
    xs = BN254.fp.to_limbs([q[0] for q in run.pts], montgomery=False)
    ys = BN254.fp.to_limbs([q[1] for q in run.pts], montgomery=False)
    want = native_msm(BN254, xs, ys, run.inf, _scalar_limbs(run.scalars))
    assert want is not None and run.result == [want]
    assert all(c < p for c in want)


def test_msm_default_plan_g1_at_1024():
    """The default windowed plan (cost-model c, lanes from n) at
    n = 1024.  (``msm`` itself sends so few points to the ladder:
    tests/test_torch_ladder.py.)"""
    G, H, gen, _ = _group("g1")
    n = 1024
    base, P = [], gen
    for _ in range(64):
        base.append(P)
        P = H.double(P)
    xs = G.F.pack([q[0] for q in base], "cpu").repeat(1, n // 64)
    ys = G.F.pack([q[1] for q in base], "cpu").repeat(1, n // 64)
    scalars = [s % R_MOD for s in _edge_scalars(43, n)]
    sc = torch.from_numpy(_scalar_limbs(scalars).astype(np.int64))
    out = M.MSM(G, n, BN254.fr.L)(xs, ys, torch.zeros(n, dtype=torch.bool),
                                  sc)
    total = sum(s << (i % 64) for i, s in enumerate(scalars)) % R_MOD
    assert points_to_host(G, out) == [H.scalar_mul(gen, total)]


# ---- kernel sources on the host ---------------------------------------------

HARNESS = r"""
#include <cstdint>
#include <vector>
struct Dim { unsigned x; };
static Dim blockIdx, threadIdx, blockDim;
#define __global__
#define __shared__ static
#define __launch_bounds__(...)
#define __syncthreads()
#define __syncwarp(mask)
#include "msm_kernels.cu"

// Each grid runs one thread at a time (blockDim 1), which keeps every
// phase between two barriers in order; the leaf runs a group of one
// thread a chain, a block a chain.
template <class Cv> static void grid_leaf(const int64_t* sx, const int64_t* sy,
                                          int64_t* rows, int nw, int C, int R) {
  blockDim.x = 1; threadIdx.x = 0;
  for (long b = 0; b < (long)nw * R; ++b) {
    blockIdx.x = (unsigned)b;
    leaf_prefix_kernel<Cv, 1>(sx, sy, rows, nw, C, R);
  }
}
template <class Cv> static void grid_lanes(const int64_t* t, int64_t* o, int nw, int R) {
  std::vector<Point<typename Cv::F>> s(2 * (long)nw * R);
  blockDim.x = 1; threadIdx.x = 0;
  for (int w = 0; w < nw; ++w) { blockIdx.x = w; lane_offsets_kernel<Cv>(t, o, s.data(), nw, R); }
}
template <class Cv> static void grid_fold(const int64_t* S, int64_t* o, int nw, int c) {
  blockDim.x = 1; threadIdx.x = 0; blockIdx.x = 0;
  horner_fold_kernel<Cv>(S, o, nw, c);
}
template <class Cv> static void grid_wsum(const int64_t* b, int64_t* o, int nw, int nb) {
  std::vector<Point<typename Cv::F>> s((long)nw * (nb + nb / 2));
  blockDim.x = 1; threadIdx.x = 0;
  for (int w = 0; w < nw; ++w) { blockIdx.x = w; weighted_sum_kernel<Cv, 1, 1, 1>(b, o, s.data(), nw, nb); }
}
#define HOST_GRIDS(NAME, CV)                                                  \
  extern "C" void host_leaf_prefix_##NAME(const int64_t* a, const int64_t* b, \
      int64_t* o, int nw, int C, int R) { grid_leaf<CV>(a, b, o, nw, C, R); } \
  extern "C" void host_lane_offsets_##NAME(const int64_t* a, int64_t* o,      \
      int nw, int R) { grid_lanes<CV>(a, o, nw, R); }                         \
  extern "C" void host_weighted_sum_##NAME(const int64_t* a, int64_t* o,      \
      int nw, int nb) { grid_wsum<CV>(a, o, nw, nb); }                        \
  extern "C" void host_horner_fold_##NAME(const int64_t* a, int64_t* o,       \
      int nw, int c) { grid_fold<CV>(a, o, nw, c); }
HOST_GRIDS(g1, G1)
HOST_GRIDS(g2, G2)
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("kernels_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    lib = d / "libkernels_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


# The leaf at the group widths the card runs (Curve::LEAF_GROUP): each
# block of two groups runs on 2 G host threads, and __syncwarp is a
# barrier of the calling thread's group, so the lanes' loads, products
# and stores interleave as on the card, one block at a time.  The weighted
# sum at the card's group width, block size and blocks a window
# (Curve::WSUM_GROUP, WSUM_THREADS, WSUM_CLUSTER), a window's blocks on
# that many host threads, with __syncthreads a barrier over the block and
# cluster_sync one over the window's blocks.
THREADED_HARNESS = r"""
#include <barrier>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>
struct Dim { unsigned x; };
static Dim blockDim;
static thread_local Dim threadIdx, blockIdx;
static int group_size, bad_masks;
// the running cluster's barriers: a group's, a block's, the cluster's
static std::vector<std::unique_ptr<std::barrier<>>> groups, blocks;
static std::unique_ptr<std::barrier<>> cluster;
static unsigned first_block;
static unsigned block_rank() { return blockIdx.x - first_block; }
static void warp_sync(unsigned mask) {
  const unsigned first = threadIdx.x % 32 / group_size * group_size;
  if (mask != ((1u << group_size) - 1u) << first) ++bad_masks;
  groups[block_rank() * (blockDim.x / group_size) + threadIdx.x / group_size]
      ->arrive_and_wait();
}
void cluster_sync() { cluster->arrive_and_wait(); }
#define __global__
#define __shared__ static
#define __launch_bounds__(...)
#define __syncthreads() blocks[block_rank()]->arrive_and_wait()
#define __syncwarp(mask) warp_sync(mask)
#include "msm_kernels.cu"

// blocks b .. b + n - 1, run together as one cluster, of `threads` host
// threads each, in groups of g, each thread running body()
template <class Body> static void run_cluster(unsigned b, int n, int threads,
                                              int g, Body body) {
  first_block = b;
  blockDim.x = threads;
  group_size = g;
  groups.clear();
  blocks.clear();
  for (int i = 0; i < n * threads / g; ++i)
    groups.push_back(std::make_unique<std::barrier<>>(g));
  for (int i = 0; i < n; ++i)
    blocks.push_back(std::make_unique<std::barrier<>>(threads));
  cluster = std::make_unique<std::barrier<>>(n * threads);
  std::vector<std::thread> lanes;
  for (int i = 0; i < n; ++i)
    for (int t = 0; t < threads; ++t)
      lanes.emplace_back([=] {
        blockIdx.x = b + i;
        threadIdx.x = t;
        body();
      });
  for (auto& l : lanes) l.join();
}

template <class Cv> static int grid_leaf_threads(const int64_t* sx,
    const int64_t* sy, int64_t* rows, int nw, int C, int R) {
  constexpr int G = Cv::LEAF_GROUP, per_block = 2;
  bad_masks = 0;
  const long chains = (long)nw * R;
  for (long b = 0; b < (chains + per_block - 1) / per_block; ++b)
    run_cluster((unsigned)b, 1, per_block * G, G,
                [=] { leaf_prefix_kernel<Cv, G>(sx, sy, rows, nw, C, R); });
  return bad_masks;
}
// the weighted sum at its shipped group width, block size and blocks a
// window, a window's cluster at a time
template <class Cv> static int grid_wsum_threads(const int64_t* bk, int64_t* out,
                                                 int nw, int nb) {
  constexpr int G = Cv::WSUM_GROUP, T = Cv::WSUM_THREADS, CL = Cv::WSUM_CLUSTER;
  std::vector<Point<typename Cv::F>> s((long)nw * (nb + nb / 2));
  Point<typename Cv::F>* scratch = s.data();
  bad_masks = 0;
  for (int w = 0; w < nw; ++w)
    run_cluster((unsigned)(w * CL), CL, T, G, [=] {
      weighted_sum_kernel<Cv, G, T, CL>(bk, out, scratch, nw, nb);
    });
  return bad_masks;
}
extern "C" int host_leaf_threads_g1(const int64_t* a, const int64_t* b,
    int64_t* o, int nw, int C, int R) { return grid_leaf_threads<G1>(a, b, o, nw, C, R); }
extern "C" int host_leaf_threads_g2(const int64_t* a, const int64_t* b,
    int64_t* o, int nw, int C, int R) { return grid_leaf_threads<G2>(a, b, o, nw, C, R); }
extern "C" int host_leaf_group_g1() { return G1::LEAF_GROUP; }
extern "C" int host_leaf_group_g2() { return G2::LEAF_GROUP; }
extern "C" int host_wsum_threads_g1(const int64_t* a, int64_t* o, int nw,
    int nb) { return grid_wsum_threads<G1>(a, o, nw, nb); }
extern "C" int host_wsum_threads_g2(const int64_t* a, int64_t* o, int nw,
    int nb) { return grid_wsum_threads<G2>(a, o, nw, nb); }
extern "C" int host_wsum_group_g1() { return G1::WSUM_GROUP; }
extern "C" int host_wsum_group_g2() { return G2::WSUM_GROUP; }
extern "C" int host_wsum_block_g1() { return G1::WSUM_THREADS; }
extern "C" int host_wsum_block_g2() { return G2::WSUM_THREADS; }
extern "C" int host_wsum_cluster_g1() { return G1::WSUM_CLUSTER; }
extern "C" int host_wsum_cluster_g2() { return G2::WSUM_CLUSTER; }
"""


@pytest.fixture(scope="module")
def threaded_leaf(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("leaf_threads")
    src = d / "harness.cpp"
    src.write_text(THREADED_HARNESS)
    lib = d / "libleaf_threads.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", f"-I{CSRC}", "-o", str(lib), str(src)],
                   check=True)
    return ctypes.CDLL(str(lib))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _leaf_case(run, case):
    """The leaf's inputs: the run's own (C = 6, infinity points and
    negative digits), or its first five steps with every point of lane 3
    flagged infinite (C = 5; that lane's rows stay the identity)."""
    if case == "run":
        return run.sx, run.sy
    sx = run.sx[:, :5].contiguous()
    sy = run.sy[:, :5].contiguous()
    sy[:, :, 0, 3] |= 1 << 16
    return sx, sy


@pytest.mark.parametrize("case", ["run", "C=5, lane 3 all infinite"])
@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_leaf_prefix_groups_match_plain_on_host_threads(
        runs, threaded_leaf, kind, case):
    """The leaf source at the card's group width, its lanes on host
    threads, bit for bit against the plain version."""
    run = runs[kind]
    sx, sy = _leaf_case(run, case)
    nw, C, L, R = sx.shape
    want = M.leaf_prefix_plain(sx, sy, run.plan.GC)
    out = torch.empty_like(want)
    fn = getattr(threaded_leaf, f"host_leaf_threads_{kind}")
    assert fn(_ptr(sx), _ptr(sy), _ptr(out), nw, C, R) == 0   # group masks
    assert torch.equal(out, want)
    assert getattr(threaded_leaf, f"host_leaf_group_{kind}")() == \
        _cuda.LEAF_GROUP[kind]


def _wsum_case(run, case):
    """The weighted sum's buckets: the run's own (nb = 32), its first 2 or
    4 buckets (nb = 2: no tree, no doubling), or nb = 1024 over two
    windows of distinct points built from the run's buckets, a third of
    them the identity, with a P + P and a P + (-P) in the top level's fold
    and a P + P in its tree."""
    if case == "run":
        return run.bk
    if case in ("nb=2", "nb=4"):
        return run.bk[:, :, :int(case[3:])].contiguous()
    GC, L = run.plan.GC, run.G.F.L
    Q = M.split_points(run.bk[:, :2].contiguous(), L)
    blocks = [Q]
    for m in range(1, 32):
        blocks.append(GC.add(blocks[-1], tuple(a.roll(m, -1) for a in Q)))
    B = [torch.cat([b[i] for b in blocks], -1) for i in range(3)]
    ident = GC.inf((2, 1024), "cpu")
    gone = (torch.arange(1024) % 3 == 0).expand(2, 1024).clone()
    gone[:, [5, 7, 512 + 5, 512 + 7, 768 + 9, 512 + 9]] = False
    B = [torch.where(gone, i, b) for i, b in zip(ident, B)]
    for i in range(3):
        B[i][..., 512 + 5] = B[i][..., 5]
        B[i][..., 768 + 9] = B[i][..., 512 + 9]
    neg = GC.neg(tuple(b[..., 7:8] for b in B))
    for i in range(3):
        B[i][..., 512 + 7] = neg[i][..., 0]
    return torch.cat(B).contiguous()


@pytest.mark.parametrize("case", ["run", "nb=2", "nb=4",
                                  "nb=1024, nw=2, identities, P+P, P+(-P)"])
@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_weighted_sum_wavefront_matches_plain_on_host_threads(
        runs, threaded_leaf, kind, case):
    """The weighted sum's source at the card's group width and block size,
    every lane on a host thread, bit for bit against the plain version."""
    run = runs[kind]
    bk = _wsum_case(run, case)
    _, nw, nb = bk.shape
    want = M.weighted_sum_plain(bk, run.plan.GC)
    out = torch.empty_like(want)
    fn = getattr(threaded_leaf, f"host_wsum_threads_{kind}")
    assert fn(_ptr(bk), _ptr(out), nw, nb) == 0   # group masks
    assert torch.equal(out, want)
    assert getattr(threaded_leaf, f"host_wsum_group_{kind}")() == \
        _cuda.WSUM_GROUP[kind]
    assert getattr(threaded_leaf, f"host_wsum_block_{kind}")() == \
        _cuda.WSUM_THREADS[kind]
    assert getattr(threaded_leaf, f"host_wsum_cluster_{kind}")() == \
        _cuda.WSUM_CLUSTER[kind]


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_leaf_prefix_source_all_infinite_lane_on_host(runs, host_kernels,
                                                      kind):
    """C = 5 (not a power of two), lane 3's points all infinite, beside
    the run's infinity points and negative digits: the kernel source (a
    group of one) equals the plain version, and lane 3's rows are the
    identity (0 : 1 : 0)."""
    run = runs[kind]
    sx, sy = _leaf_case(run, "C=5, lane 3 all infinite")
    nw, C, L, R = sx.shape
    assert bool((((sy[:, :, 0] >> 17) & 1) != 0).any())
    want = M.leaf_prefix_plain(sx, sy, run.plan.GC)
    ident = torch.cat(run.plan.GC.inf(1, "cpu")).reshape(-1)
    assert all(torch.equal(want[w, cs * R + 3], ident)
               for w in range(nw) for cs in range(C))
    out = torch.empty_like(want)
    getattr(host_kernels, f"host_leaf_prefix_{kind}")(
        _ptr(sx), _ptr(sy), _ptr(out), nw, C, R)
    assert torch.equal(out, want)


@pytest.mark.parametrize("kernel", ["leaf_prefix", "lane_offsets",
                                    "weighted_sum", "horner_fold"])
@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_kernel_source_matches_plain_on_host(runs, host_kernels, kind, kernel):
    run = runs[kind]
    fn = getattr(host_kernels, f"host_{kernel}_{kind}")
    nw, C, L, R = run.sx.shape
    if kernel == "leaf_prefix":
        out = torch.empty_like(run.rows)
        fn(_ptr(run.sx), _ptr(run.sy), _ptr(out), nw, C, R)
        want = run.rows
    elif kernel == "lane_offsets":
        out = torch.empty_like(run.tot)
        fn(_ptr(run.tot), _ptr(out), nw, R)
        want = run.offs
    elif kernel == "weighted_sum":
        out = torch.empty_like(run.S)
        fn(_ptr(run.bk), _ptr(out), nw, run.bk.shape[-1])
        want = run.S
    else:
        out = torch.empty_like(run.P)
        fn(_ptr(run.S), _ptr(out), run.S.shape[1], run.plan.c)
        want = run.P
    assert torch.equal(out, want)


@pytest.mark.parametrize("live", [0, 1, 3])
@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_horner_fold_starts_at_highest_live_window(runs, host_kernels, kind,
                                                   live):
    """Five window sums, the top 5 - ``live`` of them the identity: the
    fold starts at the highest that is not (with none, the result is
    window 0 itself); the plain version against the host sum, the kernel
    source against the plain version, bit for bit."""
    run = runs[kind]
    GC, c, L = run.plan.GC, run.plan.c, run.G.F.L
    S = torch.cat([run.S[:, :live], torch.cat(GC.inf(5 - live, "cpu"))], 1)
    P = M.horner_fold_plain(S, c, GC)
    sums = points_to_host(run.G, GC.to_jacobian(M.split_points(S, L)))
    want = None
    for w, q in enumerate(sums):
        if q is not None:
            want = run.H.add(want, run.H.scalar_mul(q, 1 << (c * w)))
    assert points_to_host(run.G, GC.to_jacobian(M.split_points(P, L))) == [
        want]
    if live == 0:
        assert torch.equal(P, S[:, :1])
    out = torch.empty_like(P)
    getattr(host_kernels, f"host_horner_fold_{kind}")(_ptr(S), _ptr(out), 5, c)
    assert torch.equal(out, P)


def _source_limbs(text, name):
    m = re.search(name + r"\[8\] = \{([^}]*)\}", text)
    return [int(v.strip().rstrip("u"), 16) for v in m.group(1).split(",")]


def test_kernel_constants_match_field_spec():
    """The moduli and constants written into the CUDA sources."""
    field = open(os.path.join(CSRC, "field.cuh")).read()
    kern = open(os.path.join(CSRC, "msm_kernels.cu")).read()
    p = BN254.fp.modulus

    def val(limbs):
        return sum(v << (32 * i) for i, v in enumerate(limbs))

    pm = re.search(r"uint32_t p\(int i\) \{\s*constexpr uint32_t v\[8\] = \{([^}]*)\}",
                   field)
    om = re.search(r"uint32_t one\(int i\) \{\s*constexpr uint32_t v\[8\] = \{([^}]*)\}",
                   field)
    parse = lambda m: [int(v.strip().rstrip("u"), 16) for v in m.group(1).split(",")]
    assert val(parse(pm)) == p
    assert val(parse(om)) == (1 << 256) % p
    inv = int(re.search(r"INV = (0x[0-9a-f]+)u", field).group(1), 16)
    assert (inv * p) % (1 << 32) == (1 << 32) - 1
    b3 = [3 * c % p for c in BN254.b2]
    assert val(_source_limbs(kern, "c0")) == b3[0] * (1 << 256) % p
    assert val(_source_limbs(kern, "c1")) == b3[1] * (1 << 256) % p
    assert BN254.b == 3                       # G1's b3 = 9 as 8a + a


# ---- device routing ----------------------------------------------------------

def test_wrappers_route_by_device(runs):
    run = runs["g1"]
    GC = run.plan.GC
    meta = run.tot.to("meta")
    with pytest.raises(ValueError):
        M.lane_offsets(meta, GC)
    before = dict(_cuda.launches)
    assert torch.equal(M.lane_offsets(run.tot, GC), run.offs)   # CPU: plain
    assert _cuda.launches == before
    assert not any(M.plain_on_cuda.values())

