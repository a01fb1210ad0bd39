"""gnark_tpu_torch.ops.msm: the signed windowed plan and its four kernels.

  * window recoding and the sort/gather stage against the JAX package's
    own functions (gnark_tpu/ops/msm.py:70, :759), byte for byte;
  * the full MSM (plain path) for G1 and G2 against the native C
    Pippenger and the host curves, with zero scalars, infinity points and
    repeated points;
  * the CUDA kernel sources, compiled for the host with g++ and run one
    thread at a time, against their plain versions, bit for bit, and the
    leaf, the lane offsets and the weighted sum at the card's shapes with
    their lanes on host threads, BLS24-315's fp4 kernels (leaf, lane
    offsets, ladder, fold, weighted sum, reduction) also at the widths
    their sweeps try (tests/test_torch_cuda.py runs the kernels
    themselves on a card).

The kinds: BN254's G1 (``g1``) and G2 over fp2 (``g2``), BLS24-315's G1
(``g1_bls24315``) and G2 over fp4 (``g2_bls24315``).

Tolerance: none.  Limbs compare exactly; result points compare as Python
ints after conversion to affine.
"""

import ctypes
import importlib.util
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
from gnark_tpu_torch.curves import BLS24_315
from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops import msm as M
from gnark_tpu_torch.ops.ec import CurveOps, points_to_host
from gnark_tpu_torch.ops.limbs import field_ops, ints_to_limbs
from torch_kinds import KINDS, group, r_mod

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


# the 2^20 prove's MSMs: 2^21 points (2^20 + 1 wires padded), on an 80 GB
# card (as 10^9 and as 2^30 bytes)
N_2E21 = 1 << 21
CARD_80GB = [80 * 10**9, 80 << 30]


@pytest.mark.parametrize("total", CARD_80GB, ids=["80e9", "80GiB"])
@pytest.mark.parametrize("kind", KINDS)
def test_plan_shape_and_window_chunks_at_2e21(kind, total):
    """Pure arithmetic: the 2^21-point plan is c = 14, 19 windows, 8,192
    buckets, 512 lanes of 4,096 points.  Under half an 80 GB card a window
    of G1 (1.34 GB) fits all 19 in one chunk, BN254's G2 (2.68 GB) and
    BLS24-315's fp4 G2 (6.71 GB) need two or more; every chunk's windows
    stay under the cap and the chunks are balanced (sizes differ by at
    most one window less in the last)."""
    G = group(kind)[0]
    plan = M.MSM(G, N_2E21, 16)
    assert (plan.c, plan.nwin, plan.nb, plan.R, plan.C, plan.n_pad) == \
        (14, 19, 8192, 512, 4096, N_2E21)
    per = M.window_bytes(plan.n_pad, G.F.L)
    assert per == N_2E21 * 5 * G.F.L * 8
    cap = M.memory_cap(total)
    chunks = M.window_chunks(plan.nwin, per, cap)
    assert chunks[0][0] == 0 and chunks[-1][1] == plan.nwin
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    sizes = [w1 - w0 for w0, w1 in chunks]
    assert all(s * per <= cap for s in sizes), (sizes, per, cap)
    assert all(s == sizes[0] for s in sizes[:-1]) and sizes[-1] <= sizes[0]
    assert len(chunks) == -(-plan.nwin // (cap // per))
    if kind in ("g2", "g2_bls24315"):
        assert len(chunks) >= 2, chunks
    if kind == "g1":
        assert chunks == [(0, 19)]


@pytest.mark.parametrize("kind", KINDS)
def test_2e16_plan_runs_one_chunk(kind):
    """The 2^16 plan's 24 windows fit one chunk on an 80 GB card, so the
    path measured so far does not change; with no cap (the CPU) every plan
    runs one chunk."""
    G = group(kind)[0]
    plan = M.MSM(G, 1 << 16, 16)
    per = M.window_bytes(plan.n_pad, G.F.L)
    for total in CARD_80GB:
        assert M.window_chunks(plan.nwin, per, M.memory_cap(total)) == \
            [(0, 24)]
    assert plan.chunks("cpu") == [(0, 24)]
    assert M.window_chunks(19, 10, 10) == [(w, w + 1) for w in range(19)]
    assert M.window_chunks(32, 1, 31) == [(0, 16), (16, 32)]


# ---- the plain pipeline against the oracles --------------------------------


class _Run:
    """One plain-path MSM, step by step, with its intermediates."""

    def __init__(self, kind, n=48, c=6, lanes=8):
        G, H, gen, zero = group(kind)
        self.G, self.H = G, H
        q = r_mod(kind)
        rng = np.random.default_rng(31 if kind == "g1" else 37)
        pts, P = [], gen
        for _ in range(n):
            pts.append(P)
            P = H.add(P, gen)
        pts[3] = pts[2]                                   # repeated point
        scalars = _edge_scalars(41, n)
        scalars = [s % q for s in scalars]
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
    return {kind: _Run(kind) for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS)
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
    G, H, gen, _ = group("g1")
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
// phase between two barriers in order; the leaf (a curve's shipped one:
// leaf_sliced_kernel over fp4) runs a group of one thread a chain, a
// block a chain.
template <class Cv, int G> static void leaf_kernel(const int64_t* sx,
    const int64_t* sy, int64_t* rows, int nw, int C, int R) {
  if constexpr (FpKTraits<typename Cv::F>::SLICED)
    leaf_sliced_kernel<Cv, G, Cv::LEAF_THREADS, Cv::LEAF_BLOCKS>(sx, sy, rows,
                                                                 nw, C, R);
  else
    leaf_prefix_kernel<Cv, G>(sx, sy, rows, nw, C, R);
}
template <class Cv> static void grid_leaf(const int64_t* sx, const int64_t* sy,
                                          int64_t* rows, int nw, int C, int R) {
  blockDim.x = 1; threadIdx.x = 0;
  for (long b = 0; b < (long)nw * R; ++b) {
    blockIdx.x = (unsigned)b;
    leaf_kernel<Cv, 1>(sx, sy, rows, nw, C, R);
  }
}
template <class Cv> static void grid_lanes(const int64_t* t, int64_t* o, int nw, int R) {
  std::vector<Point<typename Cv::F>> s((long)nw * R);
  blockDim.x = 1; threadIdx.x = 0;
  for (int w = 0; w < nw; ++w) {
    blockIdx.x = w;
    if constexpr (FpKTraits<typename Cv::F>::SLICED)   // fp4's shipped scan
      lane_offsets_sliced_kernel<Cv, 1, 1, 1>(t, o, s.data(), nw, R);
    else
      lane_offsets_kernel<Cv, 1, 1, 1>(t, o, s.data(), nw, R);
  }
}
template <class Cv> static void grid_fold(const int64_t* S, int64_t* o, int nw, int c) {
  blockDim.x = 1; threadIdx.x = 0; blockIdx.x = 0;
  if constexpr (FpKTraits<typename Cv::F>::SLICED)   // fp4's shipped fold
    horner_fold_sliced_kernel<Cv, 1>(S, o, nw, c);
  else
    horner_fold_kernel<Cv>(S, o, nw, c);
}
template <class Cv> static void grid_wsum(const int64_t* b, int64_t* o, int nw, int nb) {
  std::vector<Point<typename Cv::F>> s((long)nw * (nb + nb / 2));
  blockDim.x = 1; threadIdx.x = 0;
  for (int w = 0; w < nw; ++w) {
    blockIdx.x = w;
    if constexpr (FpKTraits<typename Cv::F>::SLICED)   // fp4's shipped sum
      weighted_sum_sliced_kernel<Cv, 1, 1, 1>(b, o, s.data(), nw, nb);
    else
      weighted_sum_kernel<Cv, 1, 1, 1>(b, o, s.data(), nw, nb);
  }
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
HOST_GRIDS(g1_bls24315, G1Bls24)
HOST_GRIDS(g2_bls24315, G2Bls24)
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
# cluster_sync one over the window's blocks; the lane offsets the same way
# at theirs (Curve::LANES_GROUP, LANES_THREADS, LANES_CLUSTER), the narrow
# steps on one block.
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

// a curve's shipped leaf: leaf_sliced_kernel over fp4
template <class Cv, int G> static void leaf_kernel(const int64_t* sx,
    const int64_t* sy, int64_t* rows, int nw, int C, int R) {
  if constexpr (FpKTraits<typename Cv::F>::SLICED)
    leaf_sliced_kernel<Cv, G, Cv::LEAF_THREADS, Cv::LEAF_BLOCKS>(sx, sy, rows,
                                                                 nw, C, R);
  else
    leaf_prefix_kernel<Cv, G>(sx, sy, rows, nw, C, R);
}
template <class Cv> static int grid_leaf_threads(const int64_t* sx,
    const int64_t* sy, int64_t* rows, int nw, int C, int R) {
  constexpr int G = Cv::LEAF_GROUP, per_block = 2;
  bad_masks = 0;
  const long chains = (long)nw * R;
  for (long b = 0; b < (chains + per_block - 1) / per_block; ++b)
    run_cluster((unsigned)b, 1, per_block * G, G,
                [=] { leaf_kernel<Cv, G>(sx, sy, rows, nw, C, R); });
  return bad_masks;
}
// the sliced fp4 product and b3 multiply (Sliced::mul, mul_b3) over n
// element pairs at group width G, a group a block on G host threads: out
// holds a b, then b3 a, then b3 b ([3 kL, n])
template <int G> static int sliced_mul_threads(const int64_t* a,
    const int64_t* b, int64_t* out, int n) {
  using Cv = G2Bls24;
  using SL = Sliced<Cv, G, Cv::LEAF_THREADS>;
  using P = SL::P;
  constexpr int KPL = SL::KPL, L = Fp<P>::L16, KL = SL::K * L;
  bad_masks = 0;
  for (int e = 0; e < n; ++e)
    run_cluster((unsigned)e, 1, G, G, [=] {
      static XSlot<P> ex[SL::SLOTS][Cv::LEAF_THREADS];
      const int tid = threadIdx.x, lane = tid % G, half = lane / SL::SPAN;
      const SL sl{ex, tid, tid - lane + half * SL::SPAN, lane % SL::SPAN,
                  half, GroupSync{((1u << G) - 1u) << (tid % 32 / G * G)}};
      typename SL::B x[KPL], y[KPL], r[KPL], r1[KPL], r2[KPL];
      for (int t = 0; t < KPL; ++t) {
        const int m = sl.coef(t);
        x[t] = load<P>(a + (long)m * L * n + e, n);
        y[t] = load<P>(b + (long)m * L * n + e, n);
        const typename SL::B c = Cv::b3().c[Cv::B3_COEF];
        slot_put(ex[SL::KB3 + t][tid],
                 Cv::B3_COEF > m ? mul_const<SL::NR>(c) : c);
      }
      sl.mul(r, x, y);
      sl.mul_b3(r1, x, r2, y);
      if (half) return;
      for (int t = 0; t < KPL; ++t) {
        const long m = sl.coef(t);
        store(r[t], out + m * L * n + e, n);
        store(r1[t], out + (KL + m * L) * n + e, n);
        store(r2[t], out + (2 * KL + m * L) * n + e, n);
      }
    });
  return bad_masks;
}
// the fp4 leaf at any width of the sweep (ops/leaf_groups.py), two groups
// a block
template <int G> static int grid_sliced_threads(const int64_t* sx,
    const int64_t* sy, int64_t* rows, int nw, int C, int R) {
  using Cv = G2Bls24;
  bad_masks = 0;
  const long chains = (long)nw * R;
  for (long b = 0; b < (chains + 1) / 2; ++b)
    run_cluster((unsigned)b, 1, 2 * G, G, [=] {
      leaf_sliced_kernel<Cv, G, Cv::LEAF_THREADS, Cv::LEAF_BLOCKS>(
          sx, sy, rows, nw, C, R);
    });
  return bad_masks;
}
extern "C" int host_leaf_sliced_threads(int G, const int64_t* sx,
    const int64_t* sy, int64_t* rows, int nw, int C, int R) {
  switch (G) {
    case 1: return grid_sliced_threads<1>(sx, sy, rows, nw, C, R);
    case 2: return grid_sliced_threads<2>(sx, sy, rows, nw, C, R);
    case 4: return grid_sliced_threads<4>(sx, sy, rows, nw, C, R);
    case 8: return grid_sliced_threads<8>(sx, sy, rows, nw, C, R);
  }
  return -1;
}
extern "C" int host_sliced_mul(int G, const int64_t* a, const int64_t* b,
                               int64_t* out, int n) {
  switch (G) {
    case 1: return sliced_mul_threads<1>(a, b, out, n);
    case 2: return sliced_mul_threads<2>(a, b, out, n);
    case 4: return sliced_mul_threads<4>(a, b, out, n);
    case 8: return sliced_mul_threads<8>(a, b, out, n);
  }
  return -1;
}
// the sliced complete addition and doubling (SlicedPoint::padd, pdbl) over
// n pairs of fp4 points at group width G, a group a block on G host
// threads: sum gets p + q, twice 2 p ([3 kL, n] each)
template <int G> static int sliced_point_threads(const int64_t* p,
    const int64_t* q, int64_t* sum, int64_t* twice, int n) {
  using Cv = G2Bls24;
  using SP = SlicedPoint<Cv, G>;
  using B = SP::B;
  constexpr int KPL = SP::KPL;
  bad_masks = 0;
  for (int e = 0; e < n; ++e)
    run_cluster((unsigned)e, 1, G, G, [=] {
      static FoldSlicedShared<Cv, G> sh;
      const int tid = threadIdx.x, lane = tid % G;
      for (int m = tid; m < SP::K; m += G) slot_put(sh.kb3[m], SP::b3_column(m));
      __syncthreads();
      const SP sp{sh.slots, sh.kb3, lane % SP::SPAN, lane / SP::SPAN,
                  GroupSync{((1u << G) - 1u) << (tid % 32 / G * G)}};
      B X[KPL], Y[KPL], Z[KPL], X2[KPL], Y2[KPL], Z2[KPL];
      load_sliced(sp, p + e, n, X, Y, Z);
      load_sliced(sp, q + e, n, X2, Y2, Z2);
      B DX[KPL], DY[KPL], DZ[KPL];
      for (int t = 0; t < KPL; ++t) {
        DX[t] = X[t];
        DY[t] = Y[t];
        DZ[t] = Z[t];
      }
      sp.pdbl(DX, DY, DZ);
      sp.padd(X, Y, Z, X2, Y2, Z2);
      store_sliced(sp, sum + e, n, X, Y, Z);
      store_sliced(sp, twice + e, n, DX, DY, DZ);
    });
  return bad_masks;
}
extern "C" int host_sliced_point_ops(int G, const int64_t* p, const int64_t* q,
                                     int64_t* sum, int64_t* twice, int n) {
  switch (G) {
    case 1: return sliced_point_threads<1>(p, q, sum, twice, n);
    case 2: return sliced_point_threads<2>(p, q, sum, twice, n);
    case 4: return sliced_point_threads<4>(p, q, sum, twice, n);
    case 8: return sliced_point_threads<8>(p, q, sum, twice, n);
    case 16: return sliced_point_threads<16>(p, q, sum, twice, n);
  }
  return -1;
}
// the fp4 ladder (ladder_sliced_kernel) at group width G in blocks of T
// host threads, a block at a time
template <int G, int T> static int ladder_sliced_threads(const int64_t* xs,
    const int64_t* ys, const uint8_t* inf, const int64_t* sc, int64_t* out,
    int n, int Ls) {
  bad_masks = 0;
  const long chains = (long)n * LADDER_CHUNKS;
  for (long b = 0; b < (chains + T / G - 1) / (T / G); ++b)
    run_cluster((unsigned)b, 1, T, G, [=] {
      ladder_sliced_kernel<G2Bls24, G, T, 1>(xs, ys, inf, sc, out, n, Ls);
    });
  return bad_masks;
}
#define LADDER_SHAPE(G, T)                                                    \
  if (g == G && t == T)                                                       \
    return ladder_sliced_threads<G, T>(xs, ys, inf, sc, out, n, Ls);
extern "C" int host_ladder_sliced_threads(int g, int t, const int64_t* xs,
    const int64_t* ys, const uint8_t* inf, const int64_t* sc, int64_t* out,
    int n, int Ls) {
  LADDER_SHAPE(1, 16) LADDER_SHAPE(2, 32) LADDER_SHAPE(4, 64)
  LADDER_SHAPE(4, 128) LADDER_SHAPE(8, 64) LADDER_SHAPE(8, 128)
  return -1;
}
// the fp4 Horner fold (horner_fold_sliced_kernel) on G host threads
template <int G> static int fold_sliced_threads(const int64_t* S, int64_t* out,
                                                int nw, int c) {
  bad_masks = 0;
  run_cluster(0, 1, G, G,
              [=] { horner_fold_sliced_kernel<G2Bls24, G>(S, out, nw, c); });
  return bad_masks;
}
extern "C" int host_fold_sliced_threads(int G, const int64_t* S, int64_t* out,
                                        int nw, int c) {
  switch (G) {
    case 1: return fold_sliced_threads<1>(S, out, nw, c);
    case 2: return fold_sliced_threads<2>(S, out, nw, c);
    case 4: return fold_sliced_threads<4>(S, out, nw, c);
    case 8: return fold_sliced_threads<8>(S, out, nw, c);
    case 16: return fold_sliced_threads<16>(S, out, nw, c);
  }
  return -1;
}
// the weighted sum at its shipped group width, block size and blocks a
// window, a window's cluster at a time
template <class Cv, int G = Cv::WSUM_GROUP, int T = Cv::WSUM_THREADS,
          int CL = Cv::WSUM_CLUSTER>
static int grid_wsum_threads(const int64_t* bk, int64_t* out, int nw, int nb) {
  std::vector<Point<typename Cv::F>> s((long)nw * (nb + nb / 2));
  Point<typename Cv::F>* scratch = s.data();
  bad_masks = 0;
  for (int w = 0; w < nw; ++w)
    run_cluster((unsigned)(w * CL), CL, T, G, [=] {
      if constexpr (FpKTraits<typename Cv::F>::SLICED)   // fp4's shipped sum
        weighted_sum_sliced_kernel<Cv, G, T, CL>(bk, out, scratch, nw, nb);
      else
        weighted_sum_kernel<Cv, G, T, CL>(bk, out, scratch, nw, nb);
    });
  return bad_masks;
}
// the fp4 reduction (reduce_sliced_kernel) at group width G in blocks of T
// host threads, CL blocks a chunk, a chunk's cluster at a time
template <int G, int T, int CL>
static int reduce_sliced_threads(const int64_t* pts, int64_t* out, int n,
                                 int K) {
  std::vector<Point<G2Bls24::F>> s((long)K * REDUCE_LANES);
  Point<G2Bls24::F>* scratch = s.data();
  bad_masks = 0;
  for (int j = 0; j < K; ++j)
    run_cluster((unsigned)(j * CL), CL, T, G, [=] {
      reduce_sliced_kernel<G2Bls24, G, T, CL>(pts, out, scratch, n, K);
    });
  return bad_masks;
}
// the fp4 weighted sum and reduction at the trial shapes (G, T, CL) of
// ops/leaf_groups.py that the tests take
#define FP4_SHAPE(G, T, CL)                                                   \
  if (g == G && t == T && cl == CL)                                           \
    return fn.template operator()<G, T, CL>();
template <class Fn> static int fp4_shape(int g, int t, int cl, Fn fn) {
  FP4_SHAPE(4, 128, 8) FP4_SHAPE(8, 256, 4) FP4_SHAPE(8, 128, 8)
  FP4_SHAPE(16, 256, 8)
  return -1;
}
extern "C" int host_wsum_sliced_threads(int g, int t, int cl, const int64_t* bk,
                                        int64_t* out, int nw, int nb) {
  return fp4_shape(g, t, cl, [=]<int G, int T, int CL>() {
    return grid_wsum_threads<G2Bls24, G, T, CL>(bk, out, nw, nb);
  });
}
extern "C" int host_reduce_sliced_threads(int g, int t, int cl,
                                          const int64_t* pts, int64_t* out,
                                          int n, int K) {
  return fp4_shape(g, t, cl, [=]<int G, int T, int CL>() {
    return reduce_sliced_threads<G, T, CL>(pts, out, n, K);
  });
}
// the lane offsets at their shipped group width, block size and blocks a
// window (or, over fp4, at any of the trial shapes), the narrow steps on
// one block, a window's cluster at a time
template <class Cv, int G = Cv::LANES_GROUP, int T = Cv::LANES_THREADS,
          int CL = Cv::LANES_CLUSTER>
static int grid_lanes_threads(const int64_t* tot, int64_t* out, int nw,
                              int R) {
  std::vector<Point<typename Cv::F>> s((long)nw * R);
  Point<typename Cv::F>* scratch = s.data();
  bad_masks = 0;
  for (int w = 0; w < nw; ++w)
    run_cluster((unsigned)(w * CL), CL, T, G, [=] {
      if constexpr (FpKTraits<typename Cv::F>::SLICED)   // fp4's shipped scan
        lane_offsets_sliced_kernel<Cv, G, T, CL>(tot, out, scratch, nw, R);
      else
        lane_offsets_kernel<Cv, G, T, CL>(tot, out, scratch, nw, R);
    });
  return bad_masks;
}
extern "C" int host_lanes_sliced_threads(int g, int t, int cl,
                                         const int64_t* tot, int64_t* out,
                                         int nw, int R) {
  return fp4_shape(g, t, cl, [=]<int G, int T, int CL>() {
    return grid_lanes_threads<G2Bls24, G, T, CL>(tot, out, nw, R);
  });
}
#define LANES_SHAPE(NAME, CV)                                                 \
  extern "C" int host_lanes_threads_##NAME(const int64_t* a, int64_t* o,      \
      int nw, int R) { return grid_lanes_threads<CV>(a, o, nw, R); }          \
  extern "C" int host_lanes_shape_##NAME(int i) {                             \
    const int v[3] = {CV::LANES_GROUP, CV::LANES_THREADS,                     \
                      CV::LANES_CLUSTER};                                     \
    return v[i];                                                              \
  }
#define SHAPES(NAME, CV)                                                      \
  LANES_SHAPE(NAME, CV)                                                       \
  GNARK_MSM_SHAPE(NAME, CV)                                                   \
  extern "C" int host_leaf_threads_##NAME(const int64_t* a, const int64_t* b, \
      int64_t* o, int nw, int C, int R) {                                     \
    return grid_leaf_threads<CV>(a, b, o, nw, C, R); }                        \
  extern "C" int host_leaf_group_##NAME() { return CV::LEAF_GROUP; }          \
  extern "C" int host_wsum_threads_##NAME(const int64_t* a, int64_t* o,       \
      int nw, int nb) { return grid_wsum_threads<CV>(a, o, nw, nb); }         \
  extern "C" int host_wsum_group_##NAME() { return CV::WSUM_GROUP; }          \
  extern "C" int host_wsum_block_##NAME() { return CV::WSUM_THREADS; }        \
  extern "C" int host_wsum_cluster_##NAME() { return CV::WSUM_CLUSTER; }
SHAPES(g1, G1)
SHAPES(g2, G2)
SHAPES(g1_bls24315, G1Bls24)
SHAPES(g2_bls24315, G2Bls24)
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


def _shape(lib, kind):
    """The kind's shape as ``_cuda.read_shape`` reads the source's
    GNARK_MSM_SHAPE: its names must fall on the constants the threaded
    runs used."""
    return _cuda.read_shape(getattr(lib, f"gnark_msm_shape_{kind}"))


SLICED_WIDTHS = [1, 2, 4, 8]


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
@pytest.mark.parametrize("kind", KINDS)
def test_leaf_prefix_groups_match_plain_on_host_threads(
        runs, threaded_leaf, kind, case):
    """The leaf source at the card's group width, its lanes on host
    threads, bit for bit against the plain version (fp4: the
    coefficient-sliced leaf_sliced_kernel)."""
    run = runs[kind]
    sx, sy = _leaf_case(run, case)
    nw, C, L, R = sx.shape
    want = M.leaf_prefix_plain(sx, sy, run.plan.GC)
    out = torch.empty_like(want)
    fn = getattr(threaded_leaf, f"host_leaf_threads_{kind}")
    assert fn(_ptr(sx), _ptr(sy), _ptr(out), nw, C, R) == 0   # group masks
    assert torch.equal(out, want)
    shape = _shape(threaded_leaf, kind)
    assert getattr(threaded_leaf, f"host_leaf_group_{kind}")() == \
        shape["leaf_group"]
    assert shape["leaf_sliced"] == (kind == "g2_bls24315")   # fp4's leaf


@pytest.mark.parametrize("case", ["run", "C=5, lane 3 all infinite"])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_leaf_sliced_widths_match_plain_on_host_threads(
        runs, threaded_leaf, width, case):
    """The fp4 leaf (leaf_sliced_kernel) at the widths besides the shipped
    G = 8 (a lane pair a coefficient; the test above): four, two and one
    coefficients a lane at G = 1, 2 and 4, which ops/leaf_groups.py
    sweeps; bit for bit against the plain version."""
    run = runs["g2_bls24315"]
    sx, sy = _leaf_case(run, case)
    nw, C, L, R = sx.shape
    want = M.leaf_prefix_plain(sx, sy, run.plan.GC)
    out = torch.empty_like(want)
    assert threaded_leaf.host_leaf_sliced_threads(
        width, _ptr(sx), _ptr(sy), _ptr(out), nw, C, R) == 0   # group masks
    assert torch.equal(out, want)


def _fp4_mul_ints(a, b, p, nr=13):
    """a b in fp4 = fp[u]/(u^4 - nr) over Python ints."""
    r = [0] * 4
    for i in range(4):
        for j in range(4):
            k = i + j
            r[k % 4] += a[i] * b[j] * (nr if k >= 4 else 1)
    return tuple(x % p for x in r)


def _fp4_operands():
    """Pairs of fp4 elements: 0, 1 and p - 1 in every coefficient, whole
    zeros and ones, zero coefficients beside full ones, and random ones."""
    p = BLS24_315.fp.modulus
    rng = np.random.default_rng(53)

    def rand():
        return int.from_bytes(rng.bytes(40), "little") % p
    edge = [0, 1, p - 1]
    a = [tuple(edge[(i + k) % 3] for k in range(4)) for i in range(3)]
    b = [tuple(edge[(i + 2 * k) % 3] for k in range(4)) for i in range(3)]
    a += [(0, 0, 0, 0), (1, 0, 0, 0), (p - 1,) * 4, (rand(), 0, rand(), 0),
          (0, 0, 0, rand()), (rand(), rand(), rand(), rand())]
    b += [(rand(), rand(), rand(), rand()), (p - 1, 0, 0, p - 1), (p - 1,) * 4,
          (0, rand(), 0, rand()), (0, 0, 0, 1), (rand(), rand(), 0, 0)]
    return a, b


@pytest.mark.parametrize("width", SLICED_WIDTHS)
def test_sliced_fp4_product_and_b3_on_host_threads(threaded_leaf, width):
    """Sliced::mul and mul_b3 (a lane's columns of an fp4 product, and b3
    times an element, b3 = (0, 0, 0, 3/13)) at group width G on G host
    threads, against FpKOps.mul and CompleteOps' b3 product bit for bit
    and against Python ints."""
    G = group("g2_bls24315")[0]
    F, p = G.F, BLS24_315.fp.modulus
    a_ints, b_ints = _fp4_operands()
    a, b = F.pack(a_ints, "cpu"), F.pack(b_ints, "cpu")
    n = a.shape[1]
    out = torch.empty((3 * F.L, n), dtype=torch.int64)
    assert threaded_leaf.host_sliced_mul(width, _ptr(a), _ptr(b), _ptr(out),
                                         n) == 0   # group masks
    GC = M.complete_ops(G)
    assert torch.equal(out[:F.L], F.mul(a, b))
    assert torch.equal(out[F.L:2 * F.L], GC._mul_b3(a))
    assert torch.equal(out[2 * F.L:], GC._mul_b3(b))
    b3 = tuple(3 * c % p for c in BLS24_315.b2)
    assert F.unpack(out[:F.L]) == [_fp4_mul_ints(x, y, p)
                                   for x, y in zip(a_ints, b_ints)]
    assert F.unpack(out[F.L:2 * F.L]) == [_fp4_mul_ints(x, b3, p)
                                          for x in a_ints]
    assert F.unpack(out[2 * F.L:]) == [_fp4_mul_ints(y, b3, p)
                                       for y in b_ints]


def _fp4_point_pairs():
    """Pairs (P, Q) of projective fp4 points of G2 as [3 kL, n] planes:
    the identity (0 : 1 : 0) on either side and on both, P + P (the same
    representative, and another: P + O rescales P), P + (-P), and points
    with Z = 1 (affine) and Z != 1 (doubles)."""
    G, H, gen, _ = group("g2_bls24315")
    GC = M.complete_ops(G)
    pts, P = [], gen
    for _ in range(6):
        pts.append(P)
        P = H.add(P, gen)
    A = (G.F.pack([q[0] for q in pts], "cpu"),
         G.F.pack([q[1] for q in pts], "cpu"), G.F.ones(6, "cpu"))
    D = GC.double(A)
    O = GC.inf(1, "cpu")

    def col(T, i):
        return tuple(t[:, i:i + 1] for t in T)
    pairs = [(O, col(A, 0)), (col(A, 1), O), (O, O),
             (col(D, 2), col(D, 2)), (col(D, 3), GC.add(col(D, 3), O)),
             (col(A, 4), GC.neg(col(A, 4))), (col(D, 5), GC.neg(col(D, 5))),
             (col(A, 0), col(D, 1)), (col(D, 0), col(A, 5)),
             (col(D, 1), col(D, 4))]
    Pp, Qp = (torch.cat([torch.cat([pq[side][i] for pq in pairs], -1)
                         for i in range(3)]) for side in (0, 1))
    return GC, Pp, Qp


# the widths of the sliced point operations: a lane four, two or one
# coefficients, or two or four lanes a coefficient (G = 8, 16)
POINT_WIDTHS = SLICED_WIDTHS + [16]


@pytest.mark.parametrize("width", POINT_WIDTHS)
def test_sliced_fp4_point_ops_on_host_threads(threaded_leaf, width):
    """SlicedPoint::padd and pdbl (alg 7 and alg 9 over a point's fp4
    coefficients split over G lanes, each formula's products as levels)
    at group width G on G host threads, bit for bit against the plain
    complete addition and doubling: with the identity, P + P and
    P + (-P)."""
    GC, Pp, Qp = _fp4_point_pairs()
    L = GC.F.L
    n = Pp.shape[1]
    P, Q = M.split_points(Pp, L), M.split_points(Qp, L)
    total, twice = torch.empty_like(Pp), torch.empty_like(Pp)
    assert threaded_leaf.host_sliced_point_ops(
        width, _ptr(Pp), _ptr(Qp), _ptr(total), _ptr(twice), n) == 0
    assert torch.equal(total, torch.cat(GC.add(P, Q)))
    assert torch.equal(twice, torch.cat(GC.double(P)))
    ident = torch.cat(GC.inf(1, "cpu"))[:, 0]
    assert torch.equal(total[:, 2], ident)                  # O + O


# the fp4 ladder's trial shapes in the threaded harness, (G, threads a
# block): one point a block at G = 1, 2, 4, 8, two at (4, 128), half a
# point's chunks at (8, 64)
LADDER_HOST_SHAPES = [(1, 16), (2, 32), (4, 64), (4, 128), (8, 64), (8, 128)]


@pytest.fixture(scope="module")
def fp4_ladder():
    """20 fp4 points k G (the 4th repeating the 3rd, the 7th and 14th
    infinite) and 128-bit scalars (8 limbs: 16 chunks of 8 bits, two
    windows, so 4 doublings and 2 table additions a chain, in a third of
    the full width's plain time) with zero chunks (0, 1, 5, 2^127 beside
    2^128 - 1 and random ones), with the plain ladder's output."""
    G, H, gen, _ = group("g2_bls24315")
    n = 20
    pts = [gen]
    for _ in range(n - 1):
        pts.append(H.add(pts[-1], gen))
    pts[3] = pts[2]
    rng = np.random.default_rng(59)
    scalars = [0, 1, 5, 1 << 127, (1 << 128) - 1, 0, 3 << 120, 2] + [
        int.from_bytes(rng.bytes(16), "little") for _ in range(n - 8)]
    inf = np.zeros(n, bool)
    inf[[6, 13]] = True
    args = (G.F.pack([p[0] for p in pts], "cpu"),
            G.F.pack([p[1] for p in pts], "cpu"), torch.from_numpy(inf),
            torch.from_numpy(ints_to_limbs(scalars, 8).astype(np.int64)))
    return args, M.ladder_plain(*args, M.complete_ops(G))


@pytest.mark.parametrize("shape", LADDER_HOST_SHAPES,
                         ids=[f"G={g},T={t}" for g, t in LADDER_HOST_SHAPES])
def test_ladder_sliced_matches_plain_on_host_threads(threaded_leaf,
                                                     fp4_ladder, shape):
    """The fp4 ladder (ladder_sliced_kernel) at group width G in blocks of
    T threads, every lane on a host thread: the table built by the
    block's groups, each chain on a group; bit for bit against the plain
    ladder, with infinity points and chunks whose digits are all zero.
    The shipped shape is among them."""
    (xs, ys, inf, sc), want = fp4_ladder
    n = xs.shape[1]
    out = torch.empty_like(want)
    g, t = shape
    assert threaded_leaf.host_ladder_sliced_threads(
        g, t, _ptr(xs), _ptr(ys), _ptr(inf), _ptr(sc), _ptr(out), n,
        sc.shape[0]) == 0   # group masks
    assert torch.equal(out, want)
    ship = _shape(threaded_leaf, "g2_bls24315")
    assert (ship["ladder_group"], ship["ladder_threads"]) in \
        LADDER_HOST_SHAPES


@pytest.fixture(scope="module")
def fp4_folds(runs):
    """{live: (S, c, the plain fold)}: five window sums of the run, the
    top 5 - live of them the identity; and the ladder's chunk fold's
    shape, 16 sums at c = 16."""
    run = runs["g2_bls24315"]
    GC, c = run.plan.GC, run.plan.c
    cases = {live: (torch.cat([run.S[:, :live],
                               torch.cat(GC.inf(5 - live, "cpu"))], 1), c)
             for live in (0, 1, 3)}
    cases["chunks nw=16, c=16"] = (run.S[:, :16].contiguous(), 16)
    return {k: (S, c, M.horner_fold_plain(S, c, GC))
            for k, (S, c) in cases.items()}


@pytest.mark.parametrize("live", [0, 1, 3, "chunks nw=16, c=16"])
@pytest.mark.parametrize("width", POINT_WIDTHS)
def test_fold_sliced_matches_plain_on_host_threads(threaded_leaf, fp4_folds,
                                                   width, live):
    """The fp4 Horner fold (horner_fold_sliced_kernel) on one group of G
    host threads: five window sums, the top 5 - ``live`` of them the
    identity (the fold starts at the highest live one), or the ladder's
    chunk fold's shape (16 sums, c = 16); bit for bit against the plain
    fold."""
    S, c, want = fp4_folds[live]
    out = torch.empty_like(want)
    assert threaded_leaf.host_fold_sliced_threads(
        width, _ptr(S), _ptr(out), S.shape[1], c) == 0   # group masks
    assert torch.equal(out, want)
    assert _shape(threaded_leaf, "g2_bls24315")["fold_group"] in \
        POINT_WIDTHS


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
@pytest.mark.parametrize("kind", KINDS)
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
    shape = _shape(threaded_leaf, kind)
    assert getattr(threaded_leaf, f"host_wsum_group_{kind}")() == \
        shape["wsum_group"]
    assert getattr(threaded_leaf, f"host_wsum_block_{kind}")() == \
        shape["wsum_threads"]
    assert getattr(threaded_leaf, f"host_wsum_cluster_{kind}")() == \
        shape["wsum_cluster"]


def _wsum_8192(run):
    """nb = 8,192 buckets in one window, the 2^21 plan's count: the run's
    first window's 32 buckets, then eight rounds that each append every
    bucket plus its neighbour, a third of the result the identity."""
    GC = run.plan.GC
    B = M.split_points(run.bk[:, :1].contiguous(), run.G.F.L)
    while B[0].shape[-1] < 8192:
        B = tuple(torch.cat([a, s], -1) for a, s in zip(
            B, GC.add(B, tuple(a.roll(1, -1) for a in B))))
    gone = torch.arange(8192) % 3 == 1
    B = [torch.where(gone, i, b) for i, b in zip(GC.inf((1, 8192), "cpu"), B)]
    return torch.cat(B).contiguous()


def test_weighted_sum_wavefront_at_2e21_plan_buckets_on_host_threads(
        runs, threaded_leaf):
    """BN254 G1's weighted sum at the 2^21 plan's 8,192 buckets (37 steps
    of the wavefront; the card's runs so far reached 28 at 1,024), one
    window, its cluster on host threads at the shipped shape, bit for bit
    against the plain version."""
    run = runs["g1"]
    bk = _wsum_8192(run)
    assert bk.shape == (48, 1, 8192)
    want = M.weighted_sum_plain(bk, run.plan.GC)
    out = torch.empty_like(want)
    assert threaded_leaf.host_wsum_threads_g1(_ptr(bk), _ptr(out), 1,
                                              8192) == 0
    assert torch.equal(out, want)


# the fp4 weighted sum's and reduction's trial shapes in the threaded
# harness, (G, threads a block, blocks a cluster): a lane a coefficient
# (G = 4), a lane pair (8) and four lanes (16) a coefficient, clusters with
# fewer groups than a step's operations or a chunk's accumulators (16, 256,
# 8: 128 groups), and the shipped shapes (ops/leaf_groups.py sweeps these
# widths)
WSUM_HOST_SHAPES = [(4, 128, 8), (8, 256, 4), (16, 256, 8)]
REDUCE_HOST_SHAPES = [(4, 128, 8), (8, 128, 8), (16, 256, 8)]


def _shape_ids(shapes):
    return [f"G={g},T={t},CL={cl}" for g, t, cl in shapes]


@pytest.mark.parametrize("case", ["nb=32", "nb=2", "nb=4",
                                  "nb=1024, nw=2, identities, P+P, P+(-P)",
                                  "nb=32, windows 0, 2 and 5 identity"])
@pytest.mark.parametrize("shape", WSUM_HOST_SHAPES,
                         ids=_shape_ids(WSUM_HOST_SHAPES))
def test_weighted_sum_sliced_matches_plain_on_host_threads(
        runs, threaded_leaf, shape, case):
    """The fp4 weighted sum (weighted_sum_sliced_kernel: each wavefront
    operation on a group of G lanes, a lane's coefficients of the operands
    from scratch) at the sweep's group widths, blocks and clusters, every
    lane on a host thread, bit for bit against the plain version: the
    run's buckets (its first 8 windows), its first 2 and 4 buckets, two
    windows of 1,024 with identities, P + P and P + (-P) among the
    operands, and windows that are all the identity."""
    run = runs["g2_bls24315"]
    if case.startswith("nb=1024"):
        bk = _wsum_case(run, case)
    else:
        nb = int(re.search(r"nb=(\d+)", case).group(1))
        bk = run.bk[:, :8, :nb].contiguous()
        if "identity" in case:
            ident = torch.cat(run.plan.GC.inf((3, nb), "cpu"))
            bk[:, [0, 2, 5]] = ident
    _, nw, nb = bk.shape
    want = M.weighted_sum_plain(bk, run.plan.GC)
    out = torch.empty_like(want)
    assert threaded_leaf.host_wsum_sliced_threads(
        *shape, _ptr(bk), _ptr(out), nw, nb) == 0   # group masks
    assert torch.equal(out, want)
    ship = _shape(threaded_leaf, "g2_bls24315")
    assert (ship["wsum_group"], ship["wsum_threads"],
            ship["wsum_cluster"]) in WSUM_HOST_SHAPES


def _reduce_case(fp4_ladder, case):
    """[3L, 3, n] points of the fp4 ladder's output (its first 3 chunks;
    the identity where a chunk is zero or the point infinite): its 20
    points, 37 of them (17 repeated), or 600: its first 16 repeated to
    256 (lane t meets P + P in the tree's levels of 16 and up), their
    negatives (lane t meets P + (-P)), then the first 88 again."""
    out = fp4_ladder[1][:, :3].contiguous()
    if case == "n=20":
        return out
    if case == "n=37":
        return torch.cat([out, out[..., :17]], -1).contiguous()
    GC = M.complete_ops(group("g2_bls24315")[0])
    A = out[..., :16].repeat(1, 1, 16)
    negA = torch.cat(GC.neg(M.split_points(A, GC.F.L)))
    return torch.cat([A, negA, A[..., :88]], -1).contiguous()


@pytest.mark.parametrize("case", ["n=20", "n=37", "n=600, P+P, P+(-P)"])
@pytest.mark.parametrize("shape", REDUCE_HOST_SHAPES,
                         ids=_shape_ids(REDUCE_HOST_SHAPES))
def test_reduce_sliced_matches_plain_on_host_threads(threaded_leaf,
                                                     fp4_ladder, shape, case):
    """The fp4 reduction (reduce_sliced_kernel: a chunk's 256
    accumulators on groups of G lanes over a cluster, the halving tree
    through scratch) at the sweep's group widths, blocks and clusters,
    every lane on a host thread, bit for bit against the plain version:
    n below 256 and not a multiple of it, P + P and P + (-P) among the
    additions, identities (zero chunks, infinity points)."""
    pts = _reduce_case(fp4_ladder, case)
    _, K, n = pts.shape
    want = M.reduce_plain(pts, M.complete_ops(group("g2_bls24315")[0]))
    out = torch.empty_like(want)
    assert threaded_leaf.host_reduce_sliced_threads(
        *shape, _ptr(pts), _ptr(out), n, K) == 0   # group masks
    assert torch.equal(out, want)
    ship = _shape(threaded_leaf, "g2_bls24315")
    assert (ship["reduce_group"], ship["reduce_threads"],
            ship["reduce_cluster"]) in REDUCE_HOST_SHAPES


def _lanes_case(run, case):
    """The lane offsets' totals: the run's own (R = 8), its first lane or
    two (R = 1: everything the identity; R = 2), or R = 512 over two
    windows built from the run's totals, a third of them the identity,
    with a P + P (lanes 4, 5) and a P + (-P) (lanes 10, 11) in the first
    step and a P + P of two sums of four lanes (32-35 and 36-39) in the
    third."""
    if case == "run":
        return run.tot
    if case in ("R=1", "R=2"):
        return run.tot[..., :int(case[2:])].contiguous()
    GC, L = run.plan.GC, run.G.F.L
    Q = M.split_points(run.tot[:, :2].contiguous(), L)
    blocks = [Q]
    for m in range(1, 64):
        blocks.append(GC.add(blocks[-1], tuple(a.roll(m, -1) for a in Q)))
    T = [torch.cat([b[i] for b in blocks], -1) for i in range(3)]
    ident = GC.inf((2, 512), "cpu")
    gone = (torch.arange(512) % 3 == 0).expand(2, 512)
    T = [torch.where(gone, i, t) for i, t in zip(ident, T)]
    neg = GC.neg(tuple(t[..., 10:11] for t in T))
    for i in range(3):
        T[i][..., 5] = T[i][..., 4]
        T[i][..., 11] = neg[i][..., 0]
        T[i][..., 36:40] = T[i][..., 32:36]
    return torch.cat(T).contiguous()


LANES_CASES = ["run", "R=1", "R=2",
               "R=512, nw=2, identities, P+P, P+(-P)"]


@pytest.mark.parametrize("case", LANES_CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_lane_offsets_scan_matches_plain_on_host_threads(
        runs, threaded_leaf, kind, case):
    """The lane offsets' source at the card's group width, block size and
    blocks a window, the narrow steps on one block, every lane on a host
    thread, bit for bit against the plain version; R = 1 gives the
    identity."""
    run = runs[kind]
    tot = _lanes_case(run, case)
    _, nw, R = tot.shape
    want = M.lane_offsets_plain(tot, run.plan.GC)
    if R == 1:
        assert torch.equal(want, torch.cat(run.plan.GC.inf((nw, 1), "cpu")))
    out = torch.empty_like(want)
    fn = getattr(threaded_leaf, f"host_lanes_threads_{kind}")
    assert fn(_ptr(tot), _ptr(out), nw, R) == 0   # group masks
    assert torch.equal(out, want)
    lanes = getattr(threaded_leaf, f"host_lanes_shape_{kind}")
    shape = _shape(threaded_leaf, kind)
    assert [lanes(i) for i in range(3)] == [
        shape["lanes_group"], shape["lanes_threads"], shape["lanes_cluster"]]


@pytest.mark.parametrize("case", LANES_CASES[1:])
@pytest.mark.parametrize("kind", KINDS)
def test_lane_offsets_source_matches_plain_on_host(runs, host_kernels, kind,
                                                   case):
    """The lane offsets' source on one thread (a group of one, one block a
    window) at R = 1, 2 and 512, bit for bit against the plain version (the
    run's own R = 8: test_kernel_source_matches_plain_on_host)."""
    run = runs[kind]
    tot = _lanes_case(run, case)
    _, nw, R = tot.shape
    out = torch.empty_like(tot)
    getattr(host_kernels, f"host_lane_offsets_{kind}")(_ptr(tot), _ptr(out),
                                                      nw, R)
    assert torch.equal(out, M.lane_offsets_plain(tot, run.plan.GC))


# the fp4 lane offsets' trial shapes in the threaded harness (G, threads a
# block, blocks a cluster): a lane a coefficient (G = 4), a lane pair (8)
# and four lanes (16) a coefficient; every one has fewer groups than R =
# 512's widest step (256 additions) but (4, 128, 8), which has as many
LANES_HOST_SHAPES = [(4, 128, 8), (8, 128, 8), (8, 256, 4), (16, 256, 8)]


@pytest.mark.parametrize("case", LANES_CASES)
@pytest.mark.parametrize("shape", LANES_HOST_SHAPES,
                         ids=_shape_ids(LANES_HOST_SHAPES))
def test_lane_offsets_sliced_matches_plain_on_host_threads(
        runs, threaded_leaf, shape, case):
    """The fp4 lane offsets (lane_offsets_sliced_kernel: each Brent-Kung
    addition on a group of G lanes, a lane's coefficients of the operands
    from scratch) at the sweep's group widths, blocks and clusters, every
    lane on a host thread, bit for bit against the plain version: the
    run's totals (R = 8), R = 1 (the identity) and 2, each on its first 8
    windows, and two windows of 512 with identities, P + P and P + (-P)
    among the additions."""
    run = runs["g2_bls24315"]
    tot = _lanes_case(run, case)[:, :8].contiguous()
    _, nw, R = tot.shape
    want = M.lane_offsets_plain(tot, run.plan.GC)
    out = torch.empty_like(want)
    assert threaded_leaf.host_lanes_sliced_threads(
        *shape, _ptr(tot), _ptr(out), nw, R) == 0   # group masks
    assert torch.equal(out, want)
    ship = _shape(threaded_leaf, "g2_bls24315")
    assert (ship["lanes_group"], ship["lanes_threads"],
            ship["lanes_cluster"]) in LANES_HOST_SHAPES


def test_lane_offsets_need_a_power_of_two():
    """A lane count that is not a power of two raises, in the plan and in
    the plain version."""
    run_G = group("g1")[0]
    with pytest.raises(ValueError):
        M.MSM(run_G, 48, BN254.fr.L, c=6, lanes=6)
    GC = M.complete_ops(run_G)
    tot = torch.cat(GC.inf((2, 6), "cpu"))
    with pytest.raises(ValueError):
        M.lane_offsets(tot, GC)


@pytest.mark.parametrize("kind", KINDS)
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
@pytest.mark.parametrize("kind", KINDS)
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
@pytest.mark.parametrize("kind", KINDS)
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


# ptxas -v lines of the fp4 leaf and a BN254 leaf, as nvcc prints them
PTXAS_REPORT = """\
ptxas info    : Compiling entry function '_Z18leaf_sliced_kernelI7G2Bls24Li4ELi128ELi3EEvPKlS2_Pliii' for 'sm_90a'
ptxas info    : Function properties for _Z18leaf_sliced_kernelI7G2Bls24Li4ELi128ELi3EEvPKlS2_Pliii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 156 registers, used 0 barriers, 24576 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z18leaf_prefix_kernelI2G1Li4EEvPKlS2_Pliii' for 'sm_90a'
ptxas info    : Function properties for _Z18leaf_prefix_kernelI2G1Li4EEvPKlS2_Pliii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 6912 bytes smem, 400 bytes cmem[0]
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("parser", ["chip_smoke", "leaf_groups"])
def test_ptxas_reports_name_the_fp4_leaf(parser):
    """The [ptxas] lines of chip_smoke.py and ops/leaf_groups.py name the
    fp4 leaf with its shape and give its registers and spill bytes."""
    if parser == "chip_smoke":
        assert _chip_smoke().ptxas_summary(PTXAS_REPORT) == [
            "leaf_sliced_kernel<G2Bls24, 4, 128, 3>: 156 registers; 0 bytes "
            "stack frame, 0 bytes spill stores, 0 bytes spill loads",
            "leaf_prefix_kernel<G1, 4>: 96 registers; 8 bytes stack frame, "
            "4 bytes spill stores, 4 bytes spill loads"]
        return
    from gnark_tpu_torch.ops import leaf_groups
    sliced = leaf_groups.kernel_registers(PTXAS_REPORT, "leaf_sliced")
    assert list(sliced) == ["G2Bls24 G=4 T=128 B=3"]
    assert "0 bytes spill stores" in sliced["G2Bls24 G=4 T=128 B=3"]
    assert "Used 156 registers" in sliced["G2Bls24 G=4 T=128 B=3"]
    assert list(leaf_groups.kernel_registers(PTXAS_REPORT)) == ["G1 G=4"]


# ptxas -v lines of the fp4 ladder and fold (run BB's shipped shapes)
PTXAS_FP4_CHAINS = """\
ptxas info    : Compiling entry function '_Z20ladder_sliced_kernelI7G2Bls24Li4ELi128ELi2EEvPKlS2_PKhS2_Plii' for 'sm_90a'
ptxas info    : Function properties for _Z20ladder_sliced_kernelI7G2Bls24Li4ELi128ELi2EEvPKlS2_PKhS2_Plii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 134 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z25horner_fold_sliced_kernelI7G2Bls24Li16EEvPKlPlii' for 'sm_90a'
ptxas info    : Function properties for _Z25horner_fold_sliced_kernelI7G2Bls24Li16EEvPKlPlii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 130 registers, used 1 barriers, 3072 bytes smem, 400 bytes cmem[0]
"""


@pytest.mark.parametrize("parser", ["chip_smoke", "leaf_groups"])
def test_ptxas_reports_name_the_fp4_ladder_and_fold(parser):
    """The [ptxas] lines of chip_smoke.py and ops/leaf_groups.py name the
    coefficient-sliced ladder and fold with their shapes, and neither is
    taken for the template ladder or fold."""
    if parser == "chip_smoke":
        assert _chip_smoke().ptxas_summary(PTXAS_FP4_CHAINS) == [
            "ladder_sliced_kernel<G2Bls24, 4, 128, 2>: 134 registers; 0 "
            "bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            "horner_fold_sliced_kernel<G2Bls24, 16>: 130 registers; 0 bytes "
            "stack frame, 0 bytes spill stores, 0 bytes spill loads"]
        return
    from gnark_tpu_torch.ops import leaf_groups
    ladder = leaf_groups.kernel_registers(PTXAS_FP4_CHAINS, "ladder_sliced")
    assert list(ladder) == ["G2Bls24 G=4 T=128 B=2"]
    assert "Used 134 registers" in ladder["G2Bls24 G=4 T=128 B=2"]
    fold = leaf_groups.kernel_registers(PTXAS_FP4_CHAINS,
                                        "horner_fold_sliced")
    assert list(fold) == ["G2Bls24 G=16"]
    assert "0 bytes spill stores" in fold["G2Bls24 G=16"]
    assert not leaf_groups.kernel_registers(PTXAS_FP4_CHAINS, "ladder")
    assert not leaf_groups.kernel_registers(PTXAS_FP4_CHAINS, "horner_fold")


# ptxas -v lines of the fp4 weighted sum and reduction (the sweep's
# shipped shapes, launch bounds of one block an SM) and of the template
# reduction they replace for fp4
PTXAS_FP4_SUMS = """\
ptxas info    : Compiling entry function '_Z26weighted_sum_sliced_kernelI7G2Bls24Li8ELi256ELi4EEvPKlPlP5PointI3FpKI10BLS24315FpLi4ELi13EEEii' for 'sm_90a'
ptxas info    : Function properties for _Z26weighted_sum_sliced_kernelI7G2Bls24Li8ELi256ELi4EEvPKlPlP5PointI3FpKI10BLS24315FpLi4ELi13EEEii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 171 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z20reduce_sliced_kernelI7G2Bls24Li8ELi128ELi8EEvPKlPlP5PointI3FpKI10BLS24315FpLi4ELi13EEEii' for 'sm_90a'
ptxas info    : Function properties for _Z20reduce_sliced_kernelI7G2Bls24Li8ELi128ELi8EEvPKlPlP5PointI3FpKI10BLS24315FpLi4ELi13EEEii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 152 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z13reduce_kernelI7G2Bls24EvPKlPlP5PointI3FpKI10BLS24315FpLi4ELi13EEEii' for 'sm_90a'
ptxas info    : Function properties for _Z13reduce_kernelI7G2Bls24EvPKlPlP5PointI3FpKI10BLS24315FpLi4ELi13EEEii
    3352 bytes stack frame, 304 bytes spill stores, 280 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
"""


@pytest.mark.parametrize("parser", ["chip_smoke", "leaf_groups"])
def test_ptxas_reports_name_the_fp4_weighted_sum_and_reduction(parser):
    """The [ptxas] lines of chip_smoke.py and ops/leaf_groups.py name the
    coefficient-sliced weighted sum and reduction with their shapes (G,
    threads, cluster) and spills, apart from the template reduction."""
    if parser == "chip_smoke":
        assert _chip_smoke().ptxas_summary(PTXAS_FP4_SUMS) == [
            "weighted_sum_sliced_kernel<G2Bls24, 8, 256, 4>: 171 registers; "
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            "reduce_sliced_kernel<G2Bls24, 8, 128, 8>: 152 registers; 0 "
            "bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            "reduce_kernel<G2Bls24>: 255 registers; 3352 bytes stack frame, "
            "304 bytes spill stores, 280 bytes spill loads"]
        return
    from gnark_tpu_torch.ops import leaf_groups
    wsum = leaf_groups.kernel_registers(PTXAS_FP4_SUMS, "weighted_sum_sliced")
    assert list(wsum) == ["G2Bls24 G=8 T=256 CL=4"]
    assert "0 bytes spill stores" in wsum["G2Bls24 G=8 T=256 CL=4"]
    red = leaf_groups.kernel_registers(PTXAS_FP4_SUMS, "reduce_sliced")
    assert list(red) == ["G2Bls24 G=8 T=128 CL=8"]
    assert "Used 152 registers" in red["G2Bls24 G=8 T=128 CL=8"]
    assert list(leaf_groups.kernel_registers(PTXAS_FP4_SUMS, "reduce")) == [
        "G2Bls24"]
    assert not leaf_groups.kernel_registers(PTXAS_FP4_SUMS, "weighted_sum")


# ptxas -v lines of the fp4 lane offsets (the sweep's shipped shape,
# launch bounds of one block an SM; run BJ) and of the template they
# replace for fp4 (run BI)
PTXAS_FP4_LANES = """\
ptxas info    : Compiling entry function '_Z26lane_offsets_sliced_kernelI7G2Bls24Li8ELi256ELi4EEvPKlPlP5PointI3FpKI10BLS24315FpLi4ELi13EEEii' for 'sm_90a'
ptxas info    : Function properties for _Z26lane_offsets_sliced_kernelI7G2Bls24Li8ELi256ELi4EEvPKlPlP5PointI3FpKI10BLS24315FpLi4ELi13EEEii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 138 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z19lane_offsets_kernelI7G2Bls24Li8ELi128ELi4EEvPKlPlP5PointI3FpKI10BLS24315FpLi4ELi13EEEii' for 'sm_90a'
ptxas info    : Function properties for _Z19lane_offsets_kernelI7G2Bls24Li8ELi128ELi4EEvPKlPlP5PointI3FpKI10BLS24315FpLi4ELi13EEEii
    1840 bytes stack frame, 68 bytes spill stores, 60 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
"""


@pytest.mark.parametrize("parser", ["chip_smoke", "leaf_groups"])
def test_ptxas_reports_name_the_fp4_lane_offsets(parser):
    """The [ptxas] lines of chip_smoke.py and ops/leaf_groups.py name the
    coefficient-sliced lane offsets with their shape (G, threads,
    cluster) and spills, apart from the template lane offsets."""
    if parser == "chip_smoke":
        assert _chip_smoke().ptxas_summary(PTXAS_FP4_LANES) == [
            "lane_offsets_sliced_kernel<G2Bls24, 8, 256, 4>: 138 registers; "
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            "lane_offsets_kernel<G2Bls24, 8, 128, 4>: 255 registers; 1840 "
            "bytes stack frame, 68 bytes spill stores, 60 bytes spill loads"]
        return
    from gnark_tpu_torch.ops import leaf_groups
    lanes = leaf_groups.kernel_registers(PTXAS_FP4_LANES, "lane_offsets_sliced")
    assert list(lanes) == ["G2Bls24 G=8 T=256 CL=4"]
    assert "0 bytes spill stores" in lanes["G2Bls24 G=8 T=256 CL=4"]
    assert "Used 138 registers" in lanes["G2Bls24 G=8 T=256 CL=4"]
    assert list(leaf_groups.kernel_registers(PTXAS_FP4_LANES,
                                             "lane_offsets")) == [
        "G2Bls24 G=8 T=128 CL=4"]


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


def test_bls24315_kernel_constants_match_field_spec():
    """BLS24-315's constants in the CUDA sources, recomputed from the
    field and the curve: p, R mod p and -p^-1 mod 2^32 (R = 2^320), G1's
    b = 1 (b3 = 3 as 2a + a), and G2's b3 = 3 b2 with b2 = 1/u = (0, 0, 0,
    1/13) in Montgomery form."""
    field = open(os.path.join(CSRC, "field.cuh")).read()
    kern = open(os.path.join(CSRC, "msm_kernels.cu")).read()
    p = BLS24_315.fp.modulus
    R = 1 << 320
    body = field[field.index("struct BLS24315Fp"):]

    def val(name, text):
        m = re.search(name + r"\[10\] = \{([^}]*)\}", text)
        return sum(int(v.strip().rstrip("u"), 16) << (32 * i)
                   for i, v in enumerate(m.group(1).split(",")))

    assert val("v", body[body.index("p(int i)"):]) == p
    assert val("v", body[body.index("one(int i)"):]) == R % p
    inv = int(re.search(r"INV = (0x[0-9a-f]+)u", body).group(1), 16)
    assert (inv * p) % (1 << 32) == (1 << 32) - 1
    assert BLS24_315.b == 1
    b3 = [3 * c % p for c in BLS24_315.b2]
    assert b3[:3] == [0, 0, 0] and b3[3] == 3 * pow(13, -1, p) % p
    assert val("c3", kern) == b3[3] * R % p
    # G2's sliced ladder and fold shapes: a group inside a warp, whole
    # warps a block, among the sweep's shapes, and the block's shared
    # memory (b3's 4 columns, the table of 16 entries of 3 x 4 slots of
    # each of its points, a group's 9 + 6 value and product slots of 4,
    # 48 bytes a slot) for its resident blocks in an SM's 227 KB
    from gnark_tpu_torch.ops import leaf_groups
    g2 = kern[kern.index("struct G2Bls24"):]
    g2 = g2[:g2.index("};")]
    shape = {k: int(re.search(k + r" = (\d+)", g2).group(1)) for k in (
        "LADDER_GROUP", "LADDER_THREADS", "LADDER_BLOCKS", "FOLD_GROUP")}
    G, T, blocks = (shape[k] for k in ("LADDER_GROUP", "LADDER_THREADS",
                                       "LADDER_BLOCKS"))
    assert 32 % G == 0 and T % 32 == 0 and 32 % shape["FOLD_GROUP"] == 0
    assert (G, T, blocks) in leaf_groups.LADDER_SHAPES
    assert shape["FOLD_GROUP"] in leaf_groups.FOLD_GROUPS
    pts = max(1, T // G // 16)
    slot = 48
    block = 4 * slot + pts * 16 * 3 * 4 * slot + T // G * 15 * 4 * slot
    assert block * blocks <= 227 * 1024


def test_bls24315_fp4_sum_shapes_are_swept_and_fit():
    """G2's weighted sum, reduction and lane offsets shapes (WSUM_*,
    REDUCE_*, LANES_*) in the source: groups inside a warp, among
    ops/leaf_groups.py's trial shapes, a block's GroupsShared (b3's 4
    columns and a group's 9 + 6 value and product slots of 4, 48 bytes a
    slot) inside 227 KB, and a portable cluster."""
    from gnark_tpu_torch.ops import leaf_groups
    kern = open(os.path.join(CSRC, "msm_kernels.cu")).read()
    g2 = kern[kern.index("struct G2Bls24"):]
    g2 = g2[:g2.index("};")]
    val = {f"{p}_{k}": int(re.search(f"{p}_{k}" + r" = (\d+)", g2).group(1))
           for p in ("WSUM", "REDUCE", "LANES")
           for k in ("GROUP", "THREADS", "CLUSTER")}
    wsum, red, lanes = (tuple(val[f"{p}_{k}"] for k in (
        "GROUP", "THREADS", "CLUSTER")) for p in ("WSUM", "REDUCE", "LANES"))
    assert wsum in leaf_groups.WSUM_FP4_SHAPES
    assert red in leaf_groups.REDUCE_SHAPES
    assert lanes in leaf_groups.LANES_FP4_SHAPES
    for g, t, cl in (wsum, red, lanes):
        assert 32 % g == 0 and t % 32 == 0 and 1 <= cl <= 8
        assert 4 * 48 + t // g * 15 * 4 * 48 <= 227 * 1024


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

