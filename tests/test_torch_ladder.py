"""gnark_tpu_torch.ops.msm: the double-and-add ladder and the reduction of
its output, and their kernels.

  * the plain ladder, point by point, against the host curves for G1 and
    G2, with the degenerate steps forced: scalar r + 2 makes the
    accumulator equal the point before an add (P + P), and scalar r makes
    it equal the point's negative (P + (-P)); also zero scalars, an
    unreduced scalar, a repeated point and an infinity point;
  * the reduction to one point against the host sum, also over 600
    points where each of the 256 lanes meets P + P or P + (-P);
  * the kernels' sources, compiled for the host with g++ and run one
    thread at a time, against the plain versions, bit for bit
    (tests/test_torch_cuda.py runs the kernels themselves on a card);
  * ``msm`` routes fewer than LADDER_MAX points to the ladder and the
    rest to the windowed plan, and the wrapper raises on a device that
    has no kernel and no plain version.

Tolerance: none.  Limbs compare exactly; points compare as Python ints.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gnark_tpu.curves import BN254
from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops import msm as M
from gnark_tpu_torch.ops.ec import CurveOps, points_to_host
from gnark_tpu_torch.ops.limbs import field_ops, ints_to_limbs
from gnark_tpu_torch.ops.towers import fp2_ops

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "gnark_tpu_torch", "csrc")
R_MOD = BN254.fr.modulus


def _group(kind):
    if kind == "g1":
        return (CurveOps(field_ops(BN254.fp), b=BN254.b), BN254.host_g1,
                BN254.g1_gen)
    return (CurveOps(fp2_ops(BN254.fp, BN254.fp2_beta), b=BN254.b2),
            BN254.host_g2, BN254.g2_gen)


def _inputs(G, H, gen, scalars, inf_at=()):
    """Points k * gen (k = 1..n, the 4th repeating the 3rd), the given
    scalars, and infinity flags at ``inf_at``."""
    n = len(scalars)
    pts = [gen]
    for _ in range(n - 1):
        pts.append(H.add(pts[-1], gen))
    pts[3] = pts[2]
    inf = np.zeros(n, bool)
    inf[list(inf_at)] = True
    xs = G.F.pack([p[0] for p in pts], "cpu")
    ys = G.F.pack([p[1] for p in pts], "cpu")
    sc = torch.from_numpy(ints_to_limbs(scalars, BN254.fr.L).astype(np.int64))
    return pts, inf, (xs, ys, torch.from_numpy(inf), sc)


class _Ladder:
    """One plain ladder over edge-case scalars, with its inputs."""

    def __init__(self, kind):
        self.G, self.H, gen = _group(kind)
        rng = np.random.default_rng(53 if kind == "g1" else 59)
        self.scalars = [R_MOD + 2, R_MOD, 0, 5, (1 << 256) - 1, 0,
                        int.from_bytes(rng.bytes(32), "little") % R_MOD, 1]
        self.pts, self.inf, self.args = _inputs(
            self.G, self.H, gen, self.scalars, inf_at=(6,))
        self.out = M.ladder_plain(*self.args, self.G)

    def want(self):
        return [None if i else self.H.scalar_mul(p, s % R_MOD)
                for p, s, i in zip(self.pts, self.scalars, self.inf)]


@pytest.fixture(scope="module")
def ladders():
    return {kind: _Ladder(kind) for kind in ("g1", "g2")}


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_ladder_plain_matches_host_curve(ladders, kind):
    lad = ladders[kind]
    got = points_to_host(lad.G, M.split_points(lad.out, lad.G.F.L))
    assert got == lad.want()


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_ladder_reduce_matches_host_sum(ladders, kind):
    lad = ladders[kind]
    acc = None
    for p in lad.want():
        acc = lad.H.add(acc, p)
    P = M.reduce(lad.out, lad.G)
    assert points_to_host(lad.G, M.split_points(P, lad.G.F.L)) == [acc]


def _wide(lad, kind):
    """600 points: A (256, the ladder's 8 outputs repeated, so lane t
    meets P + P in the tree), -A (so lane t meets P + (-P)), then A's
    first 88.  Their sum is 11 times the sum of the 8 outputs."""
    L = lad.G.F.L
    A = lad.out.repeat(1, 32)
    negA = torch.cat(lad.G.neg(M.split_points(A, L)))
    return torch.cat([A, negA, A[:, :88]], 1)


@pytest.fixture(scope="module")
def wide(ladders):
    return {k: (_wide(lad, k), M.reduce_plain(_wide(lad, k), lad.G))
            for k, lad in ladders.items()}


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_reduce_over_lanes_matches_host_sum(ladders, wide, kind):
    lad = ladders[kind]
    acc = None
    for p in lad.want():
        acc = lad.H.add(acc, p)
    got = points_to_host(lad.G, M.split_points(wide[kind][1], lad.G.F.L))
    assert got == [lad.H.scalar_mul(acc, 11)]


# ---- the kernel source on the host ---------------------------------------------

HARNESS = r"""
#include <cstdint>
#include <vector>
struct Dim { unsigned x; };
static Dim blockIdx, threadIdx, blockDim;
#define __global__
#define __launch_bounds__(x)
#define __syncthreads()
#include "msm_kernels.cu"

template <class Cv> static void grid_ladder(const int64_t* xs, const int64_t* ys,
    const uint8_t* inf, const int64_t* sc, int64_t* out, int n, int Ls) {
  blockDim.x = 1; threadIdx.x = 0;
  for (int b = 0; b < n; ++b) {
    blockIdx.x = (unsigned)b;
    ladder_kernel<Cv>(xs, ys, inf, sc, out, n, Ls);
  }
}
extern "C" void host_ladder_g1(const int64_t* xs, const int64_t* ys,
    const uint8_t* inf, const int64_t* sc, int64_t* out, int n, int Ls) {
  grid_ladder<G1>(xs, ys, inf, sc, out, n, Ls);
}
extern "C" void host_ladder_g2(const int64_t* xs, const int64_t* ys,
    const uint8_t* inf, const int64_t* sc, int64_t* out, int n, int Ls) {
  grid_ladder<G2>(xs, ys, inf, sc, out, n, Ls);
}
template <class Cv> static void grid_reduce(const int64_t* p, int64_t* o, int n) {
  std::vector<Point<typename Cv::F>> s(REDUCE_LANES);
  blockDim.x = 1; threadIdx.x = 0; blockIdx.x = 0;
  reduce_kernel<Cv>(p, o, s.data(), n);
}
extern "C" void host_reduce_g1(const int64_t* p, int64_t* o, int n) {
  grid_reduce<G1>(p, o, n);
}
extern "C" void host_reduce_g2(const int64_t* p, int64_t* o, int n) {
  grid_reduce<G2>(p, o, n);
}
"""


@pytest.fixture(scope="module")
def host_ladder(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("ladder_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    lib = d / "libladder_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_ladder_kernel_source_matches_plain_on_host(ladders, host_ladder,
                                                     kind):
    lad = ladders[kind]
    xs, ys, inf, sc = lad.args
    out = torch.empty_like(lad.out)
    getattr(host_ladder, f"host_ladder_{kind}")(
        _ptr(xs), _ptr(ys), _ptr(inf), _ptr(sc), _ptr(out), xs.shape[1],
        sc.shape[0])
    assert torch.equal(out, lad.out)


@pytest.mark.parametrize("case", ["8", "600"])
@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_reduce_kernel_source_matches_plain_on_host(ladders, wide,
                                                     host_ladder, kind, case):
    lad = ladders[kind]
    if case == "8":
        pts, want = lad.out, M.reduce_plain(lad.out, lad.G)
    else:
        pts, want = wide[kind]
    out = torch.empty_like(want)
    getattr(host_ladder, f"host_reduce_{kind}")(_ptr(pts), _ptr(out),
                                                pts.shape[1])
    assert torch.equal(out, want)


# ---- routing ---------------------------------------------------------------------

def test_msm_routes_by_size(monkeypatch):
    """Fewer than LADDER_MAX points go through the ladder (small scalars
    keep it short here); LADDER_MAX points go to the windowed plan."""
    G, H, gen = _group("g1")
    scalars = [3, 0, 7, 1, 2, 0]
    pts, inf, args = _inputs(G, H, gen, scalars, inf_at=(5,))
    calls = []
    plain = M.ladder_plain
    monkeypatch.setattr(M, "ladder_plain",
                        lambda *a: calls.append(1) or plain(*a))
    want = None
    for p, s, i in zip(pts, scalars, inf):
        if not i:
            want = H.add(want, H.scalar_mul(p, s))
    assert points_to_host(G, M.msm(G, *args)) == [want]
    assert calls == [1]

    sizes = []
    monkeypatch.setattr(M, "_plan", lambda G, n, Ls: sizes.append(n) or (
        lambda *a: "windowed"))
    n = M.LADDER_MAX
    big = (torch.zeros(G.F.L, n, dtype=torch.int64),) * 2 + (
        torch.zeros(n, dtype=torch.bool),
        torch.zeros(BN254.fr.L, n, dtype=torch.int64))
    assert M.msm(G, *big) == "windowed" and sizes == [n]
    assert calls == [1]


def test_ladder_wrapper_routes_by_device():
    G, H, gen = _group("g1")
    _, _, args = _inputs(G, H, gen, [6, 1, 0, 9])
    before = dict(_cuda.launches)
    assert torch.equal(M.ladder(*args, G), M.ladder_plain(*args, G))
    with pytest.raises(ValueError):
        M.ladder(*(a.to("meta") for a in args), G)
    assert _cuda.launches == before
    assert not any(M.plain_on_cuda.values())
