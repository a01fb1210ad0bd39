"""gnark_tpu_torch.ops.msm: the chunked, windowed ladder, the per-chunk
reduction of its output and the fold of the chunk sums, and their kernels.

  * the plain ladder, column by column (point i, chunk j: d_ij P_i),
    against the host curves for G1 and G2, at its one schedule (16
    chunks, 4-bit windows) with zero scalars, an unreduced scalar, chunks
    whose digits are all zero (the identity (0 : 1 : 0) exactly), a
    repeated point and an infinity point; and with 64-bit scalars (chunks
    of 4 bits, one window each);
  * a table addition acc + T[d] has acc = 16 a P (a < 2^12) and d < 16,
    so it meets P + P or P + (-P) only as the identity plus itself (zero
    digits, an infinity point), both above; the reduction meets both:
    see the 600 points below;
  * the reduction to one point per chunk, and the ladder MSM through the
    fold of the chunk sums, against the host sums, also over 600 points
    where each of the 256 lanes meets P + P or P + (-P);
  * the kernels' sources, compiled for the host with g++ and run one block
    at a time with blockDim.x = 1, against the plain versions, bit for bit
    (tests/test_torch_cuda.py runs the kernels themselves on a card);
  * field.cuh's portable Montgomery product (the host form of the device's
    carry-chain product) against Python-int Montgomery products;
  * ``msm`` routes fewer than LADDER_MAX points to the ladder and the
    rest to the windowed plan, and the wrapper raises on a device that
    has no kernel and no plain version.

The kinds: BN254's G1 (``g1``) and G2 over fp2 (``g2``), BLS24-315's G1
(``g1_bls24315``) and G2 over fp4 (``g2_bls24315``).

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
from gnark_tpu_torch.curves import BLS24_315
from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops import msm as M
from gnark_tpu_torch.ops.ec import points_to_host
from gnark_tpu_torch.ops.limbs import ints_to_limbs
from torch_kinds import KINDS, group, r_mod

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "gnark_tpu_torch", "csrc")


def _group(kind):
    return group(kind)[:3]


def _inputs(G, H, gen, scalars, inf_at=(), limbs=None):
    """Points k * gen (k = 1..n, the 4th repeating the 3rd), the given
    scalars as ``limbs`` 16-bit limbs (default: the scalar field's), and
    infinity flags at ``inf_at``."""
    n = len(scalars)
    pts = [gen]
    for _ in range(n - 1):
        pts.append(H.add(pts[-1], gen))
    pts[3] = pts[2]
    inf = np.zeros(n, bool)
    inf[list(inf_at)] = True
    xs = G.F.pack([p[0] for p in pts], "cpu")
    ys = G.F.pack([p[1] for p in pts], "cpu")
    sc = torch.from_numpy(
        ints_to_limbs(scalars, limbs or BN254.fr.L).astype(np.int64))
    return pts, inf, (xs, ys, torch.from_numpy(inf), sc)


def _columns_to_host(G, out):
    """[3L, K, n] projective -> host points, chunk-major (None = inf)."""
    L = G.F.L
    flat = out.reshape(3 * L, -1)
    return points_to_host(G, M.complete_ops(G).to_jacobian(
        M.split_points(flat, L)))


def _want_columns(H, pts, scalars, inf, bits):
    """d_ij P_i, chunk-major: d_ij = bits [jB, (j+1)B) of the raw scalar."""
    B = bits // M.LADDER_CHUNKS
    return [None if i else H.scalar_mul(p, (s >> (j * B)) % (1 << B))
            for j in range(M.LADDER_CHUNKS)
            for p, s, i in zip(pts, scalars, inf)]


class _Ladder:
    """One plain ladder at the default schedule over edge-case scalars,
    with its inputs: 5 and 1 leave 15 chunks all zero."""

    def __init__(self, kind):
        self.G, self.H, gen = _group(kind)
        self.GC = M.complete_ops(self.G)
        self.r = r = r_mod(kind)
        rng = np.random.default_rng(53 + 6 * KINDS.index(kind))
        self.scalars = [r + 2, r, 0, 5, (1 << 256) - 1, 0,
                        int.from_bytes(rng.bytes(32), "little") % r, 1]
        self.pts, self.inf, self.args = _inputs(
            self.G, self.H, gen, self.scalars, inf_at=(6,))
        self.out = M.ladder_plain(*self.args, self.GC)

    def want(self):
        return [None if i else self.H.scalar_mul(p, s % self.r)
                for p, s, i in zip(self.pts, self.scalars, self.inf)]

    def want_columns(self):
        return _want_columns(self.H, self.pts, self.scalars, self.inf, 256)


@pytest.fixture(scope="module")
def ladders():
    return {kind: _Ladder(kind) for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_ladder_plain_matches_host_curve(ladders, kind):
    lad = ladders[kind]
    assert lad.out.shape == (3 * lad.G.F.L, M.LADDER_CHUNKS, 8)
    assert _columns_to_host(lad.G, lad.out) == lad.want_columns()
    # a chunk whose digits are all zero is the identity (0 : 1 : 0) itself
    L = lad.G.F.L
    ident = torch.cat(lad.GC.inf(1, "cpu"))[:, 0]
    for j in range(1, M.LADDER_CHUNKS):
        for i in (2, 3, 5, 7):                   # scalars 0, 5, 0, 1
            assert torch.equal(lad.out[:, j, i], ident), (j, i)
    assert torch.equal(lad.out[:, 0, 6], ident)   # the infinity point


@pytest.mark.parametrize("kind", KINDS)
def test_ladder_reduce_matches_host_sum(ladders, kind):
    lad = ladders[kind]
    cols = lad.want_columns()
    n = len(lad.scalars)
    sums = []
    for j in range(M.LADDER_CHUNKS):
        acc = None
        for p in cols[j * n:(j + 1) * n]:
            acc = lad.H.add(acc, p)
        sums.append(acc)
    T = M.reduce(lad.out, lad.GC)
    assert T.shape == (3 * lad.G.F.L, M.LADDER_CHUNKS)
    assert _columns_to_host(lad.G, T.unsqueeze(-1)) == sums
    acc = None
    for p in lad.want():
        acc = lad.H.add(acc, p)
    assert points_to_host(lad.G, M.ladder_msm(lad.G, *lad.args)) == [acc]


def _wide(lad, kind):
    """600 points a chunk: A (256, the ladder's 8 outputs repeated, so
    lane t meets P + P in the tree), -A (so lane t meets P + (-P)), then
    A's first 88.  Each chunk's sum is 11 times its sum over the 8."""
    L = lad.G.F.L
    A = lad.out.repeat(1, 1, 32)
    negA = torch.cat(lad.GC.neg(M.split_points(A, L)))
    return torch.cat([A, negA, A[..., :88]], -1)


@pytest.fixture(scope="module")
def wide(ladders):
    return {k: (_wide(lad, k), M.reduce_plain(_wide(lad, k), lad.GC))
            for k, lad in ladders.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_reduce_over_lanes_matches_host_sum(ladders, wide, kind):
    lad = ladders[kind]
    cols = lad.want_columns()
    n = len(lad.scalars)
    want = []
    for j in range(M.LADDER_CHUNKS):
        acc = None
        for p in cols[j * n:(j + 1) * n]:
            acc = lad.H.add(acc, p)
        want.append(lad.H.scalar_mul(acc, 11) if acc else None)
    got = _columns_to_host(lad.G, wide[kind][1].unsqueeze(-1))
    assert got == want


@pytest.mark.parametrize("kind", KINDS)
def test_ladder_short_scalars_match_host_curve_and_kernel_source(
        host_ladder, kind):
    """64-bit scalars (4 limbs: 16 chunks of 4 bits, one window each):
    zero, one, all ones, one with its low chunks all zero, and random;
    the plain ladder's columns against the host curve, the kernel source
    against the plain ladder, and the ladder MSM against the host sum."""
    G, H, gen = _group(kind)
    GC = M.complete_ops(G)
    rng = np.random.default_rng(61 + 10 * KINDS.index(kind))
    scalars = [0, 1, (1 << 64) - 1, 3 << 60] + [
        int(v) for v in rng.integers(0, 1 << 63, 3)] + [0]
    pts, inf, args = _inputs(G, H, gen, scalars, inf_at=(5,), limbs=4)
    out = M.ladder_plain(*args, GC)
    assert _columns_to_host(G, out) == _want_columns(H, pts, scalars, inf,
                                                     64)
    assert torch.equal(_host_ladder(host_ladder, kind, args), out)
    want = None
    for p, s, i in zip(pts, scalars, inf):
        if not i:
            want = H.add(want, H.scalar_mul(p, s))
    assert points_to_host(G, M.ladder_msm(G, *args)) == [want]


# ---- the kernel source on the host ---------------------------------------------

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

// one block at a time, blockDim.x = 1: every loop over a block's work
// steps by blockDim.x, so the one thread does it all in order; over fp4
// the shipped ladder_sliced_kernel, a group of one thread a chain, a block
// a chain
template <class Cv> static void grid_ladder(const int64_t* xs, const int64_t* ys,
    const uint8_t* inf, const int64_t* sc, int64_t* out, int n, int Ls) {
  blockDim.x = 1; threadIdx.x = 0;
  if constexpr (FpKTraits<typename Cv::F>::SLICED) {
    for (long b = 0; b < (long)n * LADDER_CHUNKS; ++b) {
      blockIdx.x = (unsigned)b;
      ladder_sliced_kernel<Cv, 1, 1, 1>(xs, ys, inf, sc, out, n, Ls);
    }
    return;
  }
  for (int b = 0; b < (n + Cv::LADDER_POINTS - 1) / Cv::LADDER_POINTS; ++b) {
    blockIdx.x = (unsigned)b;
    ladder_kernel<Cv>(xs, ys, inf, sc, out, n, Ls);
  }
}
template <class Cv> static void grid_reduce(const int64_t* p, int64_t* o, int n,
                                            int K) {
  std::vector<Point<typename Cv::F>> s((long)K * REDUCE_LANES);
  blockDim.x = 1; threadIdx.x = 0;
  for (int j = 0; j < K; ++j) {
    blockIdx.x = (unsigned)j;
    reduce_kernel<Cv>(p, o, s.data(), n, K);
  }
}
#define HOST_GRIDS(NAME, CV)                                                  \
  extern "C" void host_ladder_##NAME(const int64_t* xs, const int64_t* ys,    \
      const uint8_t* inf, const int64_t* sc, int64_t* out, int n, int Ls) {   \
    grid_ladder<CV>(xs, ys, inf, sc, out, n, Ls); }                           \
  extern "C" void host_reduce_##NAME(const int64_t* p, int64_t* o, int n,     \
      int K) { grid_reduce<CV>(p, o, n, K); }
HOST_GRIDS(g1, G1)
HOST_GRIDS(g2, G2)
HOST_GRIDS(g1_bls24315, G1Bls24)
HOST_GRIDS(g2_bls24315, G2Bls24)

// field.cuh's portable Montgomery product, limbs as 8 x 32 bits
extern "C" void host_montmul(const uint32_t* a, const uint32_t* b,
                             uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    Fp<BN254Fp> x, y;
    for (int k = 0; k < 8; ++k) {
      x.v[k] = a[8 * i + k];
      y.v[k] = b[8 * i + k];
    }
    const Fp<BN254Fp> r = mul(x, y);
    for (int k = 0; k < 8; ++k) out[8 * i + k] = r.v[k];
  }
}

// the same over BLS24-315's fp (10 x 32 bits) and its fp4 product (an
// element is 4 x 10 words, coefficient 0 first)
extern "C" void host_montmul_bls24315(const uint32_t* a, const uint32_t* b,
                                      uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    Fp<BLS24315Fp> x, y;
    for (int k = 0; k < 10; ++k) {
      x.v[k] = a[10 * i + k];
      y.v[k] = b[10 * i + k];
    }
    const Fp<BLS24315Fp> r = mul(x, y);
    for (int k = 0; k < 10; ++k) out[10 * i + k] = r.v[k];
  }
}
extern "C" void host_fp4mul_bls24315(const uint32_t* a, const uint32_t* b,
                                     uint32_t* out, int n) {
  using F4 = G2Bls24::F;
  for (int i = 0; i < n; ++i) {
    F4 x, y;
    words_to(x, a + 40 * i);
    words_to(y, b + 40 * i);
    words_from(out + 40 * i, mul(x, y));
  }
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


def _host_ladder(lib, kind, args):
    xs, ys, inf, sc = args
    n = xs.shape[1]
    out = torch.empty((3 * xs.shape[0], M.LADDER_CHUNKS, n),
                      dtype=torch.int64)
    getattr(lib, f"host_ladder_{kind}")(
        _ptr(xs), _ptr(ys), _ptr(inf), _ptr(sc), _ptr(out), n, sc.shape[0])
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_ladder_kernel_source_matches_plain_on_host(ladders, host_ladder,
                                                     kind):
    lad = ladders[kind]
    out = _host_ladder(host_ladder, kind, lad.args)
    assert torch.equal(out, lad.out)


@pytest.mark.parametrize("case", ["8", "600"])
@pytest.mark.parametrize("kind", KINDS)
def test_reduce_kernel_source_matches_plain_on_host(ladders, wide,
                                                     host_ladder, kind, case):
    lad = ladders[kind]
    if case == "8":
        pts, want = lad.out, M.reduce_plain(lad.out, lad.GC)
    else:
        pts, want = wide[kind]
    out = torch.empty_like(want)
    getattr(host_ladder, f"host_reduce_{kind}")(_ptr(pts), _ptr(out),
                                                pts.shape[2], pts.shape[1])
    assert torch.equal(out, want)


# BLS24-315 G2's ladder and reduction as one program, for the sanitizers:
# argv = a directory holding xs, ys, inf, sc (raw arrays), n, Ls; writes
# out (the ladder) and red (its reduction) there
SANITIZED_MAIN = r"""
#include <cstdio>
#include <cstdlib>
template <class T> static std::vector<T> load_file(const char* dir,
                                                   const char* name, long n) {
  char path[4096];
  std::snprintf(path, sizeof path, "%s/%s", dir, name);
  std::vector<T> v(n);
  FILE* f = std::fopen(path, "rb");
  if (!f || std::fread(v.data(), sizeof(T), n, f) != (size_t)n) std::abort();
  std::fclose(f);
  return v;
}
template <class T> static void save_file(const char* dir, const char* name,
                                         const std::vector<T>& v) {
  char path[4096];
  std::snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = std::fopen(path, "wb");
  if (!f || std::fwrite(v.data(), sizeof(T), v.size(), f) != v.size())
    std::abort();
  std::fclose(f);
}
int main(int argc, char** argv) {
  if (argc != 4) return 2;
  const int n = std::atoi(argv[2]), Ls = std::atoi(argv[3]);
  const long L16 = G2Bls24::F::L16, K = LADDER_CHUNKS;
  auto xs = load_file<int64_t>(argv[1], "xs", L16 * n);
  auto ys = load_file<int64_t>(argv[1], "ys", L16 * n);
  auto inf = load_file<uint8_t>(argv[1], "inf", n);
  auto sc = load_file<int64_t>(argv[1], "sc", (long)Ls * n);
  std::vector<int64_t> out(3 * L16 * K * n), red(3 * L16 * K);
  host_ladder_g2_bls24315(xs.data(), ys.data(), inf.data(), sc.data(),
                          out.data(), n, Ls);
  host_reduce_g2_bls24315(out.data(), red.data(), n, (int)K);
  save_file(argv[1], "out", out);
  save_file(argv[1], "red", red);
  return 0;
}
"""


@pytest.mark.parametrize("build", ["inlined", "called"])
def test_fp4_ladder_source_clean_under_sanitizers(ladders, tmp_path, build):
    """BLS24-315 G2's ladder (the shipped ladder_sliced_kernel, its base
    products inlined) and reduction sources, with the fp4 product of the
    reduction inlined (as shipped) or a called function (GT_FPK_MUL, the
    build whose card ladder disagreed: PERF.md, ops/inline_check.py), as one g++
    program under AddressSanitizer and UndefinedBehaviorSanitizer, every
    automatic variable filled with a pattern before its first store:
    no report, and the limbs of the plain versions.  An out-of-bounds
    access or undefined behaviour stops the program; a read of an
    uninitialised variable would change the limbs."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lad = ladders["g2_bls24315"]
    src = tmp_path / "ladder.cpp"
    head = HARNESS[:HARNESS.index("HOST_GRIDS(g1, G1)")]
    src.write_text(head + "HOST_GRIDS(g2_bls24315, G2Bls24)\n"
                   + SANITIZED_MAIN)
    prog = tmp_path / "ladder"
    flags = ["-DGT_FPK_MUL=__attribute__((noinline))"] \
        if build == "called" else []
    subprocess.run(["g++", "-std=c++17", "-O1", "-g", "-fsanitize=address",
                    "-fsanitize=undefined", "-fno-sanitize-recover=all",
                    "-ftrivial-auto-var-init=pattern", *flags,
                    f"-I{CSRC}", "-o", str(prog), str(src)], check=True)
    xs, ys, inf, sc = lad.args
    for name, t in (("xs", xs), ("ys", ys), ("inf", inf), ("sc", sc)):
        t.numpy().tofile(tmp_path / name)
    n = xs.shape[1]
    res = subprocess.run(
        [str(prog), str(tmp_path), str(n), str(sc.shape[0])],
        capture_output=True, text=True,
        env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert "runtime error" not in res.stderr, res.stderr[-3000:]
    out = torch.from_numpy(np.fromfile(tmp_path / "out", np.int64))
    assert torch.equal(out.reshape(lad.out.shape), lad.out)
    red = torch.from_numpy(np.fromfile(tmp_path / "red", np.int64))
    want = M.reduce_plain(lad.out, lad.GC)
    assert torch.equal(red.reshape(want.shape), want)


def test_field_product_matches_python_ints(host_ladder):
    """field.cuh's portable product (the form the device's carry chains
    must agree with) against a * b * R^-1 mod p in Python ints, at
    p - 1, 0, 1 and random values below p."""
    p = BN254.fp.modulus
    rinv = pow(1 << 256, -1, p)
    rng = np.random.default_rng(67)
    edge = [p - 1, 0, 1, p - 2, (1 << 255) % p]
    rand = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(64)]
    pairs = [(a, b) for a in edge for b in edge] + list(zip(rand, rand[::-1]))
    n = len(pairs)

    def words(vals):
        return np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
                         for v in vals], dtype=np.uint32)

    a, b = words([x for x, _ in pairs]), words([y for _, y in pairs])
    out = np.zeros_like(a)
    host_ladder.host_montmul(a.ctypes.data_as(ctypes.c_void_p),
                             b.ctypes.data_as(ctypes.c_void_p),
                             out.ctypes.data_as(ctypes.c_void_p), n)
    got = [sum(int(w) << (32 * k) for k, w in enumerate(row)) for row in out]
    assert got == [x * y * rinv % p for x, y in pairs]


def _words(vals, n):
    return np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(n)]
                     for v in vals], dtype=np.uint32)


def _from_words(row):
    return sum(int(w) << (32 * k) for k, w in enumerate(row))


def test_bls24315_field_products_match_python_ints(host_ladder):
    """field.cuh's portable product over BLS24-315's fp (N = 10, no carry
    chain on the card either) and its fp4 product (FpK<.., 4, 13>), in
    Montgomery form (R = 2^320), against Python ints and the host fp4, at
    p - 1, 0, 1 and random values below p."""
    from gnark_tpu_torch.curves.host import HostFpK
    p = BLS24_315.fp.modulus
    R = 1 << 320
    rinv = pow(R, -1, p)
    rng = np.random.default_rng(73)
    edge = [p - 1, 0, 1, p - 2, (1 << 314) % p]
    rand = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(64)]
    pairs = [(a, b) for a in edge for b in edge] + list(zip(rand, rand[::-1]))
    a, b = _words([x for x, _ in pairs], 10), _words([y for _, y in pairs], 10)
    out = np.zeros_like(a)
    host_ladder.host_montmul_bls24315(
        a.ctypes.data_as(ctypes.c_void_p), b.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), len(pairs))
    assert [_from_words(r) for r in out] == [x * y * rinv % p
                                             for x, y in pairs]
    H = HostFpK(p, 4, 13)
    xs = [tuple(rand[4 * i:4 * i + 4]) for i in range(16)] + [
        (p - 1, 0, 0, p - 1), (0, 0, 0, 0), (1, 0, 0, 0)]
    ys = [tuple(rand[60 - 4 * i:64 - 4 * i]) for i in range(16)] + [
        (p - 1, p - 1, p - 1, p - 1), (5, 6, 7, 8), (0, 1, 0, 0)]

    def mont(v):
        return _words([c * R % p for t in v for c in t], 10).reshape(-1, 40)

    a, b = mont(xs), mont(ys)
    out = np.zeros_like(a)
    host_ladder.host_fp4mul_bls24315(
        a.ctypes.data_as(ctypes.c_void_p), b.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), len(xs))
    got = [tuple(_from_words(r[10 * k:10 * k + 10]) * rinv % p
                 for k in range(4)) for r in out]
    assert got == [H.mul(x, y) for x, y in zip(xs, ys)]


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
    GC = M.complete_ops(G)
    _, _, args = _inputs(G, H, gen, [6, 1, 0, 9])
    before = dict(_cuda.launches)
    assert torch.equal(M.ladder(*args, GC), M.ladder_plain(*args, GC))
    with pytest.raises(ValueError):
        M.ladder(*(a.to("meta") for a in args), GC)
    assert _cuda.launches == before
    assert not any(M.plain_on_cuda.values())
