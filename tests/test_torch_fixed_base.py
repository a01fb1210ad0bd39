"""gnark_tpu_torch.ops.fixed_base: the fixed-base scan of setup's key
batches and the KZG SRS, and its kernel.

  * csrc/msm_kernels.cu's fixed_base_kernel (BN254 G1, G2, BLS24-315 G1)
    and fixed_base_sliced_kernel (BLS24-315 G2 over fp4), compiled for
    the host with g++ and run at the card's group widths, a block's lanes
    on host threads (``__syncwarp`` a barrier of the calling group),
    against ``fixed_base_plain`` bit for bit: 64-bit scalars (four limb
    planes) at c = 3 and 8, and c = 12 for G1, so the top windows reach
    past the top limb; a table entry flagged infinite;
  * every sum in tier 1 also against gnark_tpu's host curves
    (``gnark_tpu.curves``' ``host_g1`` / ``host_g2`` scalar
    multiplication, plain Python, no compile): all four kinds at 64
    bits, BLS24-315's two kinds at full width (gnark_tpu's jitted scan
    over fp4 would compile for many minutes on the CPU); BN254's against
    gnark_tpu's jitted scan at c = 8 and 12 under ``-m slow`` (each
    compile takes 1-3 minutes here);
  * the wrapper's routes: the plain version on CPU tensors, a raise on
    any other device, ``_cuda.fixed_base``'s checks of shape, dtype and
    window width;
  * ``kzg.new_srs`` over BLS12-381 on its native route (no kernel kind
    for fp.L >= 24) against gnark_tpu's host SRS;
  * on a card (marker ``cuda``), each kind's kernel against its plain
    version on the same CUDA tensors:

        python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_fixed_base.py

    (the file imports jax only inside its slow test).

Tolerance: none.  Limbs compare exactly; points compare as Python ints.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gnark_tpu_torch.backend import kzg
from gnark_tpu_torch.curves import ALL_CURVES
from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops import fixed_base as FB
from gnark_tpu_torch.ops import msm as M
from gnark_tpu_torch.ops.ec import points_to_host
from gnark_tpu_torch.ops.limbs import ints_to_limbs
from torch_kinds import KINDS, group, r_mod

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "gnark_tpu_torch", "csrc")

# A launch runs its blocks one after another, each block's 2 groups on 2 G
# host threads; a group's __syncwarp is a barrier of its own G threads
# (and counts a mask that is not the group's).
HARNESS = r"""
#include <barrier>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>
struct Dim { unsigned x; };
static Dim blockDim;
static thread_local Dim threadIdx, blockIdx;
static int group_size, bad_masks;
static std::vector<std::unique_ptr<std::barrier<>>> groups;
static void warp_sync(unsigned mask) {
  const unsigned first = threadIdx.x % 32 / group_size * group_size;
  if (mask != ((1u << group_size) - 1u) << first) ++bad_masks;
  groups[threadIdx.x / group_size]->arrive_and_wait();
}
#define __global__
#define __shared__ static
#define __launch_bounds__(...)
#define __syncthreads()
#define __syncwarp(mask) warp_sync(mask)
#include "msm_kernels.cu"

// a curve's shipped scan: fixed_base_sliced_kernel over fp4
template <class Cv> static void scan(const int64_t* sc, const uint32_t* t,
    int64_t* out, int n, int Ls, int c, int nwin) {
  constexpr int G = Cv::LEAF_GROUP, T = leaf_threads<Cv>();
  if constexpr (FpKTraits<typename Cv::F>::SLICED)
    fixed_base_sliced_kernel<Cv, G, T, Cv::LEAF_BLOCKS>(sc, t, out, n, Ls, c,
                                                       nwin);
  else
    fixed_base_kernel<Cv, G>(sc, t, out, n, Ls, c, nwin);
}
template <class Cv> static int grid(const int64_t* sc, const uint32_t* t,
    int64_t* out, int n, int Ls, int c, int nwin) {
  constexpr int G = Cv::LEAF_GROUP, per_block = 2;
  bad_masks = 0;
  blockDim.x = per_block * G;
  group_size = G;
  for (long b = 0; b < (n + per_block - 1) / per_block; ++b) {
    groups.clear();
    for (int i = 0; i < per_block; ++i)
      groups.push_back(std::make_unique<std::barrier<>>(G));
    std::vector<std::thread> lanes;
    for (int l = 0; l < per_block * G; ++l)
      lanes.emplace_back([=] {
        blockIdx.x = (unsigned)b;
        threadIdx.x = l;
        scan<Cv>(sc, t, out, n, Ls, c, nwin);
      });
    for (auto& l : lanes) l.join();
  }
  return bad_masks;
}
#define HOST(NAME, CV)                                                        \
  extern "C" int host_fixed_base_##NAME(const int64_t* sc,                    \
      const uint32_t* t, int64_t* out, int n, int Ls, int c, int nwin) {      \
    return grid<CV>(sc, t, out, n, Ls, c, nwin); }
HOST(g1, G1)
HOST(g2, G2)
HOST(g1_bls24315, G1Bls24)
HOST(g2_bls24315, G2Bls24)
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("fixed_base_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    lib = d / "libfixed_base_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", f"-I{CSRC}", "-o", str(lib), str(src)],
                   check=True)
    return ctypes.CDLL(str(lib))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _host_scan(lib, kind, table, sc):
    """The kernel source's [3L, n] on the host, on the table's
    point-major copy as the wrapper passes it."""
    L = _cuda._L16[kind]
    points = FB.point_major(table.tx, table.ty, table.tinf)
    assert points.dtype == torch.int32 and points.is_contiguous()
    assert points.shape == (table.nwin, 1 << table.c, _cuda.entry_words(L))
    out = torch.full((3 * L, sc.shape[1]), -1, dtype=torch.int64)
    bad = getattr(lib, f"host_fixed_base_{kind}")(
        _ptr(sc), _ptr(points), _ptr(out), sc.shape[1], sc.shape[0],
        table.c, table.nwin)
    assert bad == 0, f"{bad} __syncwarp masks that are not the group's"
    return out


def reference(kind):
    """gnark_tpu's host curve and generator of a kind, which the expected
    points come from (imported here: the card's tests run without jax)."""
    from gnark_tpu import curves as J
    curve = J.BLS24_315 if kind.endswith("_bls24315") else J.BN254
    if kind.startswith("g1"):
        return curve.host_g1, curve.g1_gen
    return curve.host_g2, curve.g2_gen


def _expected(kind, gen, vals):
    """gnark_tpu's s * G for each s of vals, G the port's generator."""
    JH, jgen = reference(kind)
    assert jgen == gen
    return [JH.scalar_mul(jgen, v) for v in vals]


def _scalars(kind, bits, c, seed, n=8):
    """n scalars below 2^bits (and r): 0, 1, the largest, 2^c - 1, 2^c,
    then seeded ones; as ints and as [bits / 16, n] limb planes."""
    top = min(1 << bits, r_mod(kind)) - 1
    rng = np.random.default_rng(seed)
    vals = [0, 1, top, (1 << c) - 1, 1 << c]
    vals += [int.from_bytes(rng.bytes(bits // 8), "little") % top
             for _ in range(n - len(vals))]
    return vals, torch.from_numpy(
        ints_to_limbs(vals, bits // 16).astype(np.int64))


CASES = [(kind, c) for kind in KINDS for c in (3, 8)] + [("g1", 12)]


@pytest.mark.parametrize("kind,c", CASES)
def test_kernel_source_matches_plain_on_host_threads(host_lib, kind, c):
    """64-bit scalars: nwin = ceil(64 / c) windows, the top one reaching
    past the scalar's four limbs at c = 3 and 12."""
    G, H, gen, _ = group(kind)
    table = FB.FixedBaseTable(G, H, gen, 64, "cpu", c)
    vals, sc = _scalars(kind, 64, c, seed=c)
    want = FB.fixed_base_plain(table, sc)
    assert torch.equal(_host_scan(host_lib, kind, table, sc), want)
    assert points_to_host(G, M.split_points(want, G.F.L)) == _expected(
        kind, gen, vals)


@pytest.mark.parametrize("kind", ["g1", "g2_bls24315"])
def test_an_entry_flagged_infinite_leaves_the_sum(host_lib, kind):
    """Entry (w, d) of a digit in use flagged infinite: every column with
    that digit in window w sums the other windows alone, in the plain
    version and in the kernel source alike."""
    G, H, gen, _ = group(kind)
    c = 8
    table = FB.FixedBaseTable(G, H, gen, 64, "cpu", c)
    vals = [0x0102_0304_0506_0708, 0x0102_0304_0506_0709, 5 << 16, 77]
    sc = torch.from_numpy(ints_to_limbs(vals, 4).astype(np.int64))
    w, d = 1, 0x07                     # the first two columns' window 1
    table.tinf[w, d] = True
    want = FB.fixed_base_plain(table, sc)
    assert torch.equal(_host_scan(host_lib, kind, table, sc), want)
    r = r_mod(kind)
    expect = [v - (d << (c * w)) if (v >> (c * w)) & 0xFF == d else v
              for v in vals]
    assert expect[:2] != vals[:2] and expect[2:] == vals[2:]
    assert points_to_host(G, M.split_points(want, G.F.L)) == _expected(
        kind, gen, [e % r for e in expect])


@pytest.mark.parametrize("kind", ["g1_bls24315", "g2_bls24315"])
def test_bls24_315_plain_matches_host_scalar_mul(kind):
    """Full-width scalars below r through FixedBaseTable at c = 4 (64
    windows; the fp4 table stays small), against gnark_tpu's host
    curve."""
    G, H, gen, _ = group(kind)
    table = FB.FixedBaseTable(G, H, gen, 256, "cpu", 4)
    r = r_mod(kind)
    rng = np.random.default_rng(24)
    vals = [0, 1, r - 1] + [int.from_bytes(rng.bytes(32), "little") % r
                            for _ in range(3)]
    sc = torch.from_numpy(ints_to_limbs(vals, 16).astype(np.int64))
    assert points_to_host(G, table(sc)) == _expected(kind, gen, vals)
    assert not M.plain_on_cuda["fixed_base"]


def test_wrapper_routes_and_checks():
    G, H, gen, _ = group("g1")
    table = FB.FixedBaseTable(G, H, gen, 16, "cpu", 8)
    assert table.points is None          # the kernel's copy lives on a card
    sc = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        FB.fixed_base(table, sc.to("meta"))
    points = FB.point_major(table.tx, table.ty, table.tinf)
    with pytest.raises(ValueError, match="window width"):
        _cuda.fixed_base(sc, points, 17, "g1")
    with pytest.raises(ValueError, match="table: want shape"):
        _cuda.fixed_base(sc, points[:, :128].contiguous(), 8, "g1")
    with pytest.raises(ValueError, match="table: want a contiguous "
                                         "torch.int32 CUDA tensor"):
        _cuda.fixed_base(sc, points.to(torch.int64), 8, "g1")
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.fixed_base(sc.to(torch.int32), points, 8, "g1")
    assert not any(_cuda.launches.values())
    # the table's words: limbs 2i, 2i + 1 in word i, then the flag
    x = table.tx[1, :, 5]
    word = int(points[1, 5, 0]) & 0xFFFFFFFF
    assert word == int(x[0]) | int(x[1]) << 16
    assert int(points[0, 0, 16]) == 1 and int(points[1, 5, 16]) == 0


def test_new_srs_native_route_equals_jax_host_srs():
    """BLS12-381 (fp.L = 24, no kernel kind): the powers on the native
    core, the SRS still on the device it was asked for, the same points
    as gnark_tpu's host SRS (its native core too)."""
    from gnark_tpu.backend import kzg as jk
    from gnark_tpu.curves import BLS12_381 as JBLS12_381
    tau = 0x1234_5678_9ABC_DEF0
    curve = ALL_CURVES["bls12_381"]
    srs = kzg.new_srs(curve, 6, tau=tau, device="cpu")
    want = jk.new_srs(JBLS12_381, 6, tau=tau, host=True)
    assert srs.g1 == want.g1 and srs.g1[0] == curve.g1_gen
    assert (srs.g2_gen, srs.g2_tau) == (want.g2_gen, want.g2_tau)
    assert srs.device == torch.device("cpu")
    assert kzg.new_srs(curve, 6, tau=tau, host=True).device is None


@pytest.mark.slow
@pytest.mark.parametrize("c", [8, 12])
@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_plain_matches_jax_scan(kind, c):
    """BN254 at 8 scalars: the port's FixedBaseTable (fixed_base_plain)
    and gnark_tpu's (its jitted lax.scan on the CPU) give the same
    points, the host curve's scalar multiples."""
    import jax.numpy as jnp
    from gnark_tpu.backend.groth16 import _CurveKernels
    from gnark_tpu.curves import BN254 as JBN254
    from gnark_tpu.ops.fixed_base import FixedBaseTable as JaxTable
    G, H, gen, _ = group(kind)
    JK = _CurveKernels(JBN254)
    JG = JK.g1 if kind == "g1" else JK.g2
    vals, sc = _scalars(kind, 256, c, seed=40 + c)
    jt = JaxTable(JG, H, gen, 256, c, pack=None if kind == "g1" else
                  JK.fp2.pack)
    jout = jt(jnp.asarray(sc.numpy().astype(np.uint32)))
    want = [H.scalar_mul(gen, v) for v in vals]
    table = FB.FixedBaseTable(G, H, gen, 256, "cpu", c)
    assert points_to_host(G, table(sc)) == want
    assert points_to_host(G, tuple(torch.from_numpy(
        np.asarray(a).astype(np.int64)) for a in jout)) == want


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_on_cuda(dev, kind):
    """Each kind's kernel, one launch, against its plain version on the
    same CUDA tensors: full-width scalars, 37 columns (a ragged block) at
    c = 8, and 64-bit ones at c = 12 (windows past the top limb); and
    through the wrapper from a strided view of the scalars, as setup's
    slices of its planes can be."""
    G, H, gen, _ = group(kind)
    for bits, c, n in ((256, 8, 37), (64, 12, 9)):
        table = FB.FixedBaseTable(G, H, gen, bits, dev, c)
        vals, sc = _scalars(kind, bits, c, seed=c, n=n)
        sc = sc.to(dev)
        before = _cuda.launches[f"fixed_base_{kind}"]
        out = FB.fixed_base(table, sc)
        torch.cuda.synchronize()
        assert _cuda.launches[f"fixed_base_{kind}"] == before + 1
        assert torch.equal(out, FB.fixed_base_plain(table, sc))
        assert points_to_host(G, table(sc)) == [H.scalar_mul(gen, v)
                                                for v in vals]
        wide = torch.zeros((sc.shape[0], 2 * n), dtype=sc.dtype, device=dev)
        wide[:, ::2] = sc
        assert not wide[:, ::2].is_contiguous()
        assert torch.equal(FB.fixed_base(table, wide[:, ::2]), out)
