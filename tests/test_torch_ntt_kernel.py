"""The quotient's kernels (gnark_tpu_torch/csrc/ntt_kernels.cu) on the host,
and the two functions of gnark_tpu that the port lacked until them.

  * the kernel source compiled for the host with g++ (field.cuh's portable
    product; a launch run as host threads, a block's threads sharing a
    std::barrier as __syncthreads and a buffer as its shared memory), a
    transform driven through the source's own ``ntt_passes`` (the card's
    sequence of pass launches) with ``_cuda.ntt_args``' arguments, for all
    six scalar fields: DIF and DIT, plain and coset, forward and inverse,
    at n = 1, 2, 32, 64 and 1,024 with tiles of 16 (so the strided and
    contiguous passes both run: one strided pass of one stage at 32, of
    two at 64, three at 1,024), as one thread and as 2 blocks of 3
    threads, and at n = 8,192 with the shipped tile, against the plain
    version and against gnark_tpu.backend.groth16._host_ntt (the JAX
    package's own host chain); the source's pass plan (ntt_plan, the
    library's alone) at largest tiles of 2^3 to 2^12 and at each field's
    shipped one; the values p - 1, 0 and 1 through every pass boundary;
    the broadcast pre-scale and compute_h's two regular-form transforms;
    the pointwise step (a b - c) d against the plain field ops;
  * the traits structs' constants (p, R mod p, -p^-1 mod 2^32) against
    the field specs;
  * the routing: CPU tensors run the plain version, any other device
    raises, the wrappers refuse CPU tensors, ``fr_kind`` refuses a field
    with no kernels;
  * ``groth16.dummy_setup`` and ``fixed_base.batch_scalar_mul`` against
    gnark_tpu's;
  * ``compute_h(..., regular=True)``, prove's form, against from_mont of
    ``compute_h`` of to_mont's, bit for bit, over BN254's fr at n = 64
    and 1,024 and BW6-761's at 64;
  * under ``-m slow``: the port's Domain and compute_h against gnark_tpu's
    Domain and _compute_h through XLA on the CPU, over BW6-761's fr.

(tests/test_torch_cuda.py runs the kernels themselves on a card.)

Tolerance: none.  Field elements compare exactly as Python ints or limbs.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import gnark_tpu.frontend.schema as jax_schema
from gnark_tpu.backend import groth16 as jg
from gnark_tpu.backend.groth16 import _host_ntt
from gnark_tpu.curves import ALL_CURVES as JAX_CURVES
from gnark_tpu_torch.backend import groth16 as tg
from gnark_tpu_torch.curves import ALL_CURVES
from gnark_tpu_torch.fields.spec import FieldSpec
from gnark_tpu_torch.frontend import schema as torch_schema
from gnark_tpu_torch.frontend.compile import compile_circuit
from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops import ntt as N
from gnark_tpu_torch.ops.ec import CurveOps, points_to_host
from gnark_tpu_torch.ops.fixed_base import batch_scalar_mul
from gnark_tpu_torch.ops.limbs import field_ops, ints_to_limbs

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "gnark_tpu_torch", "csrc")
KINDS = list(_cuda.FR_KINDS)
# the traits struct of each kind in csrc/field.cuh
STRUCTS = {"fr_bn254": "BN254Fr", "fr_bls12_381": "BLS12381Fr",
           "fr_bls12_377": "BLS12377Fr", "fr_bls24_315": "BLS24315Fr",
           "fr_bw6_761": "BLS12377Fp", "fr_bw6_633": "BLS24315Fp"}
SHAPES = [(inverse, order, coset) for inverse in (False, True)
          for order in ("DIF", "DIT") for coset in (False, True)]
# compute_h's regular-form transforms, (shape, (regular_in, regular_out)):
# its iFFT takes regular planes in, its coset iFFT gives h out in regular
# form
REGULAR_SHAPES = [((True, "DIF", False), (True, False)),
                  ((True, "DIF", True), (False, True))]


def spec_of(kind):
    return ALL_CURVES[kind[3:]].fr


HARNESS = r"""
#include <barrier>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>
struct Dim { unsigned x; };
static thread_local Dim blockIdx, threadIdx;
static Dim blockDim, gridDim;
static thread_local std::barrier<>* block_barrier;
#define __global__
#define __syncthreads() block_barrier->arrive_and_wait()
#include "ntt_kernels.cu"

// a launch of `blocks` blocks of `threads` threads, each a host thread;
// a block's threads share its barrier (__syncthreads) and its buffer of
// `words` words (shared memory)
template <class Body>
static void launch(int blocks, int threads, long words, Body body) {
  blockDim.x = threads;
  gridDim.x = blocks;
  std::vector<std::vector<uint32_t>> smem(blocks,
                                          std::vector<uint32_t>(words));
  std::vector<std::unique_ptr<std::barrier<>>> bars;
  for (int b = 0; b < blocks; ++b)
    bars.emplace_back(std::make_unique<std::barrier<>>(threads));
  std::vector<std::thread> pool;
  for (int b = 0; b < blocks; ++b)
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, b, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        block_barrier = bars[b].get();
        body(smem[b].data());
      });
  for (auto& th : pool) th.join();
}
template <class P, bool DIT>
static int host_ntt(const int64_t* x, int64_t* y, const int64_t* tw,
                    long tw_stride, const int64_t* pre, long pre_stride,
                    int pre_step, const int64_t* post, long post_stride,
                    int post_step, long n, int tlog, int blocks,
                    int threads) {
  int k = 0;
  while ((1L << k) < n) ++k;
  return ntt_passes(x, y, pre, post, n, DIT, tlog,
                    [&](const int64_t* src, const int64_t* pr,
                        const int64_t* po, int s0, int m, int c, int t) {
                      launch(blocks, threads, ntt_smem_words<P>(t),
                             [&](uint32_t* sm) {
                               ntt_pass<P, DIT>(src, y, tw, tw_stride, pr,
                                                pre_stride, pre_step, po,
                                                post_stride, post_step, k,
                                                s0, m, c, t, sm);
                             });
                      return 0;
                    });
}
extern "C" int host_ntt_tiles_log() { return NTT_TILES_LOG; }
// the passes (s0, m, c, t) in the order ntt_passes runs them, into out
extern "C" int host_ntt_plan(long n, int dit, int tlog, int* out) {
  int i = 0;
  return ntt_passes(nullptr, nullptr, nullptr, nullptr, n, dit, tlog,
                    [&](const int64_t*, const int64_t*, const int64_t*,
                        int s0, int m, int c, int t) {
                      out[i++] = s0;
                      out[i++] = m;
                      out[i++] = c;
                      out[i++] = t;
                      return 0;
                    });
}
#define HOST(NAME, FIELD)                                                     \
  extern "C" int host_ntt_##NAME(                                             \
      const int64_t* x, int64_t* y, const int64_t* tw, long tw_stride,        \
      const int64_t* pre, long pre_stride, int pre_step, const int64_t* post, \
      long post_stride, int post_step, long n, int dit, int tlog,             \
      int blocks, int threads) {                                              \
    return dit ? host_ntt<FIELD, true>(x, y, tw, tw_stride, pre, pre_stride,  \
                                       pre_step, post, post_stride,           \
                                       post_step, n, tlog, blocks, threads)   \
               : host_ntt<FIELD, false>(x, y, tw, tw_stride, pre, pre_stride, \
                                        pre_step, post, post_stride,          \
                                        post_step, n, tlog, blocks, threads); \
  }                                                                           \
  extern "C" long host_ntt_smem_words_##NAME(int tlog) {                      \
    return ntt_smem_words<FIELD>(tlog);                                       \
  }                                                                           \
  extern "C" int host_ntt_tile_max_##NAME() { return NTT_TILE_MAX<FIELD>; }   \
  extern "C" void host_fr_pointwise_##NAME(                                   \
      const int64_t* a, const int64_t* b, const int64_t* c, const int64_t* d, \
      long d_stride, int d_step, int64_t* out, long n) {                      \
    launch(1, 1, 0, [&](uint32_t*) {                                          \
      fr_pointwise_kernel<FIELD>(a, b, c, d, d_stride, d_step, out, n);       \
    });                                                                       \
  }
HOST(fr_bn254, BN254Fr)
HOST(fr_bls12_381, BLS12381Fr)
HOST(fr_bls12_377, BLS12377Fr)
HOST(fr_bls24_315, BLS24315Fr)
HOST(fr_bw6_761, BLS12377Fp)
HOST(fr_bw6_633, BLS24315Fp)
"""
SMALL_TILE = 4      # tiles of 16 elements in the host harness


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("ntt_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    lib = d / "libntt_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", f"-I{CSRC}", "-o", str(lib), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib))
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    for kind in KINDS:
        fn = getattr(lib, f"host_ntt_{kind}")
        fn.argtypes = [vp, vp, vp, cl, vp, cl, ci, vp, cl, ci, cl, ci, ci,
                       ci, ci]
        fn.restype = ci
        fn = getattr(lib, f"host_ntt_smem_words_{kind}")
        fn.argtypes = [ci]
        fn.restype = cl
        getattr(lib, f"host_ntt_tile_max_{kind}").restype = ci
        fn = getattr(lib, f"host_fr_pointwise_{kind}")
        fn.argtypes = [vp, vp, vp, vp, cl, ci, vp, cl]
    lib.host_ntt_plan.argtypes = [cl, ci, ci, vp]
    lib.host_ntt_plan.restype = ci
    lib.host_ntt_tiles_log.restype = ci
    return lib


def host_plan(lib, n, tlog, dit=False):
    """The source's passes (s0, m, c, t) of an n-point transform whose
    largest tile is 2^tlog, in the order ntt_passes runs them."""
    out = (ctypes.c_int * 256)()
    count = lib.host_ntt_plan(n, int(dit), tlog, out)
    return [tuple(out[4 * i:4 * i + 4]) for i in range(count)]


def host_transform(lib, kind, d, x, inverse, order, coset, tlog=SMALL_TILE,
                   launch=(1, 1), regular=(False, False)):
    """The kernel route's transform over the host build: one call, its
    passes (``host_plan`` at tiles of 2^tlog) in the source's own order,
    each a launch of ``launch`` = (blocks, threads)."""
    tw, pre, post = d.operands(inverse, order, coset, *regular)
    y = torch.empty_like(x)
    ran = getattr(lib, f"host_ntt_{kind}")(
        *_cuda.ntt_args(x, y, tw.contiguous(), pre, post, order == "DIT"),
        tlog, *launch)
    assert ran == len(host_plan(lib, d.n, tlog)), (ran, d.n, tlog)
    return y


def host_chain(vals, d, inverse, order, coset):
    """The transform from gnark_tpu's _host_ntt: natural order in and out
    there; bit-reversed input for DIT, bit-reversed output for DIF."""
    q, n = d.spec.modulus, d.n
    brev = N.bit_reverse_perm(n)
    x = [vals[b] for b in brev] if order == "DIT" else list(vals)
    if not inverse:
        if coset:
            x = [v * pow(d.coset_gen, i, q) % q for i, v in enumerate(x)]
        out = _host_ntt(x, d.omega, q)
    else:
        out = _host_ntt(x, d.omega, q, inverse=True)
        if coset:
            out = [v * pow(d.coset_gen_inv, i, q) % q
                   for i, v in enumerate(out)]
    return [out[b] for b in brev] if order == "DIF" else out


def values(q, n, seed):
    """p - 1, 0 and 1 first, then seeded values below q."""
    rng = np.random.default_rng(seed)
    rnd = [int.from_bytes(rng.bytes(q.bit_length() // 8 + 1), "little") % q
           for _ in range(n)]
    return ([q - 1, 0, 1] + rnd)[:n]


@pytest.mark.parametrize("n", [1, 2, 32, 64, 1024])
@pytest.mark.parametrize("kind", KINDS)
def test_stage_kernel_source_matches_plain_and_host_ntt(host_lib, kind, n):
    """Every transform shape through the kernel source's ntt_passes at
    tiles of 16, the kernel route's order of passes (the pre-scale on the
    first pass's load, the post-scale on the last's store; one pass at n
    <= 16, a strided pass of kA = 1 stage over 8 of 16 columns at n = 2T
    = 32, three strided passes at 1,024), run as one thread and as 2
    blocks of 3 threads, against the plain version's limbs and
    _host_ntt's values."""
    spec = spec_of(kind)
    d = N.Domain(spec, n, "cpu")
    vals = values(spec.modulus, n, n + len(kind))
    x = d.F.pack(vals, "cpu")
    before = x.clone()
    for inverse, order, coset in SHAPES:
        got = host_transform(host_lib, kind, d, x, inverse, order, coset)
        want = d.transform_plain(x, *d.operands(inverse, order, coset),
                                 order)
        assert torch.equal(got, want), (kind, n, inverse, order, coset)
        assert torch.equal(host_transform(host_lib, kind, d, x, inverse,
                                          order, coset, launch=(2, 3)),
                           want), (kind, n, inverse, order, coset)
        assert d.F.unpack(got) == host_chain(vals, d, inverse, order,
                                             coset), (inverse, order, coset)
    assert torch.equal(x, before), "the kernel route wrote its input"


@pytest.mark.parametrize("n", [2048, 8192])
@pytest.mark.parametrize("kind", KINDS)
def test_pass_kernel_source_at_the_shipped_tile(host_lib, kind, n):
    """n = 2,048 and 8,192 with the card's largest tile (the source's
    NTT_TILE_MAX): 2,048 one pass over the whole tile of 2^11 at N = 8
    words, two at 10 and 12; 8,192 a strided pass of 5 stages then a
    contiguous one of 8 (tiles of 2^8, the smallest that takes two
    passes), every shape, as 3 blocks of 4 threads, against the plain
    version."""
    spec = spec_of(kind)
    tlog = getattr(host_lib, f"host_ntt_tile_max_{kind}")()
    assert tlog == (11 if spec.L == 16 else 10), tlog
    assert len(host_plan(host_lib, n, tlog)) == (1 if n <= 1 << tlog else 2)
    d = N.Domain(spec, n, "cpu")
    x = d.F.pack(values(spec.modulus, n, 29), "cpu")
    for inverse, order, coset in SHAPES:
        got = host_transform(host_lib, kind, d, x, inverse, order, coset,
                             tlog=tlog, launch=(3, 4))
        want = d.transform_plain(x, *d.operands(inverse, order, coset),
                                 order)
        assert torch.equal(got, want), (kind, inverse, order, coset)


@pytest.mark.parametrize("kind", KINDS)
def test_stage_kernel_source_on_edge_values(host_lib, kind):
    """p - 1, 0 and 1 through every butterfly and every pass boundary:
    all p - 1, p - 1 against 0, and 1 against p - 1, at n = 64 (every
    stage's twiddles; a strided pass of two stages, then a contiguous
    one of four at tiles of 16), each shape against the plain version."""
    spec = spec_of(kind)
    q, n = spec.modulus, 64
    d = N.Domain(spec, n, "cpu")
    for vals in ([q - 1] * n, [q - 1, 0] * (n // 2), [1, q - 1] * (n // 2),
                 [0] * n):
        x = d.F.pack(vals, "cpu")
        for inverse, order, coset in SHAPES:
            got = host_transform(host_lib, kind, d, x, inverse, order, coset)
            want = d.transform_plain(x, *d.operands(inverse, order, coset),
                                     order)
            assert torch.equal(got, want), (vals[:2], inverse, order, coset)


@pytest.mark.parametrize("kind", KINDS)
def test_pass_kernel_source_takes_broadcast_pre_and_regular_forms(host_lib,
                                                                  kind):
    """A broadcast pre-scale ([L, 1]: one value, p - 1 and a seeded one)
    on the first pass's load, and compute_h's two regular-form transforms
    (REGULAR_SHAPES: R as the iFFT's broadcast pre-scale, R^-1 folded into
    the coset iFFT's post table), at n = 64 on tiles of 16, against the
    plain version; their limbs equal to_mont before the transform and
    from_mont after it."""
    spec = spec_of(kind)
    q, n = spec.modulus, 64
    d = N.Domain(spec, n, "cpu")
    F = d.F
    x = F.pack(values(q, n, 31), "cpu")
    for v in (q - 1, values(q, 4, 37)[3]):
        for order in ("DIF", "DIT"):
            tw, _, post = d.operands(True, order, False)
            pre = F.pack([v], "cpu")
            y = torch.empty_like(x)
            ran = getattr(host_lib, f"host_ntt_{kind}")(
                *_cuda.ntt_args(x, y, tw, pre, post, order == "DIT"),
                SMALL_TILE, 2, 3)
            assert ran == len(host_plan(host_lib, n, SMALL_TILE)) == 2
            assert torch.equal(y, d.transform_plain(x, tw, pre, post, order))
    for (inverse, order, coset), regular in REGULAR_SHAPES:
        got = host_transform(host_lib, kind, d, x, inverse, order, coset,
                             regular=regular)
        ops = d.operands(inverse, order, coset, *regular)
        assert torch.equal(got, d.transform_plain(x, *ops, order))
        want = d.transform_plain(F.to_mont(x) if regular[0] else x,
                                 *d.operands(inverse, order, coset), order)
        assert torch.equal(got, F.from_mont(want) if regular[1] else want), \
            (regular, coset)


def test_pass_plan_matches_ntt_plan(host_lib):
    """The source's ntt_plan, as ntt_passes runs it (DIT in reverse),
    with largest tiles of 2^3 to 2^12 and n = 1 to 2^22: one pass where n
    fits the largest tile; else the fewest passes that tile allows, every
    strided pass of at most t - 2 stages over 2^(t - m) >= 4 columns, the
    stages 0 .. k - 1 each once, at the tile t that ntt_tile_log picks
    (the largest that takes no more passes and leaves 2^NTT_TILES_LOG
    tiles, else the smallest that takes no more passes); at each field's
    largest tile (NTT_TILE_MAX) two passes from 2T to 2^20 (N = 8) or
    2^18 (N = 10, 12), the largest transforms each field runs, in shared
    memory that an H100 block may take."""
    tiles_log = host_lib.host_ntt_tiles_log()

    def count(k, t):
        return 1 + -(-max(k - t, 0) // (t - 2))
    for tlog in range(3, 13):
        for k in range(23):
            n = 1 << k
            plan = host_plan(host_lib, n, tlog)
            assert host_plan(host_lib, n, tlog, dit=True) == plan[::-1]
            t = plan[0][3]
            assert all(p[3] == t for p in plan), plan
            assert [s0 for s0, _, _, _ in plan] == list(np.cumsum(
                [0] + [m for _, m, _, _ in plan[:-1]])), plan
            assert sum(m for _, m, _, _ in plan) == k
            assert all(1 <= m <= t - 2 and c == t - m
                       for _, m, c, _ in plan[:-1]), plan
            assert plan[-1][:3] == (k - min(k, t), min(k, t), 0)
            assert len(plan) == count(k, t) == count(k, tlog), (tlog, k)
            assert 3 <= t <= max(tlog, 3)
            if k <= tlog:
                assert len(plan) == 1 and t == max(k, 3)
            else:
                assert t == 3 or count(k, t - 1) > len(plan) \
                    or k - t >= tiles_log, (tlog, k, t)
                assert t == tlog or k - t - 1 < tiles_log
    for kind in KINDS:
        tlog = getattr(host_lib, f"host_ntt_tile_max_{kind}")()
        top = 20 if _cuda.FR_KINDS[kind] == 16 else 18
        assert [len(host_plan(host_lib, 1 << k, tlog))
                for k in range(top + 1)] \
            == [1] * (tlog + 1) + [2] * (top - tlog), kind
        words = getattr(host_lib, f"host_ntt_smem_words_{kind}")(tlog)
        assert 4 * words <= 227 * 1024, kind


@pytest.mark.parametrize("name,n", [("bn254", 64), ("bn254", 1024),
                                    ("bw6_761", 64)])
def test_compute_h_regular_form_equals_conversions_around_it(name, n):
    """compute_h(..., regular=True), prove's form (regular planes in, h
    out in regular form, the conversions on the first and last passes),
    equals from_mont(compute_h(to_mont(a), to_mont(b), to_mont(c))) bit
    for bit on the CPU route, p - 1, 0 and 1 among the inputs."""
    spec = ALL_CURVES[name].fr
    d = N.Domain(spec, n, "cpu")
    F = d.F
    abc = [torch.from_numpy(ints_to_limbs(values(spec.modulus, n, s),
                                          spec.L).astype(np.int64))
           for s in (41, 42, 43)]
    want = F.from_mont(tg.compute_h(d, *(F.to_mont(t) for t in abc)))
    assert torch.equal(tg.compute_h(d, *abc, regular=True), want)


@pytest.mark.parametrize("kind", KINDS)
def test_pointwise_kernel_source_matches_field_ops(host_lib, kind):
    """(a b - c) d over 256 elements, p - 1, 0 and 1 among each operand's
    values, with d one broadcast value and with d a full plane."""
    spec = spec_of(kind)
    F, q, n = field_ops(spec), spec.modulus, 256
    a, b, c, dv = (F.pack(values(q, n, s)[::-1] if s % 2 else
                          values(q, n, s), "cpu") for s in range(4))
    fn = getattr(host_lib, f"host_fr_pointwise_{kind}")
    for d in (dv, F.pack([q - 1], "cpu"), F.pack([5], "cpu")):
        out = torch.empty_like(a)
        fn(*_cuda.fr_pointwise_args(a, b, c, d, out))
        want = F.mul(F.sub(F.mul(a, b), c), d)
        assert torch.equal(out, want)
        assert torch.equal(N.fr_pointwise_plain(F, a, b, c, d), want)
        ai, bi, ci_, di = (F.unpack(t) for t in (a, b, c, d))
        di = di * n if len(di) == 1 else di
        assert F.unpack(out) == [(x * y - z) * w % q for x, y, z, w in
                                 zip(ai, bi, ci_, di)]


def test_kernel_constants_match_field_specs():
    """p, R mod p (R = 2^(32 N)) and -p^-1 mod 2^32 of each traits struct
    in field.cuh, recomputed from the kind's field spec; N = L / 2."""
    field = open(os.path.join(CSRC, "field.cuh")).read()
    for kind, struct in STRUCTS.items():
        spec = spec_of(kind)
        body = field[field.index(f"struct {struct} {{"):]
        body = body[:body.index("\n};") + 3]
        nw = int(re.search(r"N = (\d+);", body).group(1))
        assert nw == spec.L // 2 == _cuda.FR_KINDS[kind] // 2, kind

        def val(fn):
            m = re.search(fn + r"\(int i\) \{\s*constexpr uint32_t v\[(\d+)\]"
                          r" = \{([^}]*)\}", body)
            assert int(m.group(1)) == nw
            return sum(int(v.strip().rstrip("u"), 16) << (32 * i)
                       for i, v in enumerate(m.group(2).split(",")))

        p = spec.modulus
        assert val("p") == p, kind
        assert val("one") == (1 << (32 * nw)) % p, kind
        inv = int(re.search(r"INV = (0x[0-9a-f]+)u", body).group(1), 16)
        assert (inv * p) % (1 << 32) == (1 << 32) - 1, kind
        assert 2 * p < 1 << (32 * nw), kind        # the slack bit
    src = open(os.path.join(CSRC, "ntt_kernels.cu")).read()
    launchers = dict(re.findall(r"^GNARK_NTT_LAUNCHERS\((\w+), (\w+)\)", src,
                                re.M))
    assert launchers == STRUCTS


def test_fr_kind_names_each_curves_scalar_field():
    for name, curve in ALL_CURVES.items():
        assert _cuda.fr_kind(curve.fr) == f"fr_{name}"
    with pytest.raises(NotImplementedError):
        _cuda.fr_kind(FieldSpec("goldilocks", (1 << 64) - (1 << 32) + 1, 7))


def test_cpu_tensors_take_the_plain_version_other_devices_raise():
    """On CPU tensors Domain and fr_pointwise run the plain version and
    launch nothing; a tensor on another device raises, as do the
    wrappers given CPU tensors."""
    spec = ALL_CURVES["bn254"].fr
    d = N.Domain(spec, 16, "cpu")
    F = d.F
    x = F.pack(values(spec.modulus, 16, 3), "cpu")
    launched = dict(_cuda.launches)
    plain = dict(N.plain_on_cuda)
    y = d.ifft(d.fft(x, "DIF", coset=True), "DIT", coset=True)
    ones = F.ones(1, "cpu")
    h = N.fr_pointwise(spec, x, x, x, ones)
    assert torch.equal(y, x)          # bit-reversed coset evals and back
    assert torch.equal(h, F.sub(F.mul(x, x), x))
    assert dict(_cuda.launches) == launched
    assert dict(N.plain_on_cuda) == plain
    meta = torch.empty((spec.L, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        d.fft(meta)
    with pytest.raises(ValueError, match="meta"):
        N.fr_pointwise(spec, meta, meta, meta, meta)
    tw, pre, post = d.operands(True, "DIF", True)
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.ntt_transform(x, tw, pre, post, False, "fr_bn254")
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.fr_pointwise(x, x, x, ones, "fr_bn254")


def cubic_circuit(schema):
    class Cubic(schema.Circuit):
        x = schema.Secret()
        y = schema.Public()

        def define(self, api):
            x3 = api.mul(self.x, self.x, self.x)
            api.assert_is_equal(self.y, api.add(x3, self.x, 5))
    return Cubic()


@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_dummy_setup_equals_jax(curve):
    """The fake key's sizes and arrays, every point the generator, as
    gnark_tpu's dummy_setup builds them: on the CPU for BN254, numpy
    planes on the native route (BLS12-381)."""
    from gnark_tpu.frontend.compile import compile_circuit as jax_compile
    jcs = jax_compile(cubic_circuit(jax_schema), JAX_CURVES[curve])
    cs = compile_circuit(cubic_circuit(torch_schema), ALL_CURVES[curve])
    jpk = jg.dummy_setup(jcs, JAX_CURVES[curve])
    pk = tg.dummy_setup(cs, ALL_CURVES[curve], device="cpu")
    assert (pk.domain_n, pk.n_pad) == (jpk.domain_n, jpk.n_pad)
    assert pk.device == torch.device("cpu") and not pk.host
    for name in ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2"):
        assert getattr(pk, name) == getattr(jpk, name), name
    for name in ("A", "B1", "B2", "K", "Z"):
        for got, want in zip(getattr(pk, name), getattr(jpk, name)):
            got = np.asarray(got)
            assert got.shape == np.asarray(want).shape, name
            np.testing.assert_array_equal(got.astype(np.int64),
                                          np.asarray(want).astype(np.int64))


def test_batch_scalar_mul_matches_jax():
    """BN254 G1 at 8 scalars (0, 1, r - 1 among them): gnark_tpu's
    batch_scalar_mul (its jitted scan on the CPU) and the port's give the
    same points, the host curve's scalar multiples."""
    import jax.numpy as jnp
    from gnark_tpu.ops.ec import CurveOps as JaxCurveOps
    from gnark_tpu.ops.fixed_base import batch_scalar_mul as jax_bsm
    from gnark_tpu.ops.limbs import field_ops as jax_field_ops
    curve, jcurve = ALL_CURVES["bn254"], JAX_CURVES["bn254"]
    r = curve.fr.modulus
    scalars = values(r, 8, 11)
    limbs = ints_to_limbs(scalars, curve.fr.L)
    jout = jax_bsm(JaxCurveOps(jax_field_ops(jcurve.fp)), jcurve.host_g1,
                   jcurve.g1_gen, jnp.asarray(limbs))
    G = CurveOps(field_ops(curve.fp), b=curve.b)
    out = batch_scalar_mul(G, curve.host_g1, curve.g1_gen,
                           torch.from_numpy(limbs.astype(np.int64)))
    want = [curve.host_g1.scalar_mul(curve.g1_gen, s) for s in scalars]
    assert points_to_host(G, out) == want
    assert points_to_host(G, tuple(torch.from_numpy(
        np.asarray(a).astype(np.int64)) for a in jout)) == want


@pytest.mark.slow
@pytest.mark.parametrize("n", [16, 64])
def test_domain_and_compute_h_equal_jax_over_bw6_761_fr(n):
    """The port's Domain (every shape) and compute_h against gnark_tpu's
    Domain and _compute_h, jitted by XLA on the CPU, over BW6-761's fr (L
    = 24): the same limbs.  XLA's compiles take minutes, hence slow."""
    import jax.numpy as jnp
    from gnark_tpu.ops.ntt import Domain as JaxDomain
    spec, jspec = ALL_CURVES["bw6_761"].fr, JAX_CURVES["bw6_761"].fr
    d, jd = N.Domain(spec, n, "cpu"), JaxDomain(jspec, n)
    a, b, c = (values(spec.modulus, n, s) for s in (21, 22, 23))
    planes = [d.F.pack(v, "cpu") for v in (a, b, c)]
    jplanes = [jnp.asarray(p.numpy().astype(np.uint32)) for p in planes]
    for inverse, order, coset in SHAPES:
        fn, jfn = (d.ifft, jd.ifft) if inverse else (d.fft, jd.fft)
        got = fn(planes[0], order, coset=coset)
        want = np.asarray(jfn(jplanes[0], order, coset=coset))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    got = tg.compute_h(d, *planes)
    want = np.asarray(jg._compute_h(jd, *jplanes))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# ptxas -v lines of two of the library's kernels, as nvcc prints them
PTXAS_NTT = """\
ptxas info    : Function properties for _Z15ntt_pass_kernelI7BN254FrLb1EEvPKlPlS2_lS2_liS2_liiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers
ptxas info    : Function properties for _Z19fr_pointwise_kernelI10BLS12377FpEvPKlS2_S2_S2_liPll
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 60 registers, used 0 barriers
"""


def test_ptxas_report_names_the_ntt_kernels(host_lib):
    """chip_smoke.py's [ptxas] lines name the pass kernel with its field
    and order (DIT = 1) and the pointwise kernel with its field, and give
    the pass kernel's dynamic shared memory (which ptxas does not see) at
    its kind's largest tile, with the blocks an SM, from the library's
    plan (here the host build's, with 2 blocks an SM standing in for
    CUDA's occupancy)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lines = mod.ptxas_summary(PTXAS_NTT)
    assert lines == [
        "ntt_pass_kernel<BN254Fr, 1>: 72 registers; 0 bytes stack frame, "
        "0 bytes spill stores, 0 bytes spill loads",
        "fr_pointwise_kernel<BLS12377Fp>: 60 registers; 0 bytes stack "
        "frame, 0 bytes spill stores, 0 bytes spill loads"]

    def plan(kind, n, dit):
        tmax = getattr(host_lib, f"host_ntt_tile_max_{kind}")()
        words = getattr(host_lib, f"host_ntt_smem_words_{kind}")
        return [_cuda.NttPass(*p, 4 * words(p[3]), 2)
                for p in host_plan(host_lib, n, tmax, dit)]
    assert mod.ntt_pass_smem(lines, plan) == [
        "ntt_pass_kernel<BN254Fr, 1> (fr_bn254): tiles of 2^11, 109824 "
        "bytes of dynamic shared memory a block, 2 blocks an SM (CUDA's "
        "occupancy)"]
    assert set(mod.FR_STRUCTS.values()) == set(_cuda.FR_KINDS)
    assert {v: k for k, v in mod.FR_STRUCTS.items()} == STRUCTS
