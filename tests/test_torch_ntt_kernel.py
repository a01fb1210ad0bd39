"""The quotient's kernels (gnark_tpu_torch/csrc/ntt_kernels.cu) on the host,
and the two functions of gnark_tpu that the port lacked until them.

  * the kernel source compiled for the host with g++ (field.cuh's portable
    product, a launch run as one thread), a transform driven through the
    source's own ``ntt_stages`` (the card's sequence of stage launches)
    with ``_cuda.ntt_args``' arguments, for all six scalar fields: DIF
    and DIT, plain
    and coset, forward and inverse, at n = 1, 2, 64 and 1,024, against the
    plain version and against gnark_tpu.backend.groth16._host_ntt (the JAX
    package's own host chain); the values p - 1, 0 and 1 through the
    butterflies; the pointwise step (a b - c) d against the plain field
    ops;
  * the traits structs' constants (p, R mod p, -p^-1 mod 2^32) against
    the field specs;
  * the routing: CPU tensors run the plain version, any other device
    raises, the wrappers refuse CPU tensors, ``fr_kind`` refuses a field
    with no kernels;
  * ``groth16.dummy_setup`` and ``fixed_base.batch_scalar_mul`` against
    gnark_tpu's;
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


def spec_of(kind):
    return ALL_CURVES[kind[3:]].fr


HARNESS = r"""
#include <cstdint>
struct Dim { unsigned x; };
static Dim blockIdx, threadIdx, blockDim, gridDim;
#define __global__
#include "ntt_kernels.cu"

// a launch as one thread: the kernels loop over their work with a grid
// stride
static void one_thread() {
  blockIdx.x = threadIdx.x = 0;
  blockDim.x = gridDim.x = 1;
}
template <class P, bool DIT>
static int host_ntt(const int64_t* x, int64_t* y, const int64_t* tw,
                    long tw_stride, const int64_t* pre, const int64_t* post,
                    long post_stride, int post_step, long n) {
  return ntt_stages(x, y, pre, post, n, DIT,
                    [&](const int64_t* src, const int64_t* pr,
                        const int64_t* po, int s) {
                      one_thread();
                      ntt_stage_kernel<P, DIT>(src, y, tw, tw_stride, pr, po,
                                               post_stride, post_step, n, s);
                      return 0;
                    });
}
#define HOST(NAME, FIELD)                                                     \
  extern "C" int host_ntt_##NAME(                                             \
      const int64_t* x, int64_t* y, const int64_t* tw, long tw_stride,        \
      const int64_t* pre, const int64_t* post, long post_stride,              \
      int post_step, long n, int dit) {                                       \
    return dit ? host_ntt<FIELD, true>(x, y, tw, tw_stride, pre, post,        \
                                       post_stride, post_step, n)             \
               : host_ntt<FIELD, false>(x, y, tw, tw_stride, pre, post,       \
                                        post_stride, post_step, n);           \
  }                                                                           \
  extern "C" void host_fr_pointwise_##NAME(                                   \
      const int64_t* a, const int64_t* b, const int64_t* c, const int64_t* d, \
      long d_stride, int d_step, int64_t* out, long n) {                      \
    one_thread();                                                             \
    fr_pointwise_kernel<FIELD>(a, b, c, d, d_stride, d_step, out, n);         \
  }
HOST(fr_bn254, BN254Fr)
HOST(fr_bls12_381, BLS12381Fr)
HOST(fr_bls12_377, BLS12377Fr)
HOST(fr_bls24_315, BLS24315Fr)
HOST(fr_bw6_761, BLS12377Fp)
HOST(fr_bw6_633, BLS24315Fp)
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("ntt_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    lib = d / "libntt_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib), str(src)], check=True)
    lib = ctypes.CDLL(str(lib))
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    for kind in KINDS:
        fn = getattr(lib, f"host_ntt_{kind}")
        fn.argtypes = [vp, vp, vp, cl, vp, vp, cl, ci, cl, ci]
        fn.restype = ci
        fn = getattr(lib, f"host_fr_pointwise_{kind}")
        fn.argtypes = [vp, vp, vp, vp, cl, ci, vp, cl]
    return lib


def host_transform(lib, kind, d, x, inverse, order, coset):
    """The kernel route's transform over the host build: one call, its
    log2 n stages (one at n = 1) in the source's own order."""
    tw, pre, post = d.operands(inverse, order, coset)
    y = torch.empty_like(x)
    ran = getattr(lib, f"host_ntt_{kind}")(
        *_cuda.ntt_args(x, y, tw.contiguous(), pre, post, order == "DIT"))
    assert ran == max(1, d.log_n), (ran, d.n)
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


@pytest.mark.parametrize("n", [1, 2, 64, 1024])
@pytest.mark.parametrize("kind", KINDS)
def test_stage_kernel_source_matches_plain_and_host_ntt(host_lib, kind, n):
    """Every transform shape through the kernel source's ntt_stages, the
    kernel route's order of stages (the pre-scale fused into the first,
    the post-scale into the last, one scaling launch at n = 1), against
    the plain version's limbs and _host_ntt's values."""
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
        assert d.F.unpack(got) == host_chain(vals, d, inverse, order,
                                             coset), (inverse, order, coset)
    assert torch.equal(x, before), "the kernel route wrote its input"


@pytest.mark.parametrize("kind", KINDS)
def test_stage_kernel_source_on_edge_values(host_lib, kind):
    """p - 1, 0 and 1 through every butterfly: all p - 1, p - 1 against 0,
    and 1 against p - 1, at n = 64 (every stage's twiddles), each shape
    against the plain version."""
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
ptxas info    : Function properties for _Z16ntt_stage_kernelI7BN254FrLb1EEvPKlPlS2_lS2_S2_lili
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers
ptxas info    : Function properties for _Z19fr_pointwise_kernelI10BLS12377FpEvPKlS2_S2_S2_liPll
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 60 registers, used 0 barriers
"""


def test_ptxas_report_names_the_ntt_kernels():
    """chip_smoke.py's [ptxas] lines name the stage kernel with its field
    and order (DIT = 1) and the pointwise kernel with its field."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.ptxas_summary(PTXAS_NTT) == [
        "ntt_stage_kernel<BN254Fr, 1>: 56 registers; 0 bytes stack frame, "
        "0 bytes spill stores, 0 bytes spill loads",
        "fr_pointwise_kernel<BLS12377Fp>: 60 registers; 0 bytes stack "
        "frame, 0 bytes spill stores, 0 bytes spill loads"]
