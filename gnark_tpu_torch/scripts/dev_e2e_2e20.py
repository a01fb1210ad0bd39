"""Groth16 over a chain of 2^log2_n - 2 squarings (2^log2_n - 1
constraints, the reference's benchmark circuit shape,
internal/backend/bn254/groth16/groth16_test.go:57): setup on the card,
one cold and two warm proves with per-phase seconds, verify, and reject a
wrong public input (counterpart of scripts/dev_e2e_2e20.py).

    python -m gnark_tpu_torch.scripts.dev_e2e_2e20 [log2_n] [curve] [--cache]

  log2_n: chain length exponent (default 20)
  curve:  bn254 | bls12_381 | bls12_377 (default bn254); BLS12 takes the
          native route (``groth16.native_route``): key points and MSMs on
          the native core, the quotient on the card
  --cache: read the key from .cache/ under the repo root, or write it
          there after setup (key_io's .npz and a pickled verifying key)

At log2_n = 20 the key holds 2^21 points a batch (2^20 + 1 wires padded
to a power of two), so every MSM runs the windowed plan at c = 14 in
window chunks (ops/msm.py).
"""

from __future__ import annotations

import os
import pickle
import random
import sys
import time

import torch

from gnark_tpu_torch.backend import groth16, key_io
from gnark_tpu_torch.curves import BLS12_377, BLS12_381, BN254
from gnark_tpu_torch.frontend.compile import compile_circuit
from gnark_tpu_torch.frontend.schema import Circuit, Public, Secret

CURVES = {"bn254": BN254, "bls12_381": BLS12_381, "bls12_377": BLS12_377}
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".cache")
X0 = 3
PROVES = ("cold", "warm", "warm2")


def square_chain(nlog: int) -> Circuit:
    """y = x^(2^(2^nlog - 2)): one constraint a squaring and the final
    assert, so the domain is exactly 2^nlog."""
    n_sq = (1 << nlog) - 2

    class SquareChain(Circuit):
        x = Secret()
        y = Public()

        def define(self, api):
            v = self.x
            for _ in range(n_sq):
                v = api.mul(v, v)
            api.assert_is_equal(v, self.y)

    return SquareChain()


def chain_output(nlog: int, q: int, x0: int = X0) -> int:
    """The chain's public output on the host."""
    y = x0
    for _ in range((1 << nlog) - 2):
        y = y * y % q
    return y


def _peak(device):
    """The allocator's peak bytes on a CUDA device since the last reset,
    else None."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device)


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def run(nlog: int = 20, curve: str = "bn254", device="cuda", log=print,
        cache: str | None = None) -> dict:
    """Compile, set up (``random.Random(42)``), solve the host witness,
    prove cold, warm and warm2 (``random.Random(7)`` each), verify, and
    check that ``y + 1`` is rejected.  ``cache``: a directory to read
    the key from, or write it to after setup.  Returns the seconds of
    each step (``setup_parts``: setup's own phases; ``proves``: label ->
    (seconds, phases)), the peak bytes of the setup and of the proves
    (None off CUDA), the constraint system, the key pair, y and the last
    proof."""
    spec = CURVES[curve]
    device = groth16._device(device)
    q = spec.fr.modulus
    tag = f"[groth16 sq2e{nlog}{'' if curve == 'bn254' else ' ' + curve}]"
    out = {"proves": {}, "setup_parts": {}}

    t0 = time.perf_counter()
    cs = compile_circuit(square_chain(nlog), spec)
    out["compile"] = time.perf_counter() - t0
    log(f"{tag} compile {out['compile']:.2f} s: {cs.nb_constraints} "
        f"constraints, {cs.nb_wires} wires")

    path = cache and os.path.join(cache, f"e2e_sq_{curve}_{nlog}")
    _reset_peak(device)
    t0 = time.perf_counter()
    if path and os.path.exists(path + ".npz"):
        pk = key_io.groth16_pk_read(path + ".npz", device=device)
        with open(path + ".vk", "rb") as f:
            vk = pickle.load(f)
        how = "read from the key cache"
    else:
        pk, vk = groth16.setup(cs, spec, rng=random.Random(42),
                               device=device, timings=out["setup_parts"])
        how = "on the card" if device.type == "cuda" else f"on {device}"
    out["setup"] = time.perf_counter() - t0
    out["setup_peak"] = _peak(device)
    parts = ", ".join(f"{k} {v:.3f}" for k, v in out["setup_parts"].items())
    log(f"{tag} setup {how} {out['setup']:.2f} s (domain {pk.domain_n}, "
        f"n_pad {pk.n_pad}){': ' + parts if parts else ''}")
    if path and not os.path.exists(path + ".npz"):
        os.makedirs(cache, exist_ok=True)
        key_io.groth16_pk_write(pk, path + ".npz")
        with open(path + ".vk", "wb") as f:
            pickle.dump(vk, f)

    t0 = time.perf_counter()
    y = chain_output(nlog, q)
    out["witness"] = time.perf_counter() - t0
    log(f"{tag} host witness {out['witness']:.2f} s")

    out["prove_peak"] = None
    for label in PROVES:
        timings = {}
        _reset_peak(device)
        t0 = time.perf_counter()
        proof = groth16.prove(cs, pk, [y, X0], rng=random.Random(7),
                              timings=timings)
        total = time.perf_counter() - t0
        peak = _peak(device)
        if peak is not None:
            out["prove_peak"] = max(out["prove_peak"] or 0, peak)
        out["proves"][label] = (total, timings)
        log(f"{tag} prove {label} {total:.2f} s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in timings.items()))

    t0 = time.perf_counter()
    ok = groth16.verify(proof, vk, [y])
    bad = groth16.verify(proof, vk, [(y + 1) % q])
    out["verify"] = time.perf_counter() - t0
    log(f"{tag} verify {ok}, y + 1 {'accepted' if bad else 'rejected'} "
        f"({out['verify']:.2f} s)")
    if out["setup_peak"] is not None:
        log(f"{tag} peak memory: setup {out['setup_peak'] / 1e9:.2f} GB, "
            f"prove {out['prove_peak'] / 1e9:.2f} GB")
    assert ok, "the proof does not verify"
    assert not bad, "the proof verifies y + 1"
    out.update(cs=cs, pk=pk, vk=vk, y=y, proof=proof)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    flags = [a for a in argv if a.startswith("--")]
    args = [a for a in argv if not a.startswith("--")]
    nlog = int(args[0]) if args else 20
    curve = args[1] if len(args) > 1 else "bn254"
    run(nlog, curve, cache=CACHE if "--cache" in flags else None,
        log=lambda m: print(m, flush=True))
    print(f"E2E OK: 2^{nlog} {curve} device prove verified", flush=True)


if __name__ == "__main__":
    main()
