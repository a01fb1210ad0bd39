"""PLONK + KZG end-to-end walkthrough (examples/plonk/main.go analog):
compile a circuit to PLONK gates, build an SRS, prove, verify."""

import random

from gnark_tpu_torch.backend import kzg, plonk
from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.examples.cubic import CubicCircuit
from gnark_tpu_torch.frontend.compile import compile_circuit


def main(device="cuda"):
    """The SRS, and so the key, on ``device``."""
    cs = compile_circuit(CubicCircuit(), BN254, scheme="plonk")
    srs = kzg.new_srs(BN254, 64, tau=42, device=device)  # test SRS
    pk, vk = plonk.setup(cs, BN254, srs=srs)
    proof = plonk.prove(cs, pk, [35, 3], rng=random.Random(1))
    assert plonk.verify(proof, vk, [35])
    assert not plonk.verify(proof, vk, [36])
    print("plonk: proof verified (x=3, y=35), wrong input rejected")


if __name__ == "__main__":
    main()
