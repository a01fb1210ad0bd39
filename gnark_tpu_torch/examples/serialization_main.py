"""Serialization walkthrough (examples/serialization/main.go analog;
counterpart of gnark_tpu/examples/serialization_main.py): constraint
system, witness, proof and VK round-trips."""

import random

from gnark_tpu_torch.backend import cs_io, groth16, serialize
from gnark_tpu_torch.backend.witness import Witness
from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.examples.cubic import CubicCircuit
from gnark_tpu_torch.frontend.compile import compile_circuit


def main(device="cuda"):
    """The walkthrough; its key is set up on the host, as gnark_tpu's is,
    and proves on ``device``."""
    cs = compile_circuit(CubicCircuit(), BN254)
    blob = cs_io.cs_to_bytes(cs)
    cs2 = cs_io.cs_from_bytes(blob)
    print(f"constraint system: {len(blob)} bytes, round-trip ok")

    a = CubicCircuit()
    a.x, a.y = 3, 35
    w = Witness.from_assignment(a, BN254)
    w2 = Witness.from_bytes(w.to_bytes(), BN254.fr.modulus, w.nb_public)
    assert w2.values == w.values
    print(f"witness: {len(w.to_bytes())} bytes (u32 count | BE fr), ok")

    pk, vk = groth16.setup(cs2, BN254, rng=random.Random(0), host=True)
    proof = groth16.prove(cs2, groth16.pk_to_device(pk, device), w.values)
    pblob = serialize.proof_to_bytes(proof, BN254)
    assert groth16.verify(serialize.proof_from_bytes(pblob, BN254), vk, [35])
    print(f"proof: {len(pblob)} bytes compressed (Ar|Bs|Krs), verified")

    vblob = serialize.vk_to_bytes(_with_g1s(vk, pk))
    vk2 = serialize.vk_from_bytes(vblob, BN254)
    assert groth16.verify(proof, vk2, [35])
    print(f"vk: {len(vblob)} bytes (bellman layout), verified after reload")


def _with_g1s(vk, pk):
    vk.beta_g1 = pk.beta_g1
    vk.delta_g1 = pk.delta_g1
    return vk


if __name__ == "__main__":
    main()
