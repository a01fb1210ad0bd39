"""x**3 + x + 5 == y (examples/cubic/cubic.go:32)."""

from gnark_tpu_torch.frontend.schema import Circuit, Public, Secret


class CubicCircuit(Circuit):
    x = Secret()
    y = Public()

    def define(self, api):
        x3 = api.mul(self.x, self.x, self.x)
        api.assert_is_equal(self.y, api.add(x3, self.x, 5))


def main(device="cuda"):
    """Full Groth16 flow on the cubic circuit, the keys on ``device``."""
    import random

    from gnark_tpu_torch.backend import groth16
    from gnark_tpu_torch.curves import BN254
    from gnark_tpu_torch.frontend.compile import compile_circuit

    cs = compile_circuit(CubicCircuit(), BN254)
    pk, vk = groth16.setup(cs, BN254, rng=random.Random(0), device=device)
    proof = groth16.prove(cs, pk, [35, 3])
    assert groth16.verify(proof, vk, [35])
    print("cubic: proof verified (x=3, y=35)")


if __name__ == "__main__":
    main()
