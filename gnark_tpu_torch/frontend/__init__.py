"""Circuit frontend: eDSL -> constraint systems.

Usage:
    class Cubic(Circuit):
        x = Secret()
        y = Public()
        def define(self, api):
            x3 = api.mul(self.x, self.x, self.x)
            api.assert_is_equal(api.add(x3, self.x, 5), self.y)

    cs = compile_circuit(Cubic(), curves.BN254)
"""

from gnark_tpu_torch.frontend.compile import compile_circuit
from gnark_tpu_torch.frontend.r1cs_builder import (
    CompileConfig, CompileError, R1CSBuilder, Variable,
)
from gnark_tpu_torch.frontend.schema import Circuit, Public, Secret

__all__ = [
    "compile_circuit", "Circuit", "Public", "Secret", "Variable",
    "CompileConfig", "CompileError", "R1CSBuilder",
]
