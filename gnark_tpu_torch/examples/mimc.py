"""MiMC preimage knowledge: hash(secret) == public (examples/mimc/mimc.go)."""

from gnark_tpu_torch.frontend.schema import Circuit, Public, Secret
from gnark_tpu_torch.std.mimc import MiMC


class MiMCCircuit(Circuit):
    pre_image = Secret()
    hash = Public()

    def define(self, api):
        h = MiMC(api)
        h.write(self.pre_image)
        api.assert_is_equal(self.hash, h.sum())
