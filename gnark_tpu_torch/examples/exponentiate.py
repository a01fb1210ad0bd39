"""y == x**e with e private, via square-and-multiply over e's bits
(examples/exponentiate/exponentiate.go)."""

from gnark_tpu_torch.frontend.schema import Circuit, Public, Secret

BIT_SIZE = 8


class ExponentiateCircuit(Circuit):
    x = Public()
    e = Secret()
    y = Public()

    def define(self, api):
        output = 1
        bits = api.to_binary(self.e, BIT_SIZE)
        for i in range(BIT_SIZE - 1, -1, -1):
            if i != BIT_SIZE - 1:
                output = api.mul(output, output)
            multiply = api.mul(output, self.x)
            output = api.select(bits[i], multiply, output)
        api.assert_is_equal(self.y, output)
