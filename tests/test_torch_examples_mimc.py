"""The one-hash MiMC example proved on the CPU through gnark_tpu_torch's
harness, each proof equal to gnark_tpu's for the same rng (see
test_torch_examples.py).  A file of its own: each of its MSMs takes
seconds on the plain path, so that the test workers share the time.

Tolerance: none; points and scalars compare exactly as Python ints.
"""

import pytest

from test_torch_examples import check_example


@pytest.mark.parametrize("scheme", ["groth16", "plonk"])
def test_mimc_example_proves_on_the_cpu_as_gnark_tpu(scheme):
    check_example("mimc", scheme)
