"""gnark_tpu_torch — the Groth16 BN254 prover of gnark_tpu on PyTorch and CUDA.

A port of the JAX package ``gnark_tpu`` to PyTorch, with the windowed-MSM
kernels hand-written in CUDA C++ for Hopper (``csrc/``).  The JAX package
stays the reference: every module here mirrors its counterpart's layout
(``ops/limbs.py`` <-> ``gnark_tpu/ops/limbs.py`` and so on) and the tests
feed both the same inputs.

The JAX-free host modules of ``gnark_tpu`` (frontend, solver, curves and
pairings, ``fields.spec``, ``std``, the native C core) are imported, not
copied.  This package imports ``torch`` and never ``jax``.
"""

import os as _os

# gnark_tpu/__init__.py imports jax to enable its compile cache unless this
# is set; the port shares gnark_tpu's host modules and must not load jax.
_os.environ.setdefault("GNARK_TPU_NO_COMPILE_CACHE", "1")

__version__ = "0.1.0"
