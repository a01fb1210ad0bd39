"""gnark_tpu_torch — the Groth16 and PLONK/KZG BN254 provers of gnark_tpu on
PyTorch and CUDA.

A port of the JAX package ``gnark_tpu`` to PyTorch, with its kernels
hand-written in CUDA C++ for Hopper (``csrc/``).  The JAX package stays the
reference: every module here mirrors its counterpart's layout
(``ops/limbs.py`` <-> ``gnark_tpu/ops/limbs.py`` and so on) and the tests
feed both the same inputs.

The package stands alone: the host modules (frontend, solvers, curves and
pairings, fields, ``std``, the native C core, the witness fuzzer ``fuzz``
and the constraint-count snippets ``stats``) are its own copies under the
same relative paths.  ``parallel/`` is the mesh prover on
torch.distributed: ``multihost`` (the process group and the DeviceMesh),
``sharded_msm`` and ``sharded_ntt``, which ``backend.groth16.prove(mesh=)``
runs.  It imports ``torch`` and never ``jax`` or ``gnark_tpu``.
"""

__version__ = "0.2.0"
