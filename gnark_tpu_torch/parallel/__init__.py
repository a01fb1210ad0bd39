"""Mesh-sharded prover pieces on torch.distributed (counterpart of
gnark_tpu/parallel/): ``multihost`` wires the process group and the
device mesh, ``sharded_msm`` and ``sharded_ntt`` split the MSMs and the
quotient's transforms over one mesh axis, and ``ranks`` spawns the ranks
of one host from a running program (the tests, ``chip_smoke.py``)."""
