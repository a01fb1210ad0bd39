"""The port's counterparts of the reference's development scripts, each run
as ``python -m gnark_tpu_torch.scripts.<name>``."""
