"""frontend.Compile analog: schema walk -> wire allocation -> define -> IR.

Reference flow: frontend/compile.go:32 (parse circuit, allocate input
wires public-then-secret, run user Define, builder.Compile()).
"""

from __future__ import annotations

import traceback

from gnark_tpu_torch.frontend import schema as schema_mod
from gnark_tpu_torch.frontend.r1cs_builder import CompileConfig, CompileError, R1CSBuilder


class DefineError(CompileError):
    """A user Define() raised: wrapped with the *user-code* stack frames
    (gnark_tpu_torch internals trimmed), the compile.go:106-110 panic-recovery
    analog (debug/debug.go:10 trimmed stack)."""

    def __init__(self, exc, user_frames):
        self.cause = exc
        where = " -> ".join(user_frames) if user_frames else "?"
        super().__init__(
            f"error in circuit Define(): {type(exc).__name__}: {exc} "
            f"[at {where}]")


def compile_circuit(circuit, curve, scheme: str = "groth16",
                    config: CompileConfig | None = None):
    """Compile a Circuit instance into a constraint system for `curve`.

    scheme: "groth16" -> R1CS; "plonk" -> sparse R1CS (PLONK gates).
    """
    if scheme == "groth16":
        builder = R1CSBuilder(curve, config)
    elif scheme == "plonk":
        from gnark_tpu_torch.frontend.scs_builder import SCSBuilder
        builder = SCSBuilder(curve, config)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")

    def make_leaf(visibility, name):
        if visibility == "public":
            return builder.add_public_variable(name)
        return builder.add_secret_variable(name)

    schema_mod.instantiate(circuit, make_leaf)
    try:
        circuit.define(builder)
    except CompileError:
        raise                       # builder-originated: already precise
    except Exception as exc:
        frames = [
            f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} in {f.name}"
            for f in traceback.extract_tb(exc.__traceback__)
            if "gnark_tpu_torch" not in (f.filename or "")
        ]
        raise DefineError(exc, frames) from exc
    return builder.compile_system()
