"""Witness container + gnark-compatible binary serialization.

Reference: backend/witness/witness.go — binary protocol is
`uint32(len) | len big-endian field elements` (witness.go:19-23), with
the full witness ordered [public... | secret...] (the constant-one wire
is NOT serialized).
"""

from __future__ import annotations

import dataclasses
import json
import struct

from gnark_tpu_torch.frontend import schema as schema_mod


@dataclasses.dataclass
class Witness:
    values: list            # ints, ordered [public (no one-wire) | secret]
    nb_public: int          # excluding the one-wire
    field_modulus: int
    public_names: list = dataclasses.field(default_factory=list)
    secret_names: list = dataclasses.field(default_factory=list)

    @classmethod
    def from_assignment(cls, assignment, curve, public_only: bool = False):
        pub = schema_mod.collect_values(assignment, "public")
        sec = [] if public_only else schema_mod.collect_values(assignment, "secret")
        q = curve.fr.modulus
        pub_s, sec_s = schema_mod.schema_of(type(assignment))
        return cls(values=[v % q for v in pub + sec],
                   nb_public=len(pub), field_modulus=q,
                   public_names=[l for _, _, l in pub_s],
                   secret_names=[] if public_only else [l for _, _, l in sec_s])

    def public(self) -> "Witness":
        return Witness(values=self.values[:self.nb_public],
                       nb_public=self.nb_public,
                       field_modulus=self.field_modulus,
                       public_names=self.public_names)

    # -- binary: u32 count | big-endian fr elements ----------------------

    @property
    def _fr_bytes(self) -> int:
        return (self.field_modulus.bit_length() + 7) // 8

    def to_bytes(self) -> bytes:
        out = [struct.pack(">I", len(self.values))]
        size = self._fr_bytes
        for v in self.values:
            out.append((v % self.field_modulus).to_bytes(size, "big"))
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data: bytes, field_modulus: int, nb_public: int):
        (n,) = struct.unpack_from(">I", data, 0)
        size = (field_modulus.bit_length() + 7) // 8
        vals = []
        off = 4
        for _ in range(n):
            vals.append(int.from_bytes(data[off:off + size], "big"))
            off += size
        return cls(values=vals, nb_public=nb_public, field_modulus=field_modulus)

    # -- json (named leaves) -----------------------------------------------

    def to_json(self) -> str:
        names = self.public_names + self.secret_names
        return json.dumps({n: str(v) for n, v in zip(names, self.values)})

    @classmethod
    def from_json(cls, text: str, field_modulus: int, public_names: list,
                  secret_names: list):
        """Inverse of to_json: values resolved by leaf name
        (backend/witness/witness.go:158 UnmarshalJSON analog)."""
        data = json.loads(text)
        names = list(public_names) + list(secret_names)
        vals = [int(data[n], 0) % field_modulus for n in names
                if n in data]
        if len(vals) != len(names):
            missing = [n for n in names if n not in data]
            raise ValueError(f"witness json missing leaves: {missing}")
        return cls(values=vals, nb_public=len(public_names),
                   field_modulus=field_modulus,
                   public_names=list(public_names),
                   secret_names=list(secret_names))
