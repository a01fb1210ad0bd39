"""Compiled constraint-system serialization (deterministic binary;
counterpart of gnark_tpu/backend/cs_io.py, the same bytes).

The reference serializes compiled CS via deterministic CBOR
(internal/backend/bn254/cs/r1cs.go:466-495 with decode limits).  This
framework uses its own deterministic framed binary: arrays are raw
little-endian numpy buffers, big-int coefficient tables are
length-prefixed big-endian bytes.  Round-trip is bit-exact, so a served
prover can load a compiled circuit without the frontend
(std.register_hints re-binds hint functions by uuid, std/hints.go:18
pattern).
"""

from __future__ import annotations

import io
import json
import struct

import numpy as np

from gnark_tpu_torch.frontend import ir, scs_ir

_MAGIC = b"GTPU"
_VERSION = 1


def _w_bytes(out, b: bytes):
    out.write(struct.pack("<I", len(b)))
    out.write(b)


def _r_bytes(buf) -> bytes:
    (n,) = struct.unpack("<I", buf.read(4))
    return buf.read(n)


def _w_json(out, obj):
    _w_bytes(out, json.dumps(obj, sort_keys=True).encode())


def _r_json(buf):
    return json.loads(_r_bytes(buf).decode())


def _w_ints(out, vals):
    out.write(struct.pack("<I", len(vals)))
    for v in vals:
        b = int(v).to_bytes((int(v).bit_length() + 7) // 8 or 1, "big")
        out.write(struct.pack("<H", len(b)))
        out.write(b)


def _r_ints(buf):
    (n,) = struct.unpack("<I", buf.read(4))
    out = []
    for _ in range(n):
        (k,) = struct.unpack("<H", buf.read(2))
        out.append(int.from_bytes(buf.read(k), "big"))
    return out


def _w_arr(out, arr: np.ndarray, dtype):
    arr = np.ascontiguousarray(arr, dtype=dtype)
    _w_bytes(out, arr.tobytes())


def _r_arr(buf, dtype):
    return np.frombuffer(_r_bytes(buf), dtype=dtype).copy()


def _w_hints(out, hints):
    _w_json(out, [
        {"uuid": h.uuid,
         "inputs": [[[int(w), int(c)] for w, c in lc] for lc in h.inputs],
         "out_wires": [int(w) for w in h.out_wires]}
        for h in hints])


def _r_hints(buf):
    return [ir.Hint(uuid=h["uuid"],
                    inputs=[tuple((w, c) for w, c in lc)
                            for lc in h["inputs"]],
                    out_wires=h["out_wires"])
            for h in _r_json(buf)]


def save_cs(cs, f) -> None:
    """Serialize an ir.R1CS or scs_ir.SCS to a binary file object."""
    own = isinstance(f, str)
    out = open(f, "wb") if own else f
    try:
        out.write(_MAGIC)
        kind = b"R1" if isinstance(cs, ir.R1CS) else b"SC"
        out.write(struct.pack("<HB", _VERSION, 0) + kind)
        _w_json(out, {
            "curve": cs.curve_name,
            "nb_public": cs.nb_public,
            "nb_secret": cs.nb_secret,
            "nb_internal": cs.nb_internal,
            "public_names": cs.public_names,
            "secret_names": cs.secret_names,
            "debug_info": {str(k): v for k, v in cs.debug_info.items()},
        })
        _w_ints(out, [cs.field_modulus])
        _w_ints(out, cs.coeffs)
        _w_hints(out, cs.hints)
        if isinstance(cs, ir.R1CS):
            for M in (cs.L, cs.R, cs.O):
                _w_arr(out, M.indptr, np.int64)
                _w_arr(out, M.wires, np.int32)
                _w_arr(out, M.coeffs, np.int32)
            _w_json(out, cs.levels)
        else:
            for a in (cs.wires_l, cs.wires_r, cs.wires_o,
                      cs.q_l, cs.q_r, cs.q_m, cs.q_o, cs.q_c):
                _w_arr(out, a, np.int32)
            _w_json(out, cs.levels)
    finally:
        if own:
            out.close()


def load_cs(f):
    own = isinstance(f, str)
    buf = open(f, "rb") if own else f
    try:
        assert buf.read(4) == _MAGIC, "not a gnark_tpu constraint system"
        version, _ = struct.unpack("<HB", buf.read(3))
        assert version == _VERSION
        kind = buf.read(2)
        meta = _r_json(buf)
        (modulus,) = _r_ints(buf)
        coeffs = _r_ints(buf)
        hints = _r_hints(buf)
        wire_to_hint = {}
        for i, h in enumerate(hints):
            for w in h.out_wires:
                wire_to_hint[w] = i
        common = dict(
            curve_name=meta["curve"], field_modulus=modulus,
            nb_public=meta["nb_public"], nb_secret=meta["nb_secret"],
            nb_internal=meta["nb_internal"],
            public_names=meta["public_names"],
            secret_names=meta["secret_names"],
            coeffs=coeffs, hints=hints, wire_to_hint=wire_to_hint,
            logs=[], debug_info={int(k): v
                                 for k, v in meta["debug_info"].items()})
        if kind == b"R1":
            mats = []
            for _ in range(3):
                indptr = _r_arr(buf, np.int64)
                wires = _r_arr(buf, np.int32)
                cids = _r_arr(buf, np.int32)
                mats.append(ir.SparseMatrix(indptr, wires, cids))
            levels = _r_json(buf)
            return ir.R1CS(L=mats[0], R=mats[1], O=mats[2],
                           levels=levels, **common)
        arrs = [_r_arr(buf, np.int32) for _ in range(8)]
        levels = _r_json(buf)
        return scs_ir.SCS(
            levels=levels,
            wires_l=arrs[0], wires_r=arrs[1], wires_o=arrs[2],
            q_l=arrs[3], q_r=arrs[4], q_m=arrs[5], q_o=arrs[6],
            q_c=arrs[7], **common)
    finally:
        if own:
            buf.close()


def cs_to_bytes(cs) -> bytes:
    buf = io.BytesIO()
    save_cs(cs, buf)
    return buf.getvalue()


def cs_from_bytes(data: bytes):
    return load_cs(io.BytesIO(data))
