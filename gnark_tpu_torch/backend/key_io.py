"""Proving/verifying key serialization with fast unsafe load (counterpart
of gnark_tpu/backend/key_io.py: the same file format, so a key written by
either package loads in the other).

Reference surface: internal/backend/bn254/groth16/marshal.go:188
(pk.WriteTo), :250 (pk.UnsafeReadFrom — no subgroup checks, memory-layout
load) and plonk/marshal.go:28-234.  The byte layout is gnark_tpu's own
(numpy .npz container: raw limb-plane arrays + compressed header points)
— the capability parity target is setup → save → new process → load →
prove → verify without re-running setup.

Groth16 PK arrays are stored as uint32 planes of 16-bit Montgomery limbs,
the values this package holds as int64 (and the kernels read as 32-bit
limbs), a bool infinity mask beside them.  Write casts them; load is a
file read and one copy an array onto the key's device
(``groth16.key_planes``, the step ``proving_key_from_jax`` takes too) —
the UnsafeReadFrom analog.  A native-route key (``groth16.native_route``)
keeps numpy planes, as setup leaves them.  ``safe=True`` on load
additionally re-checks every G1/G2 header point (on-curve + subgroup),
matching ReadFrom semantics.
"""

from __future__ import annotations

import json

import numpy as np

from gnark_tpu_torch.backend.serialize import PointCodec
from gnark_tpu_torch.curves import ALL_CURVES


def _enc_g1(c, P):
    return np.frombuffer(c.g1_to_bytes(P), np.uint8)


def _enc_g2(c, P):
    return np.frombuffer(c.g2_to_bytes(P), np.uint8)


def _np(a, dtype):
    """A key array (a tensor on any device, or numpy) as numpy ``dtype``."""
    if hasattr(a, "cpu"):
        a = a.cpu().numpy()
    return np.asarray(a).astype(dtype, copy=False)


def _dev_to_np(arrs):
    x, y, inf = arrs
    return _np(x, np.uint32), _np(y, np.uint32), _np(inf, bool)


# ---- Groth16 ----------------------------------------------------------------


def groth16_pk_write(pk, path_or_file):
    """ProvingKey -> .npz (device-layout arrays + compressed points)."""
    if pk.host:
        raise ValueError("host-mode proving keys are not serializable "
                         "(host point lists; re-run setup without host=True)")
    c = PointCodec(pk.curve)
    meta = {
        "kind": "groth16_pk", "curve": pk.curve.name,
        "domain_n": pk.domain_n, "n_pad": pk.n_pad,
    }
    out = {"meta": np.frombuffer(json.dumps(meta).encode(), np.uint8),
           "alpha_g1": _enc_g1(c, pk.alpha_g1),
           "beta_g1": _enc_g1(c, pk.beta_g1),
           "delta_g1": _enc_g1(c, pk.delta_g1),
           "beta_g2": _enc_g2(c, pk.beta_g2),
           "delta_g2": _enc_g2(c, pk.delta_g2)}
    for name in ("A", "B1", "B2", "K", "Z"):
        x, y, inf = _dev_to_np(getattr(pk, name))
        out[f"{name}_x"], out[f"{name}_y"], out[f"{name}_i"] = x, y, inf
    np.savez(path_or_file, **out)


def groth16_pk_read(path_or_file, safe: bool = False, device="cuda"):
    """-> ProvingKey on ``device`` (the card unless the caller names
    another).  safe=False is the UnsafeReadFrom analog: array payloads
    load as-is; safe=True re-validates the header points."""
    from gnark_tpu_torch.backend import groth16

    device = groth16._device(device)
    z = np.load(path_or_file)
    meta = json.loads(bytes(z["meta"]).decode())
    if meta["kind"] != "groth16_pk":
        raise ValueError(f"not a groth16 proving key: {meta['kind']}")
    curve = ALL_CURVES[meta["curve"]]
    c = PointCodec(curve)
    alpha_g1 = c.g1_from_bytes(bytes(z["alpha_g1"]))
    beta_g1 = c.g1_from_bytes(bytes(z["beta_g1"]))
    delta_g1 = c.g1_from_bytes(bytes(z["delta_g1"]))
    beta_g2 = c.g2_from_bytes(bytes(z["beta_g2"]))
    delta_g2 = c.g2_from_bytes(bytes(z["delta_g2"]))
    if safe:
        h1, h2 = curve.host_g1, curve.host_g2
        r = curve.fr.modulus
        for P, grp in ((alpha_g1, h1), (beta_g1, h1), (delta_g1, h1),
                       (beta_g2, h2), (delta_g2, h2)):
            if not grp.is_on_curve(P) or grp.scalar_mul(P, r) is not None:
                raise ValueError("proving key point fails validation")
    native = groth16.native_route(curve)

    def arrs(name):
        return groth16.key_planes(
            (z[f"{name}_x"], z[f"{name}_y"], z[f"{name}_i"]), device, native)

    return groth16.ProvingKey(
        curve=curve, domain_n=meta["domain_n"], n_pad=meta["n_pad"],
        alpha_g1=alpha_g1, beta_g1=beta_g1, delta_g1=delta_g1,
        beta_g2=beta_g2, delta_g2=delta_g2,
        A=arrs("A"), B1=arrs("B1"), B2=arrs("B2"), K=arrs("K"), Z=arrs("Z"),
        device=device)


# ---- PLONK ------------------------------------------------------------------


def _ints_arr(vals, q):
    """int list -> [n, 4] u64 little-endian rows (<= 256-bit fields)."""
    nb = (q.bit_length() + 63) // 64 * 8
    buf = b"".join(int(v % q).to_bytes(nb, "little") for v in vals)
    return np.frombuffer(buf, "<u8").reshape(len(vals), nb // 8)


def _arr_ints(a):
    raw = np.ascontiguousarray(a, "<u8").tobytes()
    nb = 8 * a.shape[1]
    return [int.from_bytes(raw[i * nb:(i + 1) * nb], "little")
            for i in range(a.shape[0])]


def plonk_pk_write(pk, path_or_file):
    """PlonkPK -> .npz.  The SRS G1 powers and 4n-coset precomputations
    are stored so load requires no recomputation (plonk/marshal.go:28
    pk.WriteTo parity, own layout)."""
    curve = pk.curve
    q = curve.fr.modulus
    c = PointCodec(curve)
    meta = {"kind": "plonk_pk", "curve": curve.name, "n": pk.n,
            "ell": pk.ell, "k1": pk.k1 % q, "k2": pk.k2 % q,
            "host_mode": bool(pk.host_mode)}
    if pk.host_mode:
        raise ValueError("host-mode plonk keys are not serializable")
    out = {"meta": np.frombuffer(json.dumps(meta).encode(), np.uint8)}
    # SRS: G1 powers packed coordinate-wise + G2 points
    sx = _ints_arr([0 if P is None else P[0] for P in pk.srs.g1],
                   curve.fp.modulus)
    sy = _ints_arr([0 if P is None else P[1] for P in pk.srs.g1],
                   curve.fp.modulus)
    si = np.array([P is None for P in pk.srs.g1], bool)
    out["srs_x"], out["srs_y"], out["srs_i"] = sx, sy, si
    out["srs_g2_gen"] = _enc_g2(c, pk.srs.g2_gen)
    out["srs_g2_tau"] = _enc_g2(c, pk.srs.g2_tau)
    for nm in ("ql_c", "qr_c", "qm_c", "qo_c", "qc_c",
               "s1_c", "s2_c", "s3_c", "omega_pows"):
        out[nm] = _ints_arr(getattr(pk, nm), q)
    for i in range(3):
        out[f"sigma_{i}"] = _ints_arr(pk.sigma_vals[i], q)
    for i, nm in enumerate(("qlE", "qrE", "qmE", "qoE", "qcE")):
        out[nm] = _np(pk.sel_E[i], np.uint32)
    for i, nm in enumerate(("s1E", "s2E", "s3E")):
        out[nm] = _np(pk.sig_E[i], np.uint32)
    out["x_E"] = _np(pk.x_E, np.uint32)
    out["zh_inv_E"] = _np(pk.zh_inv_E, np.uint32)
    out["l1_E"] = _np(pk.l1_E, np.uint32)
    # VK rides along (it is small) so one file restores a prover
    out["vk"] = np.frombuffer(plonk_vk_to_bytes(pk.vk), np.uint8)
    np.savez(path_or_file, **out)


def plonk_pk_read(path_or_file, device="cuda"):
    """-> PlonkPK with its coset tables on ``device`` (the card unless the
    caller names another)."""
    from gnark_tpu_torch.backend import kzg
    from gnark_tpu_torch.backend.groth16 import _device, key_planes
    from gnark_tpu_torch.backend.plonk import PlonkPK

    device = _device(device)
    z = np.load(path_or_file)
    meta = json.loads(bytes(z["meta"]).decode())
    if meta["kind"] != "plonk_pk":
        raise ValueError(f"not a plonk proving key: {meta['kind']}")
    curve = ALL_CURVES[meta["curve"]]
    c = PointCodec(curve)
    vk = plonk_vk_from_bytes(bytes(z["vk"]), curve)
    xs, ys = _arr_ints(z["srs_x"]), _arr_ints(z["srs_y"])
    infs = z["srs_i"]
    g1 = [None if infs[i] else (xs[i], ys[i]) for i in range(len(xs))]
    srs = kzg.SRS(curve=curve, g1=g1,
                  g2_gen=c.g2_from_bytes(bytes(z["srs_g2_gen"])),
                  g2_tau=c.g2_from_bytes(bytes(z["srs_g2_tau"])),
                  device=device)
    kw = {nm: _arr_ints(z[nm]) for nm in
          ("ql_c", "qr_c", "qm_c", "qo_c", "qc_c", "s1_c", "s2_c", "s3_c",
           "omega_pows")}
    sigma_vals = tuple(_arr_ints(z[f"sigma_{i}"]) for i in range(3))
    sel_E = key_planes([z[nm] for nm in ("qlE", "qrE", "qmE", "qoE", "qcE")],
                       device)
    sig_E = key_planes([z[nm] for nm in ("s1E", "s2E", "s3E")], device)
    x_E, zh_inv_E, l1_E = key_planes(
        [z[nm] for nm in ("x_E", "zh_inv_E", "l1_E")], device)
    return PlonkPK(
        curve=curve, srs=srs, vk=vk, n=meta["n"], ell=meta["ell"],
        k1=meta["k1"], k2=meta["k2"], sigma_vals=sigma_vals,
        sel_E=sel_E, sig_E=sig_E, x_E=x_E, zh_inv_E=zh_inv_E, l1_E=l1_E,
        host_mode=False, **kw)


def plonk_vk_to_bytes(vk) -> bytes:
    """PlonkVK -> bytes: header ints + 8 G1 commitments + 2 G2 points
    (plonk/marshal.go:154 vk.WriteTo parity, own layout)."""
    curve = vk.curve
    c = PointCodec(curve)
    q = curve.fr.modulus
    head = json.dumps({
        "curve": curve.name, "n": vk.n, "ell": vk.ell,
        "k1": vk.k1 % q, "k2": vk.k2 % q, "generator": vk.generator % q,
    }).encode()
    parts = [len(head).to_bytes(4, "big"), head]
    for P in (vk.c_ql, vk.c_qr, vk.c_qm, vk.c_qo, vk.c_qc,
              vk.c_s1, vk.c_s2, vk.c_s3, vk.g1_gen):
        parts.append(c.g1_to_bytes(P))
    parts.append(c.g2_to_bytes(vk.g2_gen))
    parts.append(c.g2_to_bytes(vk.g2_tau))
    return b"".join(parts)


def plonk_vk_from_bytes(data: bytes, curve=None):
    from gnark_tpu_torch.backend.plonk import PlonkVK

    hlen = int.from_bytes(data[:4], "big")
    head = json.loads(data[4:4 + hlen].decode())
    if curve is None:
        curve = ALL_CURVES[head["curve"]]
    elif curve.name != head["curve"]:
        raise ValueError(f"curve mismatch: {curve.name} vs {head['curve']}")
    c = PointCodec(curve)
    off = 4 + hlen
    n1, n2 = c.g1_compressed_size(), c.g2_compressed_size()
    pts = []
    for _ in range(9):
        pts.append(c.g1_from_bytes(data[off:off + n1]))
        off += n1
    g2_gen = c.g2_from_bytes(data[off:off + n2])
    off += n2
    g2_tau = c.g2_from_bytes(data[off:off + n2])
    return PlonkVK(
        curve=curve, n=head["n"], ell=head["ell"], k1=head["k1"],
        k2=head["k2"], generator=head["generator"],
        c_ql=pts[0], c_qr=pts[1], c_qm=pts[2], c_qo=pts[3], c_qc=pts[4],
        c_s1=pts[5], c_s2=pts[6], c_s3=pts[7], g1_gen=pts[8],
        g2_gen=g2_gen, g2_tau=g2_tau)
