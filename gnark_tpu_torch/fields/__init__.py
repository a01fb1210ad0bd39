"""Prime-field registry.

Mirrors the role of gnark-crypto's per-curve fr/fp packages (reference
SURVEY §2.9) but as data: one FieldSpec per field, all kernels generic.
"""

from gnark_tpu_torch.fields.spec import FieldSpec, W, MASK

# --- BN254 (alt_bn128) ----------------------------------------------------
BN254_FR = FieldSpec(
    name="bn254_fr",
    modulus=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    multiplicative_generator=5,
)
BN254_FP = FieldSpec(
    name="bn254_fp",
    modulus=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    multiplicative_generator=3,
)

# --- BLS12-381 -------------------------------------------------------------
BLS12_381_FR = FieldSpec(
    name="bls12_381_fr",
    modulus=52435875175126190479447740508185965837690552500527637822603658699938581184513,
    multiplicative_generator=7,
)
BLS12_381_FP = FieldSpec(
    name="bls12_381_fp",
    modulus=4002409555221667393417789825735904156556882819939007885332058136124031650490837864442687629129015664037894272559787,
    multiplicative_generator=2,
)

# --- BLS12-377 -------------------------------------------------------------
BLS12_377_FR = FieldSpec(
    name="bls12_377_fr",
    modulus=8444461749428370424248824938781546531375899335154063827935233455917409239041,
    multiplicative_generator=22,
)
BLS12_377_FP = FieldSpec(
    name="bls12_377_fp",
    modulus=258664426012969094010652733694893533536393512754914660539884262666720468348340822774968888139573360124440321458177,
    multiplicative_generator=15,
)

# --- BLS24-315 (embedding degree 24; 2-chain inner of BW6-633) -------------
# Derived in-repo from the seed x = -0xbfcfffff (recovered from the GLV
# lambda + Frobenius constants embedded in the reference's
# std/algebra/fields_bls24315/e24.go; p/r verified prime, r = x^8-x^4+1,
# p = (x-1)^2 r/3 + x, r | #E).
BLS24_315_FR = FieldSpec(
    name="bls24_315_fr",
    modulus=11502027791375260645628074404575422495959608200132055716665986169834464870401,
    multiplicative_generator=7,
)
BLS24_315_FP = FieldSpec(
    name="bls24_315_fp",
    modulus=39705142709513438335025689890408969744933502416914749335064285505637884093126342347073617133569,
    multiplicative_generator=13,
)

# --- BW6-761 (2-chain outer curve over BLS12-377; EHG19) -------------------
# fr(BW6-761) IS fp(BLS12-377): circuits over it express BLS12-377 base
# field math natively (one-layer recursion).  761-bit fp derived from the
# BLS12-377 seed x via the EHG19 polynomial (verified prime + CM eq here).
BW6_761_FP = FieldSpec(
    name="bw6_761_fp",
    modulus=6891450384315732539396789682275657542479668912536150109513790160209623422243491736087683183289411687640864567753786613451161759120554247759349511699125301598951605099378508850372543631423596795951899700429969112842764913119068299,
    multiplicative_generator=2,
)

# --- BW6-633 (2-chain outer curve over BLS24-315) ---------------------------
# fr(BW6-633) IS fp(BLS24-315).  PINNED to the published El Housni-
# Guillevic instance (eprint 2021/1359; gnark-crypto ecc/bw6-633): this
# modulus is the UNIQUE 633-bit prime p = (t^2+3y^2)/4 over all lifts
# t = t0+ht*r, y = y0+hy*r with |ht|,|hy| <= 25 in BOTH Frobenius-
# eigenvalue families (the published lift is ht = -7, hy = ±1 by sign
# convention).  Curve coefficients verified in curves/__init__.py.
BW6_633_FP = FieldSpec(
    name="bw6_633_fp",
    modulus=20494478644167774678813387386538961497669590920908778075528754551012016751717791778743535050360001387419576570244406805463255765034468441182772056330021723098661967429339971741066259394985997,
    multiplicative_generator=2,
)

ALL_FIELDS = {
    f.name: f
    for f in (BN254_FR, BN254_FP, BLS12_381_FR, BLS12_381_FP, BLS12_377_FR,
              BLS12_377_FP, BW6_761_FP, BLS24_315_FR, BLS24_315_FP,
              BW6_633_FP)
}

__all__ = [
    "FieldSpec", "W", "MASK", "ALL_FIELDS",
    "BN254_FR", "BN254_FP",
    "BLS12_381_FR", "BLS12_381_FP",
    "BLS12_377_FR", "BLS12_377_FP",
    "BW6_761_FP", "BLS24_315_FR", "BLS24_315_FP", "BW6_633_FP",
]
