"""In-circuit algebra gadgets: extension-field towers and short
Weierstrass curve operations over 2-chain inner curves
(reference std/algebra/{fields_bls12377, sw_bls12377}; the BLS24-315
siblings fields_bls24315, sw_bls24315).  Counterpart of
gnark_tpu/std/algebra.
"""
