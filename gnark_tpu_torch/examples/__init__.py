"""Example circuits (reference examples/: cubic, exponentiate, mimc,
plonk, rollup, serialization).  Each ``main`` proves on the card unless the caller names
another device."""
