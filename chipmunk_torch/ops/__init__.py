"""Eager torch ops: attention/MLP references, index ops, the fp8 rule and
the token reorder."""
