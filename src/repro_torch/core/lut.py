"""LUT generation and error tables (port of ``repro.core.lut``).

The paper's LUT generator tabulates the ACU once (``2^b x 2^b``) so every
multiply becomes a gather. The reference's low-rank error
factorisation (``factorize_error`` / ``rank_for_fidelity``) and
``trunc_masks`` belong to the LOWRANK and FACTORED modes, which the port
has not reached yet.
"""
from __future__ import annotations

import numpy as np

from .multipliers import Multiplier


def build_lut(mult: Multiplier) -> np.ndarray:
    """Full (2^b, 2^b) int32 product table, indexed by shifted codes
    ``lut[a - lo, w - lo]``."""
    vals = np.arange(mult.lo, mult.hi + 1, dtype=np.int64)
    return mult(vals[:, None], vals[None, :]).astype(np.int32)


def build_error_table(mult: Multiplier,
                      lut: np.ndarray | None = None) -> np.ndarray:
    """E[a,w] = M[a,w] - a*w (int64)."""
    if lut is None:
        lut = build_lut(mult)
    vals = np.arange(mult.lo, mult.hi + 1, dtype=np.int64)
    return lut.astype(np.int64) - vals[:, None] * vals[None, :]

