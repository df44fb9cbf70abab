"""LUT generation, error tables and the low-rank error factorisation (port
of ``repro.core.lut``).

The paper's LUT generator tabulates the ACU once (``2^b x 2^b``) so every
multiply becomes a gather. The LOWRANK mode factorises the *error* table
``E = LUT - a*w`` with an SVD, so a GEMM becomes an exact integer product
plus a rank-r float correction (``kernels/err_matmul``); ``trunc_masks``
gives the FACTORED mode its operand mask. All of it is numpy on the host,
the reference's arithmetic step for step, so ``f`` and ``g`` come out
bitwise equal to the reference's on the same machine.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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


@dataclasses.dataclass(frozen=True)
class LowRankError:
    """Rank-r factorisation ``E[a,w] ~= f[a,:] @ g[w,:].T``.

    ``f``, ``g``: (n_codes, r) float32, indexed by shifted code + offset.
    The metrics say how faithful the factorised product is to the table,
    per scalar multiply.
    """

    rank: int
    f: np.ndarray
    g: np.ndarray
    max_abs_err: float       # max |E - fg| over the grid
    mean_abs_err: float
    exact_frac: float        # fraction of grid entries with |E - fg| < 0.5
    energy: float            # captured singular-value energy fraction


def factorize_error(mult: Multiplier, rank: int,
                    lut: Optional[np.ndarray] = None) -> LowRankError:
    """SVD of the error table truncated at ``rank``: dense for tables of at
    most 1024 codes, a randomised range finder (seeded) above."""
    E = build_error_table(mult, lut).astype(np.float64)
    n = E.shape[0]
    if n <= 1024:
        U, s, Vt = np.linalg.svd(E, full_matrices=False)
    else:
        rng = np.random.default_rng(0)
        p = min(n, rank + 16)
        Y = E @ rng.standard_normal((n, p))
        Q, _ = np.linalg.qr(Y)
        B = Q.T @ E
        Ub, s, Vt = np.linalg.svd(B, full_matrices=False)
        U = Q @ Ub
    r = min(rank, len(s))
    sq = np.sqrt(s[:r])
    f = (U[:, :r] * sq[None, :]).astype(np.float32)
    g = (Vt[:r, :].T * sq[None, :]).astype(np.float32)
    recon = f.astype(np.float64) @ g.astype(np.float64).T
    d = np.abs(E - recon)
    tot = float((s ** 2).sum()) or 1.0
    return LowRankError(
        rank=r, f=f, g=g,
        max_abs_err=float(d.max()),
        mean_abs_err=float(d.mean()),
        exact_frac=float((d < 0.5).mean()),
        energy=float((s[:r] ** 2).sum() / tot),
    )


def rank_for_fidelity(mult: Multiplier, max_rank: int = 64,
                      target_exact_frac: float = 1.0) -> LowRankError:
    """Smallest power-of-two rank whose rounded reconstruction reaches the
    target exact fraction (doubling search; the last one tried if none
    does)."""
    lut = build_lut(mult)
    best = None
    r = 1
    while r <= max_rank:
        lr = factorize_error(mult, r, lut)
        best = lr
        if lr.exact_frac >= target_exact_frac:
            return lr
        r *= 2
    return best


def trunc_masks(mult: Multiplier) -> Optional[int]:
    """The operand mask of a truncation-family multiplier, for the FACTORED
    (algebraically exact) mode: ``M[a,w] = (a & m) * (w & m)``; None for
    any other family."""
    if "_trunc" in mult.name:
        t = int(mult.name.rsplit("trunc", 1)[-1])
        return ~((1 << t) - 1)
    return None
