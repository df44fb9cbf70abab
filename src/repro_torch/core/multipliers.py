"""Approximate multiplier zoo (closed forms, any bitwidth).

Port of ``repro.core.multipliers``. Each multiplier is a vectorised integer
function ``fn(a, w)`` over signed operands in ``[-2^(b-1), 2^(b-1)-1]``,
written in PyTorch int32 as the reference writes it in ``jnp.int32``, so the
FUNCTIONAL mode evaluates it per product on whatever device its operands
live on (a CUDA tensor never leaves the card). Called with numpy arrays or
Python ints (the table builders, ``error_stats``), it computes on the CPU
and returns a numpy array.

* ``exact``     — reference multiplier.
* ``trunc(t)``  — low ``t`` bits of both operands gated to zero.
* ``bam(k)``    — broken-array multiplier: partial-product diagonals
                  ``i + j < k`` perforated (sign-magnitude core).
* ``mitchell``  — Mitchell logarithmic multiplier (piecewise-linear log).
* ``drum(k)``   — DRUM-style dynamic-range multiplier: top-``k``-bit windows
                  with the LSB set for unbiasedness.

``mul8s_1L2H`` / ``mul12s_2KM`` name the paper's two evaluation roles
("lossy, low-power 8-bit" / "near-exact 12-bit").
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Multiplier:
    """A b-bit x b-bit signed approximate multiplier model."""

    name: str
    bits: int
    fn: Callable[[Tensor, Tensor], Tensor]
    description: str = ""

    def __call__(self, a, w):
        """Products of ``a`` and ``w`` (broadcast). Tensors in, an int32
        tensor out on their device; anything else in, a numpy array out."""
        if isinstance(a, Tensor) or isinstance(w, Tensor):
            dev = a.device if isinstance(a, Tensor) else w.device
            return self.fn(torch.as_tensor(a, device=dev).to(torch.int32),
                           torch.as_tensor(w, device=dev).to(torch.int32))
        out = self.fn(torch.from_numpy(np.asarray(a, np.int64)).to(torch.int32),
                      torch.from_numpy(np.asarray(w, np.int64)).to(torch.int32))
        return out.numpy()

    @property
    def lo(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def hi(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def n_codes(self) -> int:
        return 1 << self.bits


def _floor_log2(m: Tensor, bits: int) -> Tensor:
    """Exact ``floor(log2 m)`` for integers ``1 <= m <= 2^bits``, by
    comparisons against each power of two (no float log, whose rounding on
    a device the port would have to trust)."""
    t = torch.zeros_like(m)
    for b in range(1, bits + 1):
        t = t + (m >= (1 << b)).to(m.dtype)
    return t


# ---------------------------------------------------------------------------
# multiplier families
# ---------------------------------------------------------------------------

def exact_fn(a: Tensor, w: Tensor) -> Tensor:
    return a * w


def make_exact(bits: int) -> Multiplier:
    return Multiplier(f"mul{bits}s_exact", bits, exact_fn, "exact reference")


def make_trunc(bits: int, t: int) -> Multiplier:
    """Gate the low ``t`` bits of both operands to zero, then multiply."""
    mask = ~((1 << t) - 1)

    def fn(a, w):
        return (a & mask) * (w & mask)

    return Multiplier(f"mul{bits}s_trunc{t}", bits, fn,
                      f"operand truncation, {t} LSBs gated")


def make_bam(bits: int, k: int) -> Multiplier:
    """Broken-array multiplier: drop partial-product diagonals ``i+j < k``.

    ``p = sign(a)*sign(w) * sum_{i+j>=k} a_i w_j 2^(i+j)``.
    """

    def fn(a, w):
        sgn = torch.sign(a) * torch.sign(w)
        ma, mw = torch.abs(a), torch.abs(w)
        acc = torch.zeros(torch.broadcast_shapes(a.shape, w.shape),
                          dtype=torch.int32, device=a.device)
        for i in range(bits):
            jmin = max(0, k - i)
            if jmin >= bits:
                continue
            bit_i = (ma >> i) & 1
            acc = acc + ((bit_i * (mw & ~((1 << jmin) - 1))) << i)
        return sgn * acc

    return Multiplier(f"mul{bits}s_bam{k}", bits, fn,
                      f"broken-array, diagonals < {k} perforated")


def make_mitchell(bits: int) -> Multiplier:
    """Mitchell logarithmic multiplier (sign-magnitude), evaluated in Q15
    fixed point exactly as the reference."""
    fb = 15

    def fn(a, w):
        sgn = torch.sign(a) * torch.sign(w)
        ma, mw = torch.abs(a), torch.abs(w)
        safe_ma, safe_mw = torch.clamp_min(ma, 1), torch.clamp_min(mw, 1)
        k1, k2 = _floor_log2(safe_ma, bits), _floor_log2(safe_mw, bits)
        p1, p2 = torch.ones_like(k1) << k1, torch.ones_like(k2) << k2
        x1 = ((safe_ma - p1) << fb) // torch.clamp_min(p1, 1)
        x2 = ((safe_mw - p2) << fb) // torch.clamp_min(p2, 1)
        s = x1 + x2
        one = 1 << fb
        ksum = k1 + k2

        def shift_to(v, sh):
            left = v << torch.clamp(sh, 0, 30)
            right = v >> torch.clamp(-sh, 0, 30)
            return torch.where(sh >= 0, left, right)

        p = torch.where(s < one, shift_to(one + s, ksum - fb),
                        shift_to(s, ksum + 1 - fb))
        p = torch.where((ma == 0) | (mw == 0), torch.zeros_like(p), p)
        return sgn * p

    return Multiplier(f"mul{bits}s_mitchell", bits, fn,
                      "Mitchell log multiplier")


def make_drum(bits: int, k: int) -> Multiplier:
    """DRUM-style: multiply the leading-``k``-bit windows, LSB set."""

    def fn(a, w):
        sgn = torch.sign(a) * torch.sign(w)

        def window(m):
            t = _floor_log2(torch.clamp_min(m, 1), bits)
            shift = torch.clamp_min(t - (k - 1), 0)
            wnd = ((m >> shift) | (shift > 0).to(m.dtype)) << shift
            return torch.where(m == 0, torch.zeros_like(wnd), wnd)

        return sgn * (window(torch.abs(a)) * window(torch.abs(w)))

    return Multiplier(f"mul{bits}s_drum{k}", bits, fn,
                      f"DRUM dynamic-range, {k}-bit windows")


# ---------------------------------------------------------------------------
# registry + named roles from the paper
# ---------------------------------------------------------------------------

def _registry() -> dict[str, Multiplier]:
    muls = [
        make_exact(8), make_exact(12),
        make_trunc(8, 2), make_trunc(8, 3), make_trunc(8, 4),
        make_trunc(12, 2), make_trunc(12, 3),
        make_bam(8, 6), make_bam(8, 8), make_bam(8, 10),
        make_bam(12, 8),
        make_mitchell(8), make_mitchell(12),
        make_drum(8, 4), make_drum(8, 6), make_drum(12, 6),
    ]
    reg = {m.name: m for m in muls}
    # the paper's evaluation roles: mul8s_1L2H -> bam(8,5),
    # mul12s_2KM -> drum(12,11)
    reg["mul8s_1L2H"] = dataclasses.replace(make_bam(8, 5), name="mul8s_1L2H")
    reg["mul12s_2KM"] = dataclasses.replace(make_drum(12, 11),
                                            name="mul12s_2KM")
    return reg


REGISTRY = _registry()


def get_multiplier(name: str) -> Multiplier:
    if name not in REGISTRY:
        raise KeyError(f"unknown multiplier {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def error_stats(mult: Multiplier) -> dict[str, float]:
    """Exhaustive MAE / MRE over the full operand grid (MAE normalised by
    the largest product magnitude 2^(2b); MRE over nonzero exact
    products)."""
    vals = np.arange(mult.lo, mult.hi + 1, dtype=np.int64)
    a, w = vals[:, None], vals[None, :]
    exact = a * w
    err = np.abs(mult(a, w).astype(np.int64) - exact)
    mae = float(err.mean() / float(1 << (2 * mult.bits)) * 100.0)
    nz = exact != 0
    mre = float((err[nz] / np.abs(exact[nz])).mean() * 100.0)
    return {"mae_pct": mae, "mre_pct": mre, "worst_case_err": float(err.max()),
            "n_codes": mult.n_codes, "bits": mult.bits}
