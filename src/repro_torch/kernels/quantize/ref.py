"""Plain PyTorch version of the affine quantizer (oracle of the kernel):
``clip(round_half_even(float32(x) / s + z), lo, hi)`` as int32.

``s`` and ``z`` are float32, 0-d (per tensor) or broadcast against ``x``
(per channel). The divide is correctly rounded and the add rounded on its
own, as the reference's ``quantize_ref`` does; ``torch.round`` rounds half
to even. The operand is widened to float32 first, exactly: JAX promotes
``bfloat16 / float32`` to float32, where PyTorch would keep the quotient of
a 0-d float32 divisor in bfloat16.
"""
from __future__ import annotations

import torch


def code_range(bits: int) -> tuple[int, int]:
    """``(lo, hi)`` of signed ``bits``-bit codes."""
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


def as_f32(v, device) -> torch.Tensor:
    """A scale or zero point as a float32 tensor on ``device``. On CUDA a
    divisor must be a tensor on the card: PyTorch turns a divide by a
    Python or CPU scalar into a multiply by its reciprocal there."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def quantize_ref(x: torch.Tensor, scale, zero_point,
                 bits: int = 8) -> torch.Tensor:
    """real -> int32 code within ``code_range(bits)``; ``scale`` and
    ``zero_point`` broadcast against ``x``."""
    lo, hi = code_range(bits)
    s, z = as_f32(scale, x.device), as_f32(zero_point, x.device)
    q = torch.round(x.to(torch.float32) / s + z)
    return torch.clamp(q, lo, hi).to(torch.int32)
