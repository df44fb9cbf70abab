"""Affine quantization (port of ``repro.core.quantization``).

``real = scale * (code - zero_point)``. Per-tensor or per-channel; the
integer fed to the ACU is ``code - zero_point``.

Rounding is held to the reference's, bit for bit: the quantizer is
``clip(round_half_even(x / s + z), lo, hi)`` with a correctly rounded
divide. On CUDA, PyTorch turns a divide by a Python or CPU scalar into a
multiply by its reciprocal, so every divisor here is a tensor on the
operand's own device. The reference's ``pin_rounding`` has no counterpart:
eager PyTorch rounds each op once, as written, and never reassociates or
contracts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class QParams:
    """Quantization parameters for one tensor. ``scale`` / ``zero_point``
    are 0-d (per-tensor) or 1-d tensors broadcast along ``axis``
    (per-channel); ``zero_point`` lives in code space."""

    scale: torch.Tensor
    zero_point: torch.Tensor
    bits: int
    axis: Optional[int] = None

    @property
    def lo(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def hi(self) -> int:
        return (1 << (self.bits - 1)) - 1

    def _expand(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if self.axis is None:
            return v
        shape = [1] * x.dim()
        shape[self.axis] = -1
        return v.reshape(shape)


def _f32(v, device=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(dtype=torch.float32, device=device or v.device)
    return torch.tensor(v, dtype=torch.float32, device=device)


def symmetric_qparams(calib_max, bits: int,
                      axis: Optional[int] = None) -> QParams:
    """Symmetric quantizer from a calibrated absolute max: the scale is
    ``max(calib_max, 1e-12)`` **divided** by ``hi``."""
    hi = (1 << (bits - 1)) - 1
    m = _f32(calib_max)
    scale = torch.clamp_min(m, 1e-12) / torch.tensor(
        float(hi), dtype=torch.float32, device=m.device)
    return QParams(scale=scale, zero_point=torch.zeros_like(scale),
                   bits=bits, axis=axis)


def inline_symmetric_scale(amax, bits: int) -> torch.Tensor:
    """Per-tensor symmetric scale in the reference's in-graph spelling:
    ``max(amax, 1e-12)`` **multiplied** by the float32 reciprocal of
    ``hi``. It may differ from :func:`symmetric_qparams`'s scale by 1 ulp,
    which is why the two are kept apart."""
    hi = (1 << (bits - 1)) - 1
    m = _f32(amax)
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        float(hi), dtype=torch.float32)
    return torch.clamp_min(m, 1e-12) * inv.to(m.device)


def affine_qparams(xmin, xmax, bits: int,
                   axis: Optional[int] = None) -> QParams:
    """Affine quantizer from calibrated (min, max)."""
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    xmin = torch.clamp_max(_f32(xmin), 0.0)
    xmax = torch.clamp_min(_f32(xmax, xmin.device), 0.0)
    span = torch.tensor(float(hi - lo), dtype=torch.float32,
                        device=xmin.device)
    scale = torch.clamp_min((xmax - xmin) / span, 1e-12)
    lo_t = torch.tensor(float(lo), dtype=torch.float32, device=xmin.device)
    zp = torch.clamp(torch.round(lo_t - xmin / scale), lo, hi)
    return QParams(scale=scale, zero_point=zp, bits=bits, axis=axis)


def quantize(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    """real -> int code (int32, within [lo, hi])."""
    s = qp._expand(x, qp.scale)
    z = qp._expand(x, qp.zero_point)
    q = torch.round(x / s + z)
    return torch.clamp(q, qp.lo, qp.hi).to(torch.int32)


def dequantize(q: torch.Tensor, qp: QParams) -> torch.Tensor:
    s = qp._expand(q, qp.scale)
    z = qp._expand(q, qp.zero_point)
    return (q.to(torch.float32) - z) * s


def acu_operand(q: torch.Tensor, qp: QParams) -> torch.Tensor:
    """Integer operand the approximate multiplier sees: ``code -
    zero_point``."""
    z = qp._expand(q, qp.zero_point)
    return (q - z.to(torch.int32)).to(torch.int32)


class FakeQuant(torch.autograd.Function):
    """``(clip(round(x / s + z), lo, hi) - z) * s`` with the reference's
    straight-through estimator: the gradient passes where ``x / s + z``
    lies inside ``[lo, hi]`` (the same expression as the forward's, so the
    clip edges agree) and is 0 outside; the scale and zero point get
    none."""

    @staticmethod
    def forward(ctx, x, scale, zero_point, lo: float, hi: float):
        t = x / scale + zero_point
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward((t >= lo) & (t <= hi))
        return (torch.clamp(torch.round(t), lo, hi) - zero_point) * scale

    @staticmethod
    def backward(ctx, g):
        (in_range,) = ctx.saved_tensors
        return (torch.where(in_range, g, torch.zeros_like(g)), None, None,
                None, None)


def fake_quantize(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    """Fake-quantize with the STE (differentiable); per-channel qparams
    broadcast along ``qp.axis``."""
    s = qp._expand(x, qp.scale)
    z = qp._expand(x, qp.zero_point)
    return FakeQuant.apply(x, s, z, float(qp.lo), float(qp.hi))


def quantize_symmetric(x: torch.Tensor, scale: torch.Tensor,
                       bits: int) -> torch.Tensor:
    """Per-tensor symmetric codes of the approximate backward:
    ``clip(round(x / s), lo, hi)`` (no zero point), int32."""
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    s = scale.to(device=x.device, dtype=torch.float32)
    return torch.clamp(torch.round(x.to(torch.float32) / s), lo, hi
                       ).to(torch.int32)
