"""Approximate layer operations, forward (port of
``repro.core.approx_ops``): quantize -> ACU GEMM -> dequant.

Model code calls :func:`approx_dense` / :func:`conv2d` at its matmul sites
and an :class:`ApproxConfig` (or None for exact float) decides whether and
how approximation happens. Conv2D lowers to GEMM by im2col (paper §3.3.1)
or runs the fused conv kernel, as :func:`~repro_torch.core.acu.conv_plan`
resolves.

The forward body is the reference's STE forward, rounding for rounding:
weights are quantized outside the kernel, per output channel; the
activation amax is ``max(amax, 1e-6)`` fed to ``symmetric_qparams``; the
dequant is one multiply by ``xs * ws``; the bias is a second, separately
rounded add. The straight-through backward belongs to the training slice:
serve under ``torch.inference_mode()``; a backward through an approximate
op raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .acu import (Acu, ConvSpec, conv_plan, matmul_plan, not_ported,
                  resolve_conv_padding)
from .quantization import (QParams, acu_operand, fake_quantize, quantize,
                           symmetric_qparams)


@dataclasses.dataclass(frozen=True)
class ApproxConfig:
    """Per-model approximation configuration."""

    acu: Acu
    a_bits: int = 8
    w_bits: int = 8
    fake_quant_only: bool = False   # QAT fake-quant path (no integer GEMM)
    fused: Optional[bool] = None    # None = inherit acu.fused
    approx_bwd: bool = False        # approximate STE backward (not ported)

    def __post_init__(self):
        if max(self.a_bits, self.w_bits) > self.acu.bits:
            raise ValueError(
                f"quantization bits ({self.a_bits}/{self.w_bits}) exceed the "
                f"ACU's operand width ({self.acu.bits}-bit "
                f"{self.acu.multiplier.name}); codes would overflow")
        if self.approx_bwd:
            raise not_ported("approx_bwd (the approximate STE backward)",
                             "queue 1, item 5")


class _ForwardOnly(torch.autograd.Function):
    """Runs an approximate forward; its backward (the STE) is not ported."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        return fn(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        raise not_ported("the STE backward of approximate ops",
                         "queue 1, items 3 and 5 (training slice)")


def _forward_only(fn, *inputs: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _ForwardOnly.apply(fn, *inputs)
    return fn(*inputs)


def _affine_matmul_dequant(acc: torch.Tensor, xqp: QParams,
                           wqp: QParams) -> torch.Tensor:
    """Dequantize an integer GEMM accumulator with ONE multiply by the
    combined scale ``s1 * s2`` (per-tensor x per-output-channel)."""
    s2 = wqp.scale
    if wqp.axis is not None:
        s2 = s2.reshape(1, -1)
    s = xqp.scale.to(torch.float32) * s2.to(torch.float32)
    return acc.to(torch.float32) * s


def _ste_matmul_forward(plan, x, w, xs, xz, ws, wz, a_bits: int,
                        w_bits: int) -> torch.Tensor:
    xqp = QParams(scale=xs, zero_point=xz, bits=a_bits)
    wqp = QParams(scale=ws, zero_point=wz, bits=w_bits, axis=1)
    wq = acu_operand(quantize(w, wqp), wqp)
    if plan.fused:
        return plan(x, wq, xs, xz, ws)
    xq = acu_operand(quantize(x, xqp), xqp)
    return _affine_matmul_dequant(plan(xq, wq), xqp, wqp)


def approx_matmul(x: torch.Tensor, w: torch.Tensor, cfg: ApproxConfig,
                  xqp: QParams, wqp: QParams) -> torch.Tensor:
    """2-D approximate GEMM. ``x``: (M, K) float, ``w``: (K, N) float;
    ``wqp.axis`` must be 1 (per-output-channel) or None."""
    if cfg.fake_quant_only:
        return _forward_only(
            lambda a, b: fake_quantize(a, xqp) @ fake_quantize(b, wqp), x, w)
    fused = cfg.acu.fused if cfg.fused is None else cfg.fused
    plan = matmul_plan(cfg.acu, a_bits=cfg.a_bits, fused=fused)
    return _forward_only(
        lambda a, b: _ste_matmul_forward(
            plan, a, b, xqp.scale, xqp.zero_point, wqp.scale,
            wqp.zero_point, cfg.a_bits, cfg.w_bits), x, w)


def approx_dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 cfg: Optional[ApproxConfig], xqp: Optional[QParams] = None,
                 wqp: Optional[QParams] = None) -> torch.Tensor:
    """Linear layer ``y = x @ w + b``, optionally through the ACU.
    ``x``: (..., K), ``w``: (K, N)."""
    if cfg is None:
        y = x @ w
    else:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if xqp is None:
            xqp = symmetric_qparams(
                torch.clamp_min(x2.abs().amax(), 1e-6), cfg.a_bits)
        if wqp is None:
            wqp = symmetric_qparams(
                torch.clamp_min(w.abs().amax(dim=0), 1e-9), cfg.w_bits,
                axis=1)
        y = approx_matmul(x2, w, cfg, xqp, wqp).reshape(*lead, w.shape[1])
        y = y.to(x.dtype)
    if b is not None:
        y = y + b     # a second, separately rounded op after the dequant
    return y


# ---------------------------------------------------------------------------
# Conv2D (paper §3.3.1)
# ---------------------------------------------------------------------------

def _im2col(x: torch.Tensor, kh: int, kw: int, stride: Sequence[int],
            padding, dilation: Sequence[int]):
    """Extract conv patches: (N, C, H, W) -> (N, Ho*Wo, C*kh*kw), features
    channel-major (c, u, v) like the reference's patch op. ``padding`` is
    explicit ((ph_lo, ph_hi), (pw_lo, pw_hi)); pads are 0.0."""
    (ph0, ph1), (pw0, pw1) = padding
    xp = F.pad(x, (pw0, pw1, ph0, ph1))
    from repro_torch.kernels.fused_lut_conv.ops import conv_out_size
    ho = conv_out_size(x.shape[2], kh, stride[0], dilation[0], (ph0, ph1))
    wo = conv_out_size(x.shape[3], kw, stride[1], dilation[1], (pw0, pw1))
    cols = F.unfold(xp, (kh, kw), dilation=tuple(dilation),
                    stride=tuple(stride))                # (N, C*kh*kw, L)
    return cols.transpose(1, 2), (ho, wo)


def _conv_qparams(x: torch.Tensor, w: torch.Tensor, cfg: ApproxConfig,
                  xqp: Optional[QParams], wqp: Optional[QParams]
                  ) -> tuple[QParams, QParams]:
    """Per-tensor activation scale calibrated on the conv *input* and
    per-output-channel weight scales, shared by the fused route and the
    im2col oracle."""
    if xqp is None:
        xqp = symmetric_qparams(torch.clamp_min(x.abs().amax(), 1e-6),
                                cfg.a_bits)
    if wqp is None:
        wqp = symmetric_qparams(
            torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-9), cfg.w_bits,
            axis=0)
    return xqp, wqp


def _conv_spec(x_shape, w_shape, stride, padding, dilation,
               groups) -> ConvSpec:
    stride, dilation = tuple(stride), tuple(dilation)
    pad = resolve_conv_padding(padding, tuple(x_shape), tuple(w_shape),
                               stride, dilation)
    return ConvSpec(x_shape=tuple(x_shape), w_shape=tuple(w_shape),
                    stride=stride, padding=pad, dilation=dilation,
                    groups=groups)


def conv_plan_report(x_shape: Sequence[int], w_shape: Sequence[int],
                     cfg: ApproxConfig, *, stride: Sequence[int] = (1, 1),
                     padding="SAME", dilation: Sequence[int] = (1, 1),
                     groups: int = 1) -> dict:
    """Resolve (without running) the conv route one layer would take."""
    spec = _conv_spec(x_shape, w_shape, stride, padding, dilation, groups)
    fused = cfg.acu.fused if cfg.fused is None else cfg.fused
    return conv_plan(cfg.acu, spec, a_bits=cfg.a_bits,
                     fused=fused).describe()


def _exact_conv(x, w, b, stride, pad, dilation, groups):
    (ph0, ph1), (pw0, pw1) = pad
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(F.pad(x, (pw0, pw1, ph0, ph1)), w, None,
                     stride=tuple(stride), dilation=tuple(dilation),
                     groups=groups)
    return y if b is None else y + b.reshape(1, -1, 1, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, *,
           stride: Sequence[int] = (1, 1), padding="SAME",
           dilation: Sequence[int] = (1, 1), groups: int = 1,
           cfg: Optional[ApproxConfig] = None, route: Optional[str] = None,
           xqp: Optional[QParams] = None,
           wqp: Optional[QParams] = None) -> torch.Tensor:
    """2-D convolution. ``x``: (N, Cin, H, W); ``w``: (Cout, Cin/groups,
    kh, kw). With an ``ApproxConfig`` the route comes from
    :func:`~repro_torch.core.acu.conv_plan`: the fused CUDA conv kernel, or
    eager im2col + the dense approximate GEMM (``route="im2col"`` pins it).
    ``xqp``/``wqp`` override the quantizers (``wqp`` per output channel,
    axis 0)."""
    n, cin = x.shape[:2]
    cout, cin_g, kh, kw = w.shape
    if cin != cin_g * groups:
        raise ValueError(f"x has {cin} channels, w expects {cin_g}x{groups}")
    spec = _conv_spec(x.shape, w.shape, stride, padding, dilation, groups)
    if cfg is None:
        return _exact_conv(x, w, b, spec.stride, spec.padding, spec.dilation,
                           groups)
    if cfg.fake_quant_only:
        if route == "fused_conv":
            raise ValueError("route='fused_conv' contradicts "
                             "cfg.fake_quant_only")
        route = "im2col"
    fused = cfg.acu.fused if cfg.fused is None else cfg.fused
    plan = conv_plan(cfg.acu, spec, a_bits=cfg.a_bits, fused=fused,
                     route=route)
    xqp, wqp = _conv_qparams(x, w, cfg, xqp, wqp)

    if plan.route == "fused_conv":
        def fwd(xt, wt):
            wqp_c = QParams(scale=wqp.scale, zero_point=wqp.zero_point,
                            bits=cfg.w_bits, axis=0)
            wq = acu_operand(quantize(wt, wqp_c), wqp_c)
            return plan(xt, wq, xqp.scale, xqp.zero_point, wqp.scale)

        y = _forward_only(fwd, x, w)               # (N, Ho, Wo, Cout)
        y = y.permute(0, 3, 1, 2).to(x.dtype)
    else:
        cols, (ho, wo) = _im2col(x, kh, kw, spec.stride, spec.padding,
                                 spec.dilation)
        wmat = w.reshape(cout, -1).t()                 # (C*kh*kw, Cout)
        m = cols.reshape(-1, cols.shape[-1])           # (N*Ho*Wo, C*kh*kw)
        wqp_mat = QParams(scale=wqp.scale, zero_point=wqp.zero_point,
                          bits=wqp.bits, axis=1)
        y = approx_dense(m, wmat, None, cfg, xqp=xqp, wqp=wqp_mat)
        y = y.reshape(n, ho, wo, cout).permute(0, 3, 1, 2)
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    return y
