"""Approximate layer operations (port of ``repro.core.approx_ops``):
quantize -> ACU GEMM -> dequant, with the straight-through backward.

Model code calls :func:`approx_dense` / :func:`conv2d` at its matmul sites
and an :class:`ApproxConfig` (or None for exact float) decides whether and
how approximation happens. Conv2D lowers to GEMM by im2col (paper §3.3.1)
or runs the fused conv kernel, as :func:`~repro_torch.core.acu.conv_plan`
resolves.

The forward body is the reference's STE forward, rounding for rounding:
weights are quantized outside the kernel, per output channel; the
activation amax is ``max(amax, 1e-6)`` fed to ``symmetric_qparams``; the
dequant is one multiply by ``xs * ws``; the bias is a second, separately
rounded add.

The backward is the reference's STE (``torch.autograd.Function``s in
place of its ``custom_vjp``s), on the fake-quantized residuals ``xf`` and
``wf`` the forward saves. By default it is exact float32 (TF32 off), in
plain PyTorch as the reference leaves it to XLA. With
``ApproxConfig(approx_bwd=True)`` (the ApproxTrain regime) both gradient
GEMMs go through the ACU: the incoming gradient and the residuals are
quantized per-tensor symmetric with scales from ``inline_symmetric_scale``
on the full tensors, and the GEMMs run the routes of
:func:`~repro_torch.core.acu.matmul_bwd_plan`, or for a fused conv the
banded route (the weight gradient on ``fused_lut_conv_bwd_w``, the input
gradient on ``fused_lut_bwd`` with an integer col2im). Only the gradients
autograd asks for are computed.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from .acu import (Acu, ConvSpec, conv_plan, matmul_bwd_plan, matmul_plan,
                  resolve_conv_padding)
from .quantization import (QParams, acu_operand, fake_quantize,
                           inline_symmetric_scale, quantize,
                           symmetric_qparams)


@dataclasses.dataclass(frozen=True)
class ApproxConfig:
    """Per-model approximation configuration."""

    acu: Acu
    a_bits: int = 8
    w_bits: int = 8
    fake_quant_only: bool = False   # QAT fake-quant path (no integer GEMM)
    fused: Optional[bool] = None    # None = inherit acu.fused
    approx_bwd: bool = False        # STE backward GEMMs through the ACU
                                    # too (ApproxTrain regime); False keeps
                                    # the exact-f32 STE backward

    def __post_init__(self):
        if max(self.a_bits, self.w_bits) > self.acu.bits:
            raise ValueError(
                f"quantization bits ({self.a_bits}/{self.w_bits}) exceed the "
                f"ACU's operand width ({self.acu.bits}-bit "
                f"{self.acu.multiplier.name}); codes would overflow")


@contextlib.contextmanager
def exact_f32():
    """Full-float32 matmuls and convolutions: TF32 off for both cuBLAS and
    cuDNN (cuDNN allows it by default), restored on exit."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def _sym_scale(t: torch.Tensor, bits: int) -> torch.Tensor:
    """The approximate backward's per-tensor scale, on the full tensor."""
    return inline_symmetric_scale(t.abs().amax(), bits)


# a backward: (g, xf, wf, need_gx, need_gw) -> (gx or None, gw or None)
BwdFn = Callable[..., tuple[Optional[torch.Tensor], Optional[torch.Tensor]]]


class _Ste(torch.autograd.Function):
    """Approximate forward, straight-through backward: ``forward(x, w, xs,
    xz, ws, wz)`` runs ``fwd`` and saves the fake-quantized residuals the
    requested gradients need (``wf`` for ``gx``, ``xf`` for ``gw``);
    ``bwd`` computes those gradients from the float32 incoming gradient.
    The scale and zero-point inputs get no gradient."""

    @staticmethod
    def forward(ctx, x, w, xs, xz, ws, wz, fwd, bwd: BwdFn, a_bits: int,
                w_bits: int, w_axis: int):
        need_gx, need_gw = ctx.needs_input_grad[:2]
        xf = wf = None
        if need_gw:
            xf = fake_quantize(x, QParams(scale=xs, zero_point=xz,
                                          bits=a_bits))
        if need_gx:
            wf = fake_quantize(w, QParams(scale=ws, zero_point=wz,
                                          bits=w_bits, axis=w_axis))
        ctx.save_for_backward(xf, wf)
        ctx.bwd = bwd
        return fwd(x, w, xs, xz, ws, wz)

    @staticmethod
    def backward(ctx, g):
        xf, wf = ctx.saved_tensors
        need_gx, need_gw = ctx.needs_input_grad[:2]
        gx, gw = ctx.bwd(g.to(torch.float32), xf, wf, need_gx, need_gw)
        return (gx, gw) + (None,) * 9


def _ste(fwd, bwd: BwdFn, x, w, xqp: QParams, wqp: QParams,
         cfg: "ApproxConfig", w_axis: int) -> torch.Tensor:
    """``fwd(x, w, xs, xz, ws, wz)`` with the STE backward when a gradient
    is wanted; the bare forward otherwise (serving saves no residuals)."""
    args = (x, w, xqp.scale, xqp.zero_point, wqp.scale, wqp.zero_point)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Ste.apply(*args, fwd, bwd, cfg.a_bits, cfg.w_bits, w_axis)
    return fwd(*args)


def _exact_matmul_bwd(g, xf, wf, need_gx, need_gw):
    """The reference's exact STE backward: ``gx = g @ wf.T``, ``gw = xf.T
    @ g``, float32."""
    with exact_f32():
        return (g @ wf.t() if need_gx else None,
                xf.t() @ g if need_gw else None)


def _approx_matmul_bwd(cfg: "ApproxConfig", fused: bool) -> BwdFn:
    """ApproxTrain backward of the dense STE: scales on the full tensors,
    both gradient GEMMs through :func:`matmul_bwd_plan`."""
    gx_bwd, gw_bwd = matmul_bwd_plan(cfg.acu, a_bits=cfg.a_bits, fused=fused)

    def bwd(g, xf, wf, need_gx, need_gw):
        sg = _sym_scale(g, cfg.a_bits)
        gx = gw = None
        if need_gx:
            gx = gx_bwd(g, wf.t(), sg, _sym_scale(wf, cfg.a_bits))
        if need_gw:
            gw = gw_bwd(xf.t(), g, _sym_scale(xf, cfg.a_bits), sg)
        return gx, gw

    return bwd


def _affine_matmul_dequant(acc: torch.Tensor, xqp: QParams,
                           wqp: QParams) -> torch.Tensor:
    """Dequantize an integer GEMM accumulator with ONE multiply by the
    combined scale ``s1 * s2`` (per-tensor x per-output-channel)."""
    s2 = wqp.scale
    if wqp.axis is not None:
        s2 = s2.reshape(1, -1)
    s = xqp.scale.to(torch.float32) * s2.to(torch.float32)
    return acc.to(torch.float32) * s


def approx_matmul(x: torch.Tensor, w: torch.Tensor, cfg: ApproxConfig,
                  xqp: QParams, wqp: QParams) -> torch.Tensor:
    """2-D approximate GEMM with the STE backward. ``x``: (M, K) float,
    ``w``: (K, N) float; ``wqp.axis`` must be 1 (per-output-channel) or
    None."""
    if cfg.fake_quant_only:
        return fake_quantize(x, xqp) @ fake_quantize(w, wqp)
    fused = cfg.acu.fused if cfg.fused is None else cfg.fused
    plan = matmul_plan(cfg.acu, a_bits=cfg.a_bits, fused=fused)

    def fwd(x, w, xs, xz, ws, wz):
        xqp = QParams(scale=xs, zero_point=xz, bits=cfg.a_bits)
        wqp = QParams(scale=ws, zero_point=wz, bits=cfg.w_bits, axis=1)
        wq = acu_operand(quantize(w, wqp), wqp)
        if plan.fused:
            return plan(x, wq, xs, xz, ws)
        xq = acu_operand(quantize(x, xqp), xqp)
        return _affine_matmul_dequant(plan(xq, wq), xqp, wqp)

    bwd = (_approx_matmul_bwd(cfg, fused) if cfg.approx_bwd
           else _exact_matmul_bwd)
    return _ste(fwd, bwd, x, w, xqp, wqp, cfg, w_axis=1)


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


def _col2im(cols: torch.Tensor, x_shape, kh: int, kw: int,
            stride: Sequence[int], padding, dilation: Sequence[int]
            ) -> torch.Tensor:
    """Adjoint of :func:`_im2col`: scatter-add (N, Ho*Wo, C*kh*kw) patch
    gradients into the padded image (``F.fold``), then crop the pads."""
    (ph0, ph1), (pw0, pw1) = padding
    n, c, h, w = x_shape
    img = F.fold(cols.transpose(1, 2), (h + ph0 + ph1, w + pw0 + pw1),
                 (kh, kw), dilation=tuple(dilation), stride=tuple(stride))
    return img[:, :, ph0:ph0 + h, pw0:pw0 + w]


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
    with exact_f32():
        y = F.conv2d(F.pad(x, (pw0, pw1, ph0, ph1)), w, None,
                     stride=tuple(stride), dilation=tuple(dilation),
                     groups=groups)
    return y if b is None else y + b.reshape(1, -1, 1, 1)


def _exact_conv_bwd(spec: ConvSpec) -> BwdFn:
    """The reference's exact conv STE backward, in its im2col form:
    ``gw = cols(xf).T @ g`` and ``gx = col2im(g @ wf)``, float32."""
    cout, _, kh, kw = spec.w_shape
    geom = (kh, kw, spec.stride, spec.padding, spec.dilation)

    def bwd(g, xf, wf, need_gx, need_gw):
        g2 = g.reshape(-1, cout)                             # (N*P, Cout)
        gx = gw = None
        with exact_f32():
            if need_gw:
                cols, _ = _im2col(xf, *geom)
                gw = (cols.reshape(-1, cols.shape[-1]).t() @ g2).t()
                gw = gw.reshape(spec.w_shape)
            if need_gx:
                gcols = g2 @ wf.reshape(cout, -1)            # (N*P, C*kh*kw)
                gx = _col2im(gcols.reshape(spec.x_shape[0], -1,
                                           gcols.shape[-1]),
                             spec.x_shape, *geom)
        return gx, gw

    return bwd


def _banded_conv_bwd(acu: Acu, spec: ConvSpec, a_bits: int) -> BwdFn:
    """The ApproxTrain conv backward of the fused route (the reference's
    ``bwd_route="banded"``). Weight gradient: ``fused_lut_conv_bwd_w``'s
    int32 (kh*kw, Cin, Cout) accumulator, ONE dequant ``acc * (sx * sg)``,
    transposed to (Cout, Cin, kh, kw). Input gradient: ``fused_lut_bwd``
    of ``g`` (N*Ho*Wo, Cout) against ``wf`` (Cout, Cin*kh*kw) with
    ``emit_acc``, scattered tap by tap into an int32 padded canvas, cropped,
    and dequantized ONCE, ``canvas * (sg * sw)``. The scatter adds int32
    strided slices: integer adds are exact and associative, so it is the
    reference's canvas bit for bit. The reference loops over output-row
    bands to fit VMEM; here one band covers all rows (the band count is
    invisible in integer sums)."""
    from repro_torch.kernels.fused_lut_conv.ops import fused_lut_conv_bwd_w
    from repro_torch.kernels.fused_lut_dense.ops import fused_lut_bwd
    n, cin, h, w_in = spec.x_shape
    cout, _, kh, kw = spec.w_shape
    ho, wo = spec.out_spatial
    sh, sw_ = spec.stride
    dh, dw = spec.dilation
    (ph0, ph1), (pw0, pw1) = spec.padding

    def bwd(g, xf, wf, need_gx, need_gw):
        lut = acu.device_lut(g.device)
        sg = _sym_scale(g, a_bits)
        gx = gw = None
        if need_gw:
            sx = _sym_scale(xf, a_bits)
            acc = fused_lut_conv_bwd_w(
                xf, g, lut, acu.offset, sx, sg, ksize=(kh, kw),
                stride=spec.stride, padding=spec.padding,
                dilation=spec.dilation, bits=a_bits)
            gw = acc.to(torch.float32) * (sx * sg)
            gw = gw.permute(2, 1, 0).reshape(spec.w_shape)
        if need_gx:
            sw = _sym_scale(wf, a_bits)
            acc = fused_lut_bwd(g.reshape(-1, cout), wf.reshape(cout, -1),
                                lut, acu.offset, sg, sw, bits=a_bits,
                                emit_acc=True)       # (N*Ho*Wo, Cin*kh*kw)
            acc = acc.reshape(n, ho, wo, cin, kh, kw)
            canvas = torch.zeros((n, cin, h + ph0 + ph1, w_in + pw0 + pw1),
                                 dtype=torch.int32, device=g.device)
            for u in range(kh):
                for v in range(kw):
                    canvas[:, :, u * dh:u * dh + (ho - 1) * sh + 1:sh,
                           v * dw:v * dw + (wo - 1) * sw_ + 1:sw_] += \
                        acc[:, :, :, :, u, v].permute(0, 3, 1, 2)
            canvas = canvas[:, :, ph0:ph0 + h, pw0:pw0 + w_in]
            gx = canvas.to(torch.float32) * (sg * sw)
        return gx, gw

    return bwd


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
        def fwd(x, w, xs, xz, ws, wz):
            wqp_c = QParams(scale=ws, zero_point=wz, bits=cfg.w_bits, axis=0)
            wq = acu_operand(quantize(w, wqp_c), wqp_c)
            return plan(x, wq, xs, xz, ws)

        bwd = (_banded_conv_bwd(cfg.acu, spec, cfg.a_bits)
               if cfg.approx_bwd else _exact_conv_bwd(spec))
        y = _ste(fwd, bwd, x, w, xqp, wqp, cfg, w_axis=0)  # (N, Ho, Wo, Cout)
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
