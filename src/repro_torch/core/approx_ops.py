"""Approximate layer operations (port of ``repro.core.approx_ops``):
quantize -> ACU GEMM -> dequant, with the straight-through backward.

Model code calls :func:`approx_dense` / :func:`conv2d` at its matmul sites
and an :class:`ApproxConfig` (or None for exact float) decides whether and
how approximation happens. Conv2D lowers to GEMM by im2col (paper §3.3.1)
or runs one of the two fused conv kernels (whole-image or banded), as
:func:`~repro_torch.core.acu.conv_plan` resolves; grouped and depthwise
convs lower to GEMMs as in the reference.

The forward body is the reference's STE forward, rounding for rounding:
weights are quantized outside the kernel, per output channel; the
activation amax is ``max(amax, 1e-6)`` fed to ``symmetric_qparams``; the
dequant is one multiply by ``xs * ws``; the bias is a second, separately
rounded add. Every ACU mode runs through it: a fused LUT plan in one
kernel, any other plan as quantize -> the mode's GEMM (int32, or the
LOWRANK float32 accumulator) -> that one dequant.

The backward is the reference's STE (``torch.autograd.Function``s in
place of its ``custom_vjp``s), on the fake-quantized residuals ``xf`` and
``wf`` the forward saves. By default it is exact float32 (TF32 off), in
plain PyTorch as the reference leaves it to XLA. With
``ApproxConfig(approx_bwd=True)`` (the ApproxTrain regime) both gradient
GEMMs go through the ACU: the incoming gradient and the residuals are
quantized per-tensor symmetric with scales from ``inline_symmetric_scale``
on the full tensors, and the GEMMs run the routes of
:func:`~repro_torch.core.acu.matmul_bwd_plan` (a non-LUT ACU: quantize
outside, the mode's GEMM, one dequant), or for a fused conv the
banded route (the weight gradient on ``fused_lut_conv_bwd_w``, the input
gradient on ``fused_lut_bwd`` with an integer col2im). Only the gradients
autograd asks for are computed. Under a mesh of ranks every plan runs
sharded (``parallel/acu_shard.py``) and so do both backwards, bitwise the
local gradients.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from .acu import (Acu, AttnSpec, ConvSpec, GroupedSpec, attn_plan,
                  conv_plan, grouped_plan, matmul_bwd_plan, matmul_plan,
                  resolve_conv_padding)
from .quantization import (QParams, acu_operand, device_scalar,
                           fake_quantize, inline_symmetric_scale, quantize,
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
        # the residuals keep their operand's dtype, as the reference's do
        if need_gw:
            xf = fake_quantize(x, QParams(scale=xs, zero_point=xz,
                                          bits=a_bits)).to(x.dtype)
        if need_gx:
            wf = fake_quantize(w, QParams(scale=ws, zero_point=wz,
                                          bits=w_bits, axis=w_axis)
                               ).to(w.dtype)
        ctx.save_for_backward(xf, wf)
        ctx.bwd = bwd
        return fwd(x, w, xs, xz, ws, wz)

    @staticmethod
    def backward(ctx, g):
        xf, wf = (None if t is None else t.to(torch.float32)
                  for t in ctx.saved_tensors)
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


def _exact_gemms(plan):
    """The exact STE backward's two GEMMs, ``gx_gemm(g, wf) = g @ wf.T`` and
    ``gw_gemm(xf, g) = xf.T @ g``: local, or under a mesh of ranks with
    the plan's partition (``acu_shard.bwd_gemms``: ``gx`` row-blocked like
    the activations, ``gw`` column-blocked like the weights, each local
    GEMM over the whole contraction)."""
    from repro_torch.launch.mesh import RankMesh
    if plan.partition is not None and isinstance(plan.ctx.mesh, RankMesh):
        from repro_torch.parallel.acu_shard import bwd_gemms
        return bwd_gemms(plan.ctx, plan.partition)
    return (lambda g, wf: g @ wf.t()), (lambda xf, g: xf.t() @ g)


def _exact_matmul_bwd(plan) -> BwdFn:
    """The reference's exact STE backward: ``gx = g @ wf.T``, ``gw = xf.T
    @ g``, float32."""
    gx_gemm, gw_gemm = _exact_gemms(plan)

    def bwd(g, xf, wf, need_gx, need_gw):
        with exact_f32():
            return (gx_gemm(g, wf) if need_gx else None,
                    gw_gemm(xf, g) if need_gw else None)
    return bwd


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
           else _exact_matmul_bwd(plan))
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
# Grouped ragged MoE GEMM: one kernel launch for all E expert GEMMs of a
# projection (kernel 10), routed by core/acu.grouped_plan
# ---------------------------------------------------------------------------

def _grouped_fwd(cfg: ApproxConfig, plan, counts: torch.Tensor) -> Callable:
    """The grouped forward ``fwd(xe, w, xs, xz, ws3, wz)`` (``ws3``: the
    (E, 1, N) weight scales): the kernel on the ``fused_grouped`` route;
    on ``vmap`` the per-expert composition of :func:`approx_matmul`'s
    forward, each expert's rows of every dispatch block in one GEMM, the
    dead rows masked to 0.0 (masking, not slicing: under a biased table a
    dead row's codes still sum to ``K * LUT[0, w] != 0``)."""
    from repro_torch.kernels.fused_lut_grouped.ref import live_rows
    spec = plan.spec
    E, C, nb = spec.n_experts, spec.cap, spec.n_blocks
    if plan.route != "fused_grouped":
        mplan = matmul_plan(cfg.acu, a_bits=cfg.a_bits)

    def fwd(xe, w, xs, xz, ws3, wz):
        wqp = QParams(scale=ws3, zero_point=wz, bits=cfg.w_bits)
        wq = acu_operand(quantize(w, wqp), wqp)             # (E, K, N)
        ws = ws3.reshape(E, -1)
        if plan.route == "fused_grouped":
            return plan(xe, wq, xs, xz, ws, counts)
        xqp = QParams(scale=xs, zero_point=xz, bits=cfg.a_bits)
        x4 = xe.reshape(nb, E, C, xe.shape[-1])
        if not mplan.fused:
            x4 = acu_operand(quantize(x4, xqp), xqp)
        ys = []
        for e in range(E):
            xg = x4[:, e].reshape(nb * C, -1)
            wqp_e = QParams(scale=ws[e], zero_point=wz, bits=cfg.w_bits,
                            axis=1)
            y = (mplan(xg, wq[e], xs, xz, ws[e]) if mplan.fused else
                 _affine_matmul_dequant(mplan(xg, wq[e]), xqp, wqp_e))
            ys.append(y.reshape(nb, C, -1))
        y = torch.stack(ys, 1).reshape(nb * E, C, -1)
        return torch.where(live_rows(counts, C)[..., None], y, 0.0)

    return fwd


def _grouped_bwd(spec, counts: torch.Tensor) -> BwdFn:
    """The reference's grouped STE backward: exact float32 on the
    fake-quantized residuals, the incoming gradient masked to the live
    rows (dead slots emit zero forward, so nothing flows back through
    them)."""
    from repro_torch.kernels.fused_lut_grouped.ref import live_rows
    E, C, nb = spec.n_experts, spec.cap, spec.n_blocks

    def bwd(g, xf, wf, need_gx, need_gw):
        g = torch.where(live_rows(counts, C)[..., None], g, 0.0)
        g4 = g.reshape(nb, E, C, g.shape[-1])
        gx = gw = None
        with exact_f32():
            if need_gx:
                gx = torch.einsum("becn,ekn->beck", g4, wf).reshape(
                    nb * E, C, -1)
            if need_gw:
                gw = torch.einsum("beck,becn->ekn",
                                  xf.reshape(nb, E, C, -1), g4)
        return gx, gw

    return bwd


def approx_grouped_dense(xe: torch.Tensor, w: torch.Tensor,
                         cfg: ApproxConfig, counts: torch.Tensor,
                         route: Optional[str] = None) -> torch.Tensor:
    """Ragged grouped MoE GEMM through the ACU: every expert GEMM of one
    projection in one dispatch.

    ``xe``: (G, C, K) dispatched capacity buffers, ``G = nb * E`` groups
    (dispatch blocks x experts, block-major); group ``g`` multiplies expert
    ``g % E``. ``w``: (E, K, N) per-expert weights; ``counts``: (G,) int32
    live rows per group, on ``xe``'s device. Output rows ``>= counts[g]``
    are exactly 0.0. One per-tensor activation scale covers the whole
    dispatched tensor (``max(amax, 1e-6)`` in ``xe``'s dtype, then
    ``inline_symmetric_scale``), which is what makes the kernel and the
    per-expert composition bitwise equal; weight scales are per expert and
    output channel, in the same multiply form. ``route`` pins the plan's
    route (``"fused_grouped"`` / ``"vmap"``). The backward is the exact
    float32 STE. No ``fake_quant_only`` route, as in the reference: QAT
    keeps the per-expert :func:`approx_dense` path."""
    G, C, K = xe.shape
    E, _, N = w.shape
    if G % E != 0:
        raise ValueError(f"groups {G} not a multiple of experts {E}")
    if cfg.fake_quant_only:
        raise ValueError("approx_grouped_dense has no fake-quant route; "
                         "keep the per-expert approx_dense path for QAT")
    zero = device_scalar(0.0, xe.device)
    xqp = QParams(scale=inline_symmetric_scale(
        torch.clamp_min(xe.abs().amax(), 1e-6), cfg.a_bits),
        zero_point=zero, bits=cfg.a_bits)
    ws3 = inline_symmetric_scale(torch.clamp_min(w.abs().amax(dim=1), 1e-9),
                                 cfg.w_bits)[:, None, :]       # (E, 1, N)
    spec = GroupedSpec(n_experts=E, cap=C, d_in=K, d_out=N, n_blocks=G // E)
    plan = grouped_plan(cfg.acu, spec, a_bits=cfg.a_bits, route=route)
    counts = counts.to(torch.int32)
    y = _ste(_grouped_fwd(cfg, plan, counts), _grouped_bwd(spec, counts),
             xe, w, xqp, QParams(scale=ws3, zero_point=zero,
                                 bits=cfg.w_bits), cfg, w_axis=None)
    return y.to(xe.dtype)


# ---------------------------------------------------------------------------
# Attention through the ACU: the approximate flash attention kernels over a
# contiguous or a paged KV cache, routed by core/acu.attn_plan
# ---------------------------------------------------------------------------

def _attn_scale(t: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-tensor attention scale on the full tensor: ``max(amax, 1e-6)``
    (in the tensor's dtype, as the reference) through
    ``inline_symmetric_scale``."""
    return inline_symmetric_scale(torch.clamp_min(t.abs().amax(), 1e-6),
                                  bits)


def approx_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cfg: ApproxConfig, *, causal: bool = True,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     rowinfo: Optional[torch.Tensor] = None
                     ) -> Optional[torch.Tensor]:
    """Attention through the ACU (kernel 8), or ``None`` when the plan
    audits to the exact route (the caller keeps its float attention).

    ``q``: (B, Hq, Sq, D); ``k``/``v``: (B, Hkv, Sk, D) (views of the
    cache are fine); ``rowinfo``: optional (B, 3) int32. The per-tensor
    scales are calibrated here on the full tensors. Forward only."""
    spec = AttnSpec(hq=q.shape[1], hkv=k.shape[1], causal=causal,
                    window=window, softcap=softcap)
    plan = attn_plan(cfg.acu, spec, a_bits=cfg.a_bits)
    if plan.route != "fused_attn":
        return None
    scales = [_attn_scale(t, cfg.a_bits) for t in (q, k, v)]
    return plan(q, k, v, *scales, rowinfo)


def approx_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, cfg: ApproxConfig, *,
                           page_table: torch.Tensor, rowinfo: torch.Tensor,
                           causal: bool = True, window: Optional[int] = None,
                           softcap: Optional[float] = None
                           ) -> Optional[torch.Tensor]:
    """Attention through the ACU over block-paged KV (kernel 9), or
    ``None`` on the exact route (the caller gathers the pool blocks back to
    a contiguous layout first).

    ``q``: (B, Hq, Sq, D); ``k_pool``/``v_pool``: (Hkv, P, bk, D);
    ``page_table``: (B, n_logical) int32 and ``rowinfo``: (B, 3) int32,
    both required. The K/V amaxes are taken over the blocks the page
    tables reference (``pool[:, page_table]``), not the whole pool, so a
    prefix-cache hit sees the scales a cold run computes."""
    spec = AttnSpec(hq=q.shape[1], hkv=k_pool.shape[0], causal=causal,
                    window=window, softcap=softcap, bk=k_pool.shape[2],
                    kv_layout="paged")
    plan = attn_plan(cfg.acu, spec, a_bits=cfg.a_bits)
    if plan.route != "fused_attn_paged":
        return None
    pt = torch.as_tensor(page_table, dtype=torch.int64, device=q.device)
    scales = [_attn_scale(q, cfg.a_bits)] + [
        _attn_scale(pool[:, pt], cfg.a_bits) for pool in (k_pool, v_pool)]
    return plan(q, k_pool, v_pool, *scales, rowinfo, page_table)


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


def _exact_conv_bwd(plan) -> BwdFn:
    """The reference's exact conv STE backward, in its im2col form:
    ``gw = cols(xf).T @ g`` and ``gx = col2im(g @ wf)``, float32; under a
    mesh its two GEMMs take the conv partition (:func:`_exact_gemms`)."""
    spec = plan.spec
    cout, _, kh, kw = spec.w_shape
    geom = (kh, kw, spec.stride, spec.padding, spec.dilation)
    gx_gemm, gw_gemm = _exact_gemms(plan)

    def bwd(g, xf, wf, need_gx, need_gw):
        g2 = g.reshape(-1, cout)                             # (N*P, Cout)
        gx = gw = None
        with exact_f32():
            if need_gw:
                cols, _ = _im2col(xf, *geom)
                gw = gw_gemm(cols.reshape(-1, cols.shape[-1]), g2).t()
                gw = gw.reshape(spec.w_shape)
            if need_gx:
                # (N*P, C*kh*kw)
                gcols = gx_gemm(g2, wf.reshape(cout, -1).t())
                gx = _col2im(gcols.reshape(spec.x_shape[0], -1,
                                           gcols.shape[-1]),
                             spec.x_shape, *geom)
        return gx, gw

    return bwd


def _banded_conv_bwd(acu: Acu, plan, a_bits: int) -> BwdFn:
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
    invisible in integer sums). Under a mesh of ranks the weight gradient
    sums band-slab partials over the conv partition's rows axes
    (``acu_shard.wrap_conv_bwd_w``) and the input gradient's GEMM sums
    over its cols axes (``wrap_conv_gx_gemm``), bitwise the local ones."""
    from repro_torch.kernels.fused_lut_conv.ops import fused_lut_conv_bwd_w
    from repro_torch.kernels.fused_lut_dense.ops import fused_lut_bwd
    from repro_torch.launch.mesh import RankMesh
    spec = plan.spec
    n, cin, h, w_in = spec.x_shape
    cout, _, kh, kw = spec.w_shape
    ho, wo = spec.out_spatial
    sh, sw_ = spec.stride
    dh, dw = spec.dilation
    (ph0, ph1), (pw0, pw1) = spec.padding

    def gw_acc(x, g, rm, sx, sg, padding):
        return fused_lut_conv_bwd_w(
            x, g, acu.device_lut(g.device), acu.offset, sx, sg,
            ksize=(kh, kw), stride=spec.stride, padding=padding,
            dilation=spec.dilation, bits=a_bits, rmask=rm)

    def gx_acc(a, b, sa, sb):
        return fused_lut_bwd(a, b, acu.device_lut(a.device), acu.offset, sa,
                             sb, bits=a_bits, emit_acc=True)

    part = plan.partition
    if part is not None and isinstance(plan.ctx.mesh, RankMesh):
        from repro_torch.parallel import acu_shard
        gw_call = acu_shard.wrap_conv_bwd_w(gw_acc, plan.ctx, part, spec)
        gx_call = acu_shard.wrap_conv_gx_gemm(gx_acc, plan.ctx, part,
                                              acu.m00())
    else:
        gw_call = lambda xf, g, sx, sg: gw_acc(  # noqa: E731
            xf, g, None, sx, sg, spec.padding)
        gx_call = gx_acc

    def bwd(g, xf, wf, need_gx, need_gw):
        sg = _sym_scale(g, a_bits)
        gx = gw = None
        if need_gw:
            sx = _sym_scale(xf, a_bits)
            acc = gw_call(xf, g, sx, sg)
            gw = acc.to(torch.float32) * (sx * sg)
            gw = gw.permute(2, 1, 0).reshape(spec.w_shape)
        if need_gx:
            sw = _sym_scale(wf, a_bits)
            # (N*Ho*Wo, Cin*kh*kw)
            acc = gx_call(g.reshape(-1, cout), wf.reshape(cout, -1), sg, sw)
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


def _fused_conv(x: torch.Tensor, w: torch.Tensor, cfg: ApproxConfig,
                plan, xqp: QParams, wqp: QParams) -> torch.Tensor:
    """A ``fused_conv`` or ``tiled`` plan's forward under the STE: the
    weight quantized per output channel, the plan's kernel, and the
    backward the plan implies (exact, or with ``approx_bwd`` the banded
    kernels 7 and 4). Returns (N, Cout, Ho, Wo) in ``x``'s dtype."""
    def fwd(x, w, xs, xz, ws, wz):
        wqp_c = QParams(scale=ws, zero_point=wz, bits=cfg.w_bits, axis=0)
        wq = acu_operand(quantize(w, wqp_c), wqp_c)
        return plan(x, wq, xs, xz, ws)

    bwd = (_banded_conv_bwd(cfg.acu, plan, cfg.a_bits)
           if cfg.approx_bwd else _exact_conv_bwd(plan))
    y = _ste(fwd, bwd, x, w, xqp, wqp, cfg, w_axis=0)   # (N, Ho, Wo, Cout)
    return y.permute(0, 3, 1, 2).to(x.dtype)


def _depthwise_weight(w: torch.Tensor, cin: int) -> torch.Tensor:
    """The (Cin*kh*kw, Cout) block-diagonal GEMM weight of a depthwise
    conv: output channel ``c * mult + o`` reads only the ``kh*kw`` patch
    features of input channel ``c``; every other entry is a structural
    0.0."""
    cout = w.shape[0]
    kk = w.shape[2] * w.shape[3]
    mult = cout // cin
    ch = torch.arange(cin, device=w.device).repeat_interleave(kk)
    tap = torch.arange(kk, device=w.device).repeat(cin)
    rows = torch.arange(cin * kk, device=w.device).repeat(mult)
    cols = torch.cat([ch * mult + o for o in range(mult)])
    vals = w.reshape(cout, kk)[cols, tap.repeat(mult)]
    return torch.zeros((cin * kk, cout), dtype=w.dtype,
                       device=w.device).index_put((rows, cols), vals)


def conv2d(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, *,
           stride: Sequence[int] = (1, 1), padding="SAME",
           dilation: Sequence[int] = (1, 1), groups: int = 1,
           cfg: Optional[ApproxConfig] = None, route: Optional[str] = None,
           xqp: Optional[QParams] = None,
           wqp: Optional[QParams] = None) -> torch.Tensor:
    """2-D convolution. ``x``: (N, Cin, H, W); ``w``: (Cout, Cin/groups,
    kh, kw). With an ``ApproxConfig`` the route comes from
    :func:`~repro_torch.core.acu.conv_plan`: the whole-image or the banded
    fused CUDA conv kernel (``route="tiled"`` pins the banded one), eager
    im2col + the dense approximate GEMM (``route="im2col"`` pins it), or
    for ``groups > 1`` one dense GEMM against the block-diagonal weight
    (depthwise) or one per group. ``xqp``/``wqp`` override the ``groups=1``
    quantizers (``wqp`` per output channel, axis 0)."""
    n, cin = x.shape[:2]
    cout, cin_g, kh, kw = w.shape
    if cin != cin_g * groups:
        raise ValueError(f"x has {cin} channels, w expects {cin_g}x{groups}")
    spec = _conv_spec(x.shape, w.shape, stride, padding, dilation, groups)
    if cfg is None:
        return _exact_conv(x, w, b, spec.stride, spec.padding, spec.dilation,
                           groups)
    if cfg.fake_quant_only:
        if route in ("fused_conv", "tiled"):
            raise ValueError(f"route={route!r} contradicts "
                             f"cfg.fake_quant_only")
        route = "im2col"
    fused = cfg.acu.fused if cfg.fused is None else cfg.fused
    plan = conv_plan(cfg.acu, spec, a_bits=cfg.a_bits, fused=fused,
                     route=route)
    geom = (kh, kw, spec.stride, spec.padding, spec.dilation)

    if plan.route in ("fused_conv", "tiled"):
        xqp, wqp = _conv_qparams(x, w, cfg, xqp, wqp)
        y = _fused_conv(x, w, cfg, plan, xqp, wqp)
    elif plan.route == "im2col":
        xqp, wqp = _conv_qparams(x, w, cfg, xqp, wqp)
        cols, (ho, wo) = _im2col(x, *geom)
        wmat = w.reshape(cout, -1).t()                 # (C*kh*kw, Cout)
        m = cols.reshape(-1, cols.shape[-1])           # (N*Ho*Wo, C*kh*kw)
        wqp_mat = QParams(scale=wqp.scale, zero_point=wqp.zero_point,
                          bits=wqp.bits, axis=1)
        y = approx_dense(m, wmat, None, cfg, xqp=xqp, wqp=wqp_mat)
        y = y.reshape(n, ho, wo, cout).permute(0, 3, 1, 2)
    elif plan.route == "im2col_depthwise":
        # one GEMM against the block-diagonal weight, one activation scale
        # over every channel; under a table with M[0, x] != 0 the
        # structural zeros add their entries, as in the reference
        cols, (ho, wo) = _im2col(x, *geom)
        m = cols.reshape(-1, cols.shape[-1])           # (N*P, C*kh*kw)
        y = approx_dense(m, _depthwise_weight(w, cin), None, cfg)
        y = y.reshape(n, ho, wo, cout).permute(0, 3, 1, 2)
    else:
        # one GEMM per group, each with its own activation scale (the
        # reference vmaps approx_dense over the group axis); a group's
        # patch features are a contiguous channel-major slice
        cpg_in, cpg_out = cin // groups, cout // groups
        cols, (ho, wo) = _im2col(x, *geom)
        kk = kh * kw
        m = cols.reshape(n, ho * wo, groups, cpg_in * kk)
        m = m.permute(2, 0, 1, 3).reshape(groups, n * ho * wo, cpg_in * kk)
        wg = w.reshape(groups, cpg_out, cpg_in * kk).transpose(1, 2)
        yg = torch.stack([approx_dense(m[g], wg[g], None, cfg)
                          for g in range(groups)])
        y = yg.reshape(groups, n, ho * wo, cpg_out).permute(1, 2, 0, 3)
        y = y.reshape(n, ho, wo, cout).permute(0, 3, 1, 2)
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    return y


def separable_conv2d(x: torch.Tensor, w_dw: torch.Tensor,
                     w_pw: torch.Tensor, b: Optional[torch.Tensor] = None, *,
                     stride: Sequence[int] = (1, 1), padding="SAME",
                     cfg: Optional[ApproxConfig] = None) -> torch.Tensor:
    """Depthwise (groups = Cin) then pointwise (1x1) conv, paper eq. (3)."""
    cin = x.shape[1]
    y = conv2d(x, w_dw, None, stride=stride, padding=padding, groups=cin,
               cfg=cfg)
    return conv2d(y, w_pw, b, stride=(1, 1), padding="VALID", cfg=cfg)
