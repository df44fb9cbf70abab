"""Public wrappers of the fused conv kernels, the forward
(``csrc/fused_lut_conv.cu``) and the approximate weight gradient
(``csrc/fused_lut_conv_bwd_w.cu``), and the conv geometry helpers.

The kernel reads the unpadded NCHW image and treats every tap that falls
outside it as the zero-point code, which is what the reference's quantized
0.0 padding gives, so spatial padding needs no correction and no padded
copy of the image. Channels are not padded, so there is no channel-pad
correction either. The reference's VMEM working-set model has no
counterpart: the kernel tiles output pixels across the whole batch, so no
image has to fit on chip.

The weight-gradient wrapper drops the reference's ``bh``, ``bn``, ``mc``
and ``rmask`` arguments: they size VMEM row bands and mask band-padding
rows and mesh slabs. The CUDA kernel streams output pixels straight from
the unpadded tensors, split across blocks, so there are no bands, no
padded rows to mask and no mesh.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.fused_lut_dense.ops import scale_operands
from .ref import fused_lut_conv_bwd_w_ref, fused_lut_conv_ref


def conv_out_size(size: int, k: int, stride: int, dilation: int,
                  pad: tuple[int, int]) -> int:
    """Output extent of one spatial dim under explicit padding."""
    eff_k = (k - 1) * dilation + 1
    return (size + pad[0] + pad[1] - eff_k) // stride + 1


def conv_padded_geometry(h: int, w: int, kh: int, kw: int, sh: int, sw: int,
                         dh: int, dw: int,
                         padding: tuple[tuple[int, int], tuple[int, int]],
                         bh: int) -> tuple[int, int, int, int, int]:
    """(ho, wo, ho_pad, hp, wp): the output extents, the output rows padded
    to a multiple of ``bh``, and the padded input extents every tap of
    those rows reads (the reference's geometry, kept for plan reports)."""
    (ph0, ph1), (pw0, pw1) = padding
    ho = conv_out_size(h, kh, sh, dh, (ph0, ph1))
    wo = conv_out_size(w, kw, sw, dw, (pw0, pw1))
    ho_pad = -(-ho // bh) * bh
    need_h = (ho_pad - 1) * sh + (kh - 1) * dh + 1
    need_w = (wo - 1) * sw + (kw - 1) * dw + 1
    return ho, wo, ho_pad, max(h + ph0 + ph1, need_h), \
        max(w + pw0 + pw1, need_w)


def fused_lut_conv(x: torch.Tensor, wq: torch.Tensor, lut: torch.Tensor,
                   offset: int, x_scale, x_zp, w_scale, *, stride=(1, 1),
                   padding=((0, 0), (0, 0)), dilation=(1, 1), bits: int = 8,
                   emit_acc: bool = False) -> torch.Tensor:
    """Fused approximate conv2d forward.

    ``x``: (N, C, H, W) float32; ``wq``: (Cout, C, kh, kw) int32 shifted
    weight codes; ``lut``: the product table (int32, or the int16 table from
    :func:`runtime.lut_to_int16`); ``x_scale``/``x_zp``: per-tensor
    activation qparams; ``w_scale``: scalar or (Cout,) scales; ``padding``:
    explicit ((ph_lo, ph_hi), (pw_lo, pw_hi)). Returns (N, Ho, Wo, Cout)
    float32, or the raw int32 accumulator with ``emit_acc=True``.
    """
    n_codes = int(round(lut.numel() ** 0.5))
    n, c, h, w_in = x.shape
    cout, cin, kh, kw = wq.shape
    if cin != c:
        raise ValueError(f"weight expects {cin} input channels, x has {c}")
    sh, sw = stride
    dh, dw = dilation
    (ph0, ph1), (pw0, pw1) = padding
    ho = conv_out_size(h, kh, sh, dh, (ph0, ph1))
    wo = conv_out_size(w_in, kw, sw, dw, (pw0, pw1))
    if x.device.type == "cpu":
        return fused_lut_conv_ref(x, wq, lut.reshape(-1), offset, n_codes,
                                  x_scale, x_zp, w_scale, stride=stride,
                                  padding=padding, dilation=dilation,
                                  bits=bits, emit_acc=emit_acc)
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    table = runtime.lut_to_int16(lut)
    x = x.contiguous()
    # (K, Cout) with k = (c, u, v), the im2col reference's channel-major order
    wmat = wq.reshape(cout, -1).t().contiguous()
    xs, xz, ws = scale_operands(x_scale, x_zp, w_scale, cout, x.device)
    for t, name, dt in ((x, "x", torch.float32), (wmat, "wq", torch.int32),
                        (table, "lut", torch.int16)):
        runtime.check_cuda_operand(t, name, dt, x.device)
    out = torch.empty((n, max(ho, 0), max(wo, 0), cout), device=x.device,
                      dtype=torch.int32 if emit_acc else torch.float32)
    if out.numel() == 0:
        return out
    if n * ho * wo >= 2 ** 31:
        raise ValueError("conv output has too many pixels for 32-bit indices")
    lib = runtime.kernel_library("fused_lut_conv")
    blocks, stream = runtime.launch_config(x)
    lib.check(lib.launch(x.data_ptr(), wmat.data_ptr(), table.data_ptr(),
                         xs.data_ptr(), xz.data_ptr(), ws.data_ptr(),
                         out.data_ptr(), int(emit_acc), n, c, h, w_in, cout,
                         kh, kw, sh, sw, ph0, pw0, dh, dw, ho, wo, n_codes,
                         offset, lo, hi, blocks, stream))
    fused_lut_conv.launches += 1
    return out


fused_lut_conv.launches = 0


def fused_lut_conv_bwd_w(x: torch.Tensor, g: torch.Tensor, lut: torch.Tensor,
                         offset: int, x_scale, g_scale, *,
                         ksize: tuple[int, int], stride=(1, 1),
                         padding=((0, 0), (0, 0)), dilation=(1, 1),
                         bits: int = 8) -> torch.Tensor:
    """Approximate conv weight gradient (the ApproxTrain regime).

    ``x``: (N, C, H, W) float residual (the saved fake-quantized input);
    ``g``: (N, Ho, Wo, Cout) float incoming gradient, the fused forward's
    output layout; ``x_scale`` / ``g_scale``: per-tensor symmetric scales
    the caller computed on the full tensors. Both are quantized in-kernel,
    ``clip(round(v / s))``; an out-of-image tap is code 0 and contributes
    ``LUT[off, qg + off]``, as the reference's quantized 0.0 pad does.
    Returns the raw int32 (kh*kw, C, Cout) tap-major accumulator; the
    caller dequants once, ``acc * (sx * sg)``.
    """
    n_codes = int(round(lut.numel() ** 0.5))
    n, c, h, w_in = x.shape
    cout = g.shape[3]
    kh, kw = ksize
    sh, sw = stride
    dh, dw = dilation
    (ph0, ph1), (pw0, pw1) = padding
    ho = conv_out_size(h, kh, sh, dh, (ph0, ph1))
    wo = conv_out_size(w_in, kw, sw, dw, (pw0, pw1))
    if tuple(g.shape) != (n, ho, wo, cout):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected "
                         f"{(n, ho, wo, cout)} for this geometry")
    if x.device.type == "cpu":
        return fused_lut_conv_bwd_w_ref(
            x, g, lut.reshape(-1), offset, n_codes, x_scale, g_scale,
            ksize=ksize, stride=stride, padding=padding, dilation=dilation,
            bits=bits)
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    table = runtime.lut_to_int16(lut)
    x = x.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    f = dict(dtype=torch.float32, device=x.device)
    sx = torch.as_tensor(x_scale, **f).reshape(1).contiguous()
    sg = torch.as_tensor(g_scale, **f).reshape(1).contiguous()
    for t, name, dt in ((x, "x", torch.float32), (g, "g", torch.float32),
                        (table, "lut", torch.int16)):
        runtime.check_cuda_operand(t, name, dt, x.device)
    # blocks add partial sums over slices of the pixels into it
    out = torch.zeros((kh * kw, c, cout), device=x.device, dtype=torch.int32)
    if g.numel() == 0 or out.numel() == 0:
        return out
    lib = runtime.kernel_library("fused_lut_conv_bwd_w")
    blocks, stream = runtime.launch_config(x)
    lib.check(lib.launch(x.data_ptr(), g.data_ptr(), table.data_ptr(),
                         sx.data_ptr(), sg.data_ptr(), out.data_ptr(), n, c,
                         h, w_in, cout, kh, kw, sh, sw, ph0, pw0, dh, dw, ho,
                         wo, n_codes, offset, lo, hi, blocks, stream))
    fused_lut_conv_bwd_w.launches += 1
    return out


fused_lut_conv_bwd_w.launches = 0
