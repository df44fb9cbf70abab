"""Plain PyTorch versions of the fused conv kernels.

The whole-image forward materialises the im2col patch tensor, then runs the
fused dense plain version: the reference's own oracle, on the same patch
extraction as the eager ``im2col`` route. The banded forward walks
output-row bands as the reference's ``_tiled_kernel`` does, so that its
band and halo arithmetic is tested by something other than im2col. The
weight gradient is the reference's oracle for its banded kernel:
quantize, take the im2col of the **codes** (pads become code 0), then run
the unfused LUT GEMM."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.fused_lut_dense.ref import (fused_lut_dense_ref,
                                                     quantize_shifted)
from repro_torch.kernels.lut_matmul.ref import lut_gather_sum


def fused_lut_conv_ref(x: torch.Tensor, wq: torch.Tensor,
                       lut_flat: torch.Tensor, offset: int, n_codes: int,
                       x_scale, x_zp, w_scale, *, stride=(1, 1),
                       padding=((0, 0), (0, 0)), dilation=(1, 1),
                       bits: int = 8, emit_acc: bool = False
                       ) -> torch.Tensor:
    """x: (N, C, H, W) float; wq: (Cout, C, kh, kw) shifted weight codes.
    Returns (N, Ho, Wo, Cout) float32 (int32 with ``emit_acc``)."""
    from repro_torch.core.approx_ops import _im2col
    cout, _, kh, kw = wq.shape
    cols, (ho, wo) = _im2col(x, kh, kw, stride, padding, dilation)
    m = cols.reshape(-1, cols.shape[-1])                 # (N*P, C*kh*kw)
    wmat = wq.reshape(cout, -1).t()                      # (C*kh*kw, Cout)
    out = fused_lut_dense_ref(m, wmat, lut_flat, offset, n_codes,
                              x_scale, x_zp, w_scale, bits=bits,
                              emit_acc=emit_acc)
    return out.reshape(x.shape[0], ho, wo, cout)


def fused_lut_conv_tiled_ref(x: torch.Tensor, wq: torch.Tensor,
                             lut_flat: torch.Tensor, offset: int,
                             n_codes: int, x_scale, x_zp, w_scale, *,
                             stride=(1, 1), padding=((0, 0), (0, 0)),
                             dilation=(1, 1), bits: int = 8, bh: int = 1,
                             emit_acc: bool = False) -> torch.Tensor:
    """x: (N, C, H, W) float; wq: (Cout, C, kh, kw) shifted weight codes.
    Returns (N, Ho, Wo, Cout) float32 (int32 with ``emit_acc``).

    For each band of ``bh`` output rows the ``(bh-1)*sh + (kh-1)*dh + 1``
    halo'd input rows (0.0 outside the image: the zero-point code) are
    quantized once; each tap (u, v) then gather-sums its strided window
    of the band's codes against its (C, Cout) weight codes. Rows of the
    last band past Ho are dropped."""
    n, c, h, w_in = x.shape
    cout, _, kh, kw = wq.shape
    sh, sw = stride
    dh, dw = dilation
    (ph0, ph1), (pw0, pw1) = padding
    ho = (h + ph0 + ph1 - (kh - 1) * dh - 1) // sh + 1
    wo = (w_in + pw0 + pw1 - (kw - 1) * dw - 1) // sw + 1
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    dev = x.device
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=dev)
    xz = torch.as_tensor(x_zp, dtype=torch.float32, device=dev)
    wtap = wq.permute(2, 3, 1, 0).reshape(kh * kw, c, cout).to(torch.int64) \
        + offset                                        # (taps, C, Cout)
    rows_in = (bh - 1) * sh + (kh - 1) * dh + 1
    acc = torch.zeros((n, max(ho, 0), max(wo, 0), cout), dtype=torch.int32,
                      device=dev)
    for b0 in range(0, ho, bh):
        r0 = b0 * sh - ph0                  # first input row of the band
        top, bottom = max(0, -r0), max(0, r0 + rows_in - h)
        rows = x[:, :, max(r0, 0):min(r0 + rows_in, h)]
        band = F.pad(rows, (pw0, pw1, top, bottom))     # 0.0 pads
        codes = quantize_shifted(band, xs, xz, lo, hi, offset)
        nb = min(bh, ho - b0)
        for t in range(kh * kw):
            u, v = divmod(t, kw)
            win = codes[:, :, u * dh:u * dh + (nb - 1) * sh + 1:sh,
                        v * dw:v * dw + (wo - 1) * sw + 1:sw]
            a = win.permute(0, 2, 3, 1).reshape(-1, c)  # (N*nb*wo, C)
            acc[:, b0:b0 + nb] += lut_gather_sum(
                a, wtap[t], lut_flat, n_codes).reshape(n, nb, wo, cout)
    if emit_acc:
        return acc
    ws = torch.as_tensor(w_scale, dtype=torch.float32, device=dev)
    return acc.to(torch.float32) * (xs * ws.reshape(-1))


def fused_lut_conv_bwd_w_ref(x: torch.Tensor, g: torch.Tensor,
                             lut_flat: torch.Tensor, offset: int,
                             n_codes: int, x_scale, g_scale, *,
                             ksize: tuple[int, int], stride=(1, 1),
                             padding=((0, 0), (0, 0)), dilation=(1, 1),
                             bits: int = 8) -> torch.Tensor:
    """x: (N, C, H, W) float residual; g: (N, Ho, Wo, Cout) float
    gradient. Returns the int32 (kh*kw, C, Cout) tap-major accumulator
    ``sum_pixels LUT[qx(tap) + off, qg + off]``."""
    from repro_torch.core.approx_ops import _im2col
    from repro_torch.core.quantization import quantize_symmetric
    kh, kw = ksize
    c, cout = x.shape[1], g.shape[3]
    qx = quantize_symmetric(x, torch.as_tensor(x_scale), bits)
    qg = quantize_symmetric(g, torch.as_tensor(g_scale), bits)
    # codes are small integers, exact in float32; the 0.0 pads are code 0
    cols, _ = _im2col(qx.to(torch.float32), kh, kw, stride, padding,
                      dilation)                         # (N, P, C*kh*kw)
    cols = cols.reshape(-1, cols.shape[-1]).t().to(torch.int64) + offset
    acc = lut_gather_sum(cols, qg.reshape(-1, cout).to(torch.int64) + offset,
                         lut_flat, n_codes)             # (C*kh*kw, Cout)
    return acc.reshape(c, kh * kw, cout).transpose(0, 1).contiguous()
