"""Plain PyTorch versions of the fused conv kernels.

The forward materialises the im2col patch tensor, then runs the fused dense
plain version: the reference's own oracle, on the same patch extraction as
the eager ``im2col`` route. The weight gradient is the reference's oracle
for its banded kernel: quantize, take the im2col of the **codes** (pads
become code 0), then run the unfused LUT GEMM."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_lut_dense.ref import fused_lut_dense_ref
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
