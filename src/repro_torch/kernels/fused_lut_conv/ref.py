"""Plain PyTorch version of the fused conv kernel: materialise the im2col
patch tensor, then run the fused dense plain version — the reference's own
oracle, on the same patch extraction as the eager ``im2col`` route."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_lut_dense.ref import fused_lut_dense_ref


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
