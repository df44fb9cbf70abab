"""Plain PyTorch versions of the fused quantize -> LUT GEMM -> dequant
kernels (forward and backward), operation for operation the reference's
oracles: the same quantizer expressions, the same int32 accumulate, the
same single combined-scale dequant ``acc * (xs * ws)`` / ``acc * (sa *
sb)``."""
from __future__ import annotations

import torch

from repro_torch.kernels.lut_matmul.ref import lut_gather_sum


def quantize_shifted(x: torch.Tensor, xs: torch.Tensor, xz: torch.Tensor,
                     lo: int, hi: int, offset: int) -> torch.Tensor:
    """Table row index of each activation: ``clip(round(x / xs + xz)) -
    int(xz) + off`` (int64)."""
    q = torch.clamp(torch.round(x.to(torch.float32) / xs + xz), lo, hi)
    return q.to(torch.int64) - xz.to(torch.int64) + offset


def fused_lut_dense_ref(x: torch.Tensor, wq: torch.Tensor,
                        lut_flat: torch.Tensor, offset: int, n_codes: int,
                        x_scale, x_zp, w_scale, *, bits: int = 8,
                        emit_acc: bool = False) -> torch.Tensor:
    """out = xs * ws[n] * sum_k LUT[q(x[m,k]) - xz + off, wq[k,n] + off]."""
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    dev = x.device
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=dev)
    xz = torch.as_tensor(x_zp, dtype=torch.float32, device=dev)
    a = quantize_shifted(x, xs, xz, lo, hi, offset)
    acc = lut_gather_sum(a, wq.to(torch.int64) + offset, lut_flat, n_codes)
    if emit_acc:
        return acc
    ws = torch.as_tensor(w_scale, dtype=torch.float32, device=dev)
    return acc.to(torch.float32) * (xs * ws.reshape(1, -1))


def fused_lut_bwd_ref(a: torch.Tensor, b: torch.Tensor,
                      lut_flat: torch.Tensor, offset: int, n_codes: int,
                      a_scale, b_scale, *, bits: int = 8,
                      emit_acc: bool = False) -> torch.Tensor:
    """Backward flavour: both float operands quantized per-tensor
    symmetric, ``clip(round(v / s))`` (zero point 0), then the same LUT
    gather and int32 sum, and one combined-scale dequant ``acc * (sa *
    sb)`` (or the raw accumulator with ``emit_acc``)."""
    from repro_torch.core.quantization import quantize_symmetric
    dev = a.device
    sa = torch.as_tensor(a_scale, dtype=torch.float32, device=dev)
    sb = torch.as_tensor(b_scale, dtype=torch.float32, device=dev)
    qa = quantize_symmetric(a, sa, bits).to(torch.int64) + offset
    qb = quantize_symmetric(b, sb, bits).to(torch.int64) + offset
    acc = lut_gather_sum(qa, qb, lut_flat, n_codes)
    if emit_acc:
        return acc
    return acc.to(torch.float32) * (sa * sb)
