"""Public wrappers of the fused dense kernels: the forward
(``csrc/fused_lut_dense.cu``) and the approximate STE gradient GEMM
(``csrc/fused_lut_bwd.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py``. Nothing is padded, so the kernels need no K-pad
correction.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from .ref import fused_lut_bwd_ref, fused_lut_dense_ref


def scale_operands(x_scale, x_zp, w_scale, n: int, device):
    """The scales as the kernels read them: shape-(1,) activation scale and
    zero-point, (N,) per-output-channel weight scale, float32, on
    ``device``."""
    f = dict(dtype=torch.float32, device=device)
    xs = torch.as_tensor(x_scale, **f).reshape(1).contiguous()
    xz = torch.as_tensor(x_zp, **f).reshape(1).contiguous()
    ws = torch.as_tensor(w_scale, **f).reshape(-1).expand(n).contiguous()
    return xs, xz, ws


def fused_lut_dense(x: torch.Tensor, wq: torch.Tensor, lut: torch.Tensor,
                    offset: int, x_scale, x_zp, w_scale, *, bits: int = 8,
                    emit_acc: bool = False) -> torch.Tensor:
    """Fused approximate dense forward.

    ``x``: (M, K) float32 activations; ``wq``: (K, N) int32 shifted weight
    codes; ``lut``: the product table (int32, or int16 from
    :func:`runtime.lut_to_int16`); ``x_scale``/``x_zp``: per-tensor
    activation qparams; ``w_scale``: scalar or (N,) weight scales; ``bits``:
    the activation code width (clip range). Returns (M, N) float32, or the
    raw int32 accumulator with ``emit_acc=True``.
    """
    n_codes = int(round(lut.numel() ** 0.5))
    M, K = x.shape
    K2, N = wq.shape
    if K2 != K:
        raise ValueError(f"inner dims differ: x {tuple(x.shape)}, "
                         f"wq {tuple(wq.shape)}")
    if x.device.type == "cpu":
        return fused_lut_dense_ref(x, wq, lut.reshape(-1), offset, n_codes,
                                   x_scale, x_zp, w_scale, bits=bits,
                                   emit_acc=emit_acc)
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    table = runtime.lut_to_int16(lut)
    x = x.contiguous()
    wq = wq.contiguous()
    xs, xz, ws = scale_operands(x_scale, x_zp, w_scale, N, x.device)
    for t, name, dt in ((x, "x", torch.float32), (wq, "wq", torch.int32),
                        (table, "lut", torch.int16)):
        runtime.check_cuda_operand(t, name, dt, x.device)
    out = torch.empty((M, N), device=x.device,
                      dtype=torch.int32 if emit_acc else torch.float32)
    if M == 0 or N == 0 or K == 0:
        return out.zero_()
    lib = runtime.kernel_library("fused_lut_dense")
    blocks, stream = runtime.launch_config(x)
    lib.check(lib.launch(x.data_ptr(), wq.data_ptr(), table.data_ptr(),
                         xs.data_ptr(), xz.data_ptr(), ws.data_ptr(),
                         out.data_ptr(), int(emit_acc), M, K, N, n_codes,
                         offset, lo, hi, blocks, stream))
    fused_lut_dense.launches += 1
    return out


fused_lut_dense.launches = 0


def fused_lut_bwd(a: torch.Tensor, b: torch.Tensor, lut: torch.Tensor,
                  offset: int, a_scale, b_scale, *, bits: int = 8,
                  emit_acc: bool = False) -> torch.Tensor:
    """Fused approximate backward GEMM: both float operands quantized
    in-kernel, per-tensor symmetric (zero point 0), LUT-gather GEMM, int32
    accumulate, one combined-scale dequant ``acc * (sa * sb)``.

    ``a``: (M, K) float; ``b``: (K, N) float (the incoming gradient and a
    saved fake-quantized residual, in either order); ``a_scale`` /
    ``b_scale``: per-tensor scales. A transposed operand (``wf.T``,
    ``xf.T``) is copied contiguous here: the kernel reads row-major
    operands only. Returns (M, N) float32, or the raw int32 accumulator
    with ``emit_acc=True`` (the conv input gradient's integer col2im).
    """
    n_codes = int(round(lut.numel() ** 0.5))
    M, K = a.shape
    K2, N = b.shape
    if K2 != K:
        raise ValueError(f"inner dims differ: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if a.device.type == "cpu":
        return fused_lut_bwd_ref(a, b, lut.reshape(-1), offset, n_codes,
                                 a_scale, b_scale, bits=bits,
                                 emit_acc=emit_acc)
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    table = runtime.lut_to_int16(lut)
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    f = dict(dtype=torch.float32, device=a.device)
    sa = torch.as_tensor(a_scale, **f).reshape(1).contiguous()
    sb = torch.as_tensor(b_scale, **f).reshape(1).contiguous()
    for t, name, dt in ((a, "a", torch.float32), (b, "b", torch.float32),
                        (table, "lut", torch.int16)):
        runtime.check_cuda_operand(t, name, dt, a.device)
    out = torch.empty((M, N), device=a.device,
                      dtype=torch.int32 if emit_acc else torch.float32)
    if M == 0 or N == 0 or K == 0:
        return out.zero_()
    lib = runtime.kernel_library("fused_lut_bwd")
    blocks, stream = runtime.launch_config(a)
    lib.check(lib.launch(a.data_ptr(), b.data_ptr(), table.data_ptr(),
                         sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
                         int(emit_acc), M, K, N, n_codes, offset, lo, hi,
                         blocks, stream))
    fused_lut_bwd.launches += 1
    return out


fused_lut_bwd.launches = 0
