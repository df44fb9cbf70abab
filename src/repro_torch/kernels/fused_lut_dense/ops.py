"""Public wrapper of the fused dense kernel (``csrc/fused_lut_dense.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py``. Nothing is padded, so the kernel needs no K-pad
correction.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from .ref import fused_lut_dense_ref


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
