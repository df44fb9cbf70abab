"""Public wrapper of the LUT-gather GEMM kernel (``csrc/lut_matmul.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py``. There is no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from .ref import lut_matmul_ref


def lut_matmul(a: torch.Tensor, w: torch.Tensor, lut: torch.Tensor,
               offset: int) -> torch.Tensor:
    """``out[m, n] = sum_k LUT[a[m, k] + off, w[k, n] + off]``.

    ``a``: (M, K) int32 shifted codes; ``w``: (K, N) int32 shifted codes;
    ``lut``: (n_codes, n_codes) or flat, int32 (or the int16 table from
    :func:`runtime.lut_to_int16`, which skips the range check). Returns
    (M, N) int32. Nothing is padded, so no pad correction is applied.
    """
    n_codes = int(round(lut.numel() ** 0.5))
    M, K = a.shape
    K2, N = w.shape
    if K2 != K:
        raise ValueError(f"inner dims differ: a {tuple(a.shape)}, "
                         f"w {tuple(w.shape)}")
    if a.device.type == "cpu":
        return lut_matmul_ref(a, w, lut.reshape(-1), offset, n_codes)
    table = runtime.lut_to_int16(lut)
    a = a.contiguous()
    w = w.contiguous()
    for t, name, dt in ((a, "a", torch.int32), (w, "w", torch.int32),
                        (table, "lut", torch.int16)):
        runtime.check_cuda_operand(t, name, dt, a.device)
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = runtime.kernel_library("lut_matmul")
    blocks, stream = runtime.launch_config(a)
    lib.check(lib.launch(a.data_ptr(), w.data_ptr(), table.data_ptr(),
                         out.data_ptr(), M, K, N, n_codes, offset, blocks,
                         stream))
    lut_matmul.launches += 1
    return out


lut_matmul.launches = 0
