"""Public wrapper of the error-corrected GEMM kernel
(``csrc/err_matmul.cu``), the LOWRANK mode's GEMM.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py``. There is no fallback between the two. Nothing is
padded, so the reference's K-pad correction ``k_pad * f[off] . g[off]`` has
no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from .ref import err_matmul_ref

MAX_CODES = 256


def err_matmul(a: torch.Tensor, w: torch.Tensor, f: torch.Tensor,
               g: torch.Tensor, offset: int) -> torch.Tensor:
    """``out[m, n] = float(sum_k a*w) + sum_k sum_r f[a+off, r] g[w+off, r]``.

    ``a``: (M, K) int32 shifted codes; ``w``: (K, N) int32 shifted codes;
    ``f``, ``g``: (n_codes, r) float32 factor tables. Returns (M, N)
    float32. Refuses tables of more than 256 codes (operands wider than 8
    bits), on either device: the reference kernel casts its operands to
    int8 for the exact term (``src/repro/kernels/err_matmul/kernel.py:38``)
    and so wraps wider codes instead of multiplying them.
    """
    n_codes, r = f.shape
    if tuple(g.shape) != (n_codes, r):
        raise ValueError(f"f {tuple(f.shape)} and g {tuple(g.shape)} differ")
    if n_codes > MAX_CODES:
        raise ValueError(
            f"err_matmul takes codes of at most 8 bits (tables of at most "
            f"{MAX_CODES} rows), got a table of {n_codes}: the reference "
            f"kernel casts the codes to int8 for its exact term "
            f"(src/repro/kernels/err_matmul/kernel.py:38) and wraps wider "
            f"ones; run a wider LOWRANK ACU without use_kernels")
    M, K = a.shape
    K2, N = w.shape
    if K2 != K:
        raise ValueError(f"inner dims differ: a {tuple(a.shape)}, "
                         f"w {tuple(w.shape)}")
    if a.device.type == "cpu":
        return err_matmul_ref(a, w, f.to(torch.float32),
                              g.to(torch.float32), offset)
    a = a.contiguous()
    w = w.contiguous()
    f = f.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    for t, name, dt in ((a, "a", torch.int32), (w, "w", torch.int32),
                        (f, "f", torch.float32), (g, "g", torch.float32)):
        runtime.check_cuda_operand(t, name, dt, a.device)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = runtime.kernel_library("err_matmul")
    blocks, stream = runtime.launch_config(a)
    lib.check(lib.launch(a.data_ptr(), w.data_ptr(), f.data_ptr(),
                         g.data_ptr(), out.data_ptr(), M, K, N, n_codes, r,
                         offset, 4 * blocks, stream))
    err_matmul.launches += 1
    return out


err_matmul.launches = 0
