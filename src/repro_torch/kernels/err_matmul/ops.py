"""Public wrapper of the error-corrected GEMM kernel
(``csrc/err_matmul.cu``), the LOWRANK mode's GEMM.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py``. There is no fallback between the two. Nothing is
padded, so the reference's K-pad correction ``k_pad * f[off] . g[off]`` has
no counterpart. The kernel's tile is picked here (:func:`err_tile`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.fused_lut_dense.ops import SMEM_PER_BLOCK
from .ref import err_matmul_ref

MAX_CODES = 256
ERR_BK = 32            # K chunk of one pipeline step
ERR_ROW_BYTES = 48     # one staged code row: 32 codes and a pad


def err_smem(n_codes: int, r: int, bm: int, bn: int) -> int:
    """Dynamic shared memory of one kernel-13 block, as the source's
    ``Layout`` sizes it: the two tables (at r = 8 two copies of each row's
    8 ranks split into TF32 hi and lo, 32 floats), two raw int32 buffers
    each of A's and B's codes, two buffers each of their int8 codes and
    table indices."""
    tab = -(-n_codes * (32 if r == 8 else r) * 4 // 16) * 16
    return (2 * tab + 2 * bm * ERR_BK * 4 + 2 * ERR_BK * bn * 4
            + 4 * (bm + bn) * ERR_ROW_BYTES)


def err_tile(M: int, N: int, n_sm: int) -> tuple[int, int]:
    """(bn, wm): the column tile follows N (16 up to 16 columns, 32 up to
    32, else 64, with several tiles past 64), a warp's 16 x 8 fragments
    cover ``wm`` rows (16 or 32) by up to 32 columns, and 8 warps make the
    tile's rows ``bm`` (8 x wm, or 4 x wm at 64 columns). 32 rows a warp
    reuse each gathered B fragment twice as often; 16 are taken where they
    cost fewer rows of work per SM, counting a 16-row warp's lower reuse as
    a third more work."""
    bn = 16 if N <= 16 else 32 if N <= 32 else 64
    warps_m = 4 if bn == 64 else 8
    tiles_n = -(-N // bn)

    def cost(wm):
        bm = warps_m * wm
        rounds = -(-(-(-M // bm) * tiles_n) // n_sm)
        return rounds * bm * (1.0 if wm == 32 else 4 / 3)

    return bn, min((32, 16), key=cost)


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
    if a.device.type == "meta":
        # the exact term and the rank-r correction: r + 1 FMAs per product
        runtime.count_work("err_matmul", flops=2 * M * K * N * (r + 1),
                           bytes_=runtime.nbytes(a, w, f, g) + M * N * 4)
        return runtime.meta_empty(M, N, dtype=torch.float32)
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
    blocks, stream = runtime.launch_config(a)
    bn, wm = err_tile(M, N, blocks)
    bm = (4 if bn == 64 else 8) * wm
    if err_smem(n_codes, r, bm, bn) > SMEM_PER_BLOCK:
        raise ValueError(f"err_matmul's tables at rank {r} do not fit a "
                         f"block's shared memory")
    lib = runtime.kernel_library("err_matmul")
    lib.check(lib.launch(a.data_ptr(), w.data_ptr(), f.data_ptr(),
                         g.data_ptr(), out.data_ptr(), M, K, N, n_codes, r,
                         offset, bn, wm, blocks, stream))
    err_matmul.launches += 1
    return out


err_matmul.launches = 0
