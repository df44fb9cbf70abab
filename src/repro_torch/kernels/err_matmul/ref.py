"""Plain PyTorch version of the error-corrected GEMM (oracle of the
kernel): the exact integer product plus the rank-r correction."""
from __future__ import annotations

import torch

# float32 elements of one gathered (rows, K*r) f block: 64 MiB whatever
# the shape
_CHUNK_ELEMS = 1 << 24


def exact_int_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_k a[m, k] * w[k, n]`` in int32, wrapping as an int32 sum does.
    Computed as a float64 product, exact for every sum below 2^53 (any GEMM
    of codes up to 12 bits with K below 2^29), on either device."""
    prod = torch.matmul(a.to(torch.float64), w.to(torch.float64))
    return prod.to(torch.int64).to(torch.int32)


def error_correction(a: torch.Tensor, w: torch.Tensor, f: torch.Tensor,
                     g: torch.Tensor, offset: int) -> torch.Tensor:
    """``sum_k sum_r f[a[m,k] + off, r] * g[w[k,n] + off, r]`` in the
    tables' dtype (float32 for the GEMM): the gathered ``(M, K*r) @ (K*r,
    N)`` product, row-chunked. Run it with TF32 off on a card
    (``core.approx_ops.exact_f32``)."""
    m, k = a.shape
    n = w.shape[1]
    r = f.shape[1]
    gw = g[w.long() + offset].permute(0, 2, 1).reshape(k * r, n)
    out = torch.empty((m, n), dtype=f.dtype, device=a.device)
    rows = max(1, _CHUNK_ELEMS // max(k * r, 1))
    for m0 in range(0, m, rows):
        fa = f[a[m0:m0 + rows].long() + offset].reshape(-1, k * r)
        out[m0:m0 + rows] = fa @ gw
    return out


def err_matmul_ref(a: torch.Tensor, w: torch.Tensor, f: torch.Tensor,
                   g: torch.Tensor, offset: int) -> torch.Tensor:
    """``float(a @ w) + sum_k sum_r f[a + off, r] g[w + off, r]``, float32
    (M, N), from int32 shifted codes ``a`` (M, K) and ``w`` (K, N) and
    (n_codes, r) float32 tables."""
    exact = exact_int_product(a, w).to(torch.float32)
    return exact + error_correction(a, w, f, g, offset)


def tf32_split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``t = hi + lo`` as the kernel splits each gathered value: ``hi`` is
    ``t`` rounded to its top 11 significant bits by Veltkamp's split
    (``s = t * 8193; hi = s - (s - t)``, each operation rounded in
    float32), a TF32 value; ``lo = t - hi`` (exact) with its low 13 bits
    dropped, as the tensor core reads a TF32 operand. float32 out."""
    t = t.to(torch.float32)
    s = t * 8193.0
    hi = s - (s - t)
    bits = (t - hi).contiguous().view(torch.int32)
    return hi, (bits & ~0x1FFF).view(torch.float32)


def err_matmul_tf32_ref(a: torch.Tensor, w: torch.Tensor, f: torch.Tensor,
                        g: torch.Tensor, offset: int, *,
                        passes: int = 3) -> torch.Tensor:
    """What the kernel's tensor-core correction computes, in float32:
    every gathered table value split into TF32 ``hi + lo``
    (:func:`tf32_split`; splitting the tables splits every gathered
    value), then ``(lo.hi + hi.lo) + hi.hi`` (``passes=3``, the kernel's
    3xTF32), or ``hi.hi`` alone (``passes=1``, one plain TF32 pass). A
    product of two TF32 values is exact in float32, so each term is
    :func:`error_correction` on the split tables. The exact term is the
    int32 sum; the two meet once. Run it with TF32 off on a card."""
    fh, fl = tf32_split(f)
    gh, gl = tf32_split(g)
    terms = [(fl, gh), (fh, gl), (fh, gh)] if passes == 3 else [(fh, gh)]
    corr = None
    for ft, gt in terms:
        c = error_correction(a, w, ft, gt, offset)
        corr = c if corr is None else corr + c
    return exact_int_product(a, w).to(torch.float32) + corr


_U = 2.0 ** -24     # unit roundoff of float32


def summation_bound(a: torch.Tensor, w: torch.Tensor, f: torch.Tensor,
                    g: torch.Tensor, offset: int) -> torch.Tensor:
    """How far two float32 evaluations of the same error-corrected GEMM
    may lie apart, element by element, whatever order each sums in:
    ``(K*(r+1) + 2) * 2^-24 * S[m, n]``, where ``S`` is the two sums taken
    over absolute values (``sum_k |a w| + sum_k sum_r |f| |g|``): each of
    the ``K*(r+1)`` products and sums, the conversion and the final add
    round once. Float64, (M, N)."""
    k, r = a.shape[1], f.shape[1]
    s = torch.matmul(a.abs().to(torch.float64), w.abs().to(torch.float64))
    s = s + error_correction(a, w, f.abs().to(torch.float64),
                             g.abs().to(torch.float64), offset)
    return (k * (r + 1) + 2) * _U * s


def lut_agreement_bound(y: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                        f: torch.Tensor, g: torch.Tensor, offset: int,
                        max_abs_err: float) -> torch.Tensor:
    """How far ``y``, an evaluation with an exact integer term (the
    kernel's int32 sum, or this plain version's float64 one), may lie from
    the LUT GEMM's integer: the integer's conversion and the final add
    (``2^-24 * (|a w| + |y|)``), the factorisation's error over K products
    (``K * max_abs_err``) and the correction's float32 sum (``(K*r + 1) *
    2^-24 * sum |f| |g|``). Where it is below 0.5, ``round(y)`` is the LUT
    GEMM's result. Float64, (M, N)."""
    k, r = a.shape[1], f.shape[1]
    s_exact = torch.matmul(a.to(torch.float64), w.to(torch.float64)).abs()
    s_corr = error_correction(a, w, f.abs().to(torch.float64),
                              g.abs().to(torch.float64), offset)
    return (_U * (s_exact + y.abs().to(torch.float64)) + k * max_abs_err
            + (k * r + 1) * _U * s_corr)
