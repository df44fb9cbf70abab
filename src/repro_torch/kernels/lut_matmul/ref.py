"""Plain PyTorch version of the LUT-gather GEMM (oracle of the kernel)."""
from __future__ import annotations

import torch

# int64 gather indices per chunk: 4 Mi entries (32 MiB) whatever the shape,
# so the stem's im2col GEMM at batch 256 (M=262144, K=27, N=16) never builds
# a multi-GB index tensor
_CHUNK_ELEMS = 1 << 22


def lut_gather_sum(ai: torch.Tensor, wi: torch.Tensor, lut_flat: torch.Tensor,
                   n_codes: int, k_chunk: int = 256) -> torch.Tensor:
    """``sum_k lut[ai[m, k] * n_codes + wi[k, n]]`` on table indices
    (shifted codes + offset), chunked over rows and K. Returns int32."""
    m, k = ai.shape
    n = wi.shape[1]
    k_chunk = max(1, min(k_chunk, k))
    m_chunk = max(1, _CHUNK_ELEMS // (k_chunk * max(n, 1)))
    lut_flat = lut_flat.reshape(-1).to(torch.int32)
    out = torch.empty((m, n), dtype=torch.int32, device=ai.device)
    for m0 in range(0, m, m_chunk):
        rows = ai[m0:m0 + m_chunk].to(torch.int64) * n_codes
        acc = torch.zeros((rows.shape[0], n), dtype=torch.int32,
                          device=ai.device)
        for k0 in range(0, k, k_chunk):
            idx = rows[:, k0:k0 + k_chunk, None] \
                + wi[None, k0:k0 + k_chunk, :].to(torch.int64)
            acc += lut_flat[idx].sum(dim=1, dtype=torch.int32)
        out[m0:m0 + m_chunk] = acc
    return out


def lut_matmul_ref(a: torch.Tensor, w: torch.Tensor, lut_flat: torch.Tensor,
                   offset: int, n_codes: int,
                   k_chunk: int = 256) -> torch.Tensor:
    """out[m, n] = sum_k LUT[a[m,k]+off, w[k,n]+off] (int32)."""
    return lut_gather_sum(a.to(torch.int64) + offset,
                          w.to(torch.int64) + offset, lut_flat, n_codes,
                          k_chunk=k_chunk)
