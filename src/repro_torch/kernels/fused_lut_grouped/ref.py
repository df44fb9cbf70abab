"""Plain PyTorch version of the ragged grouped fused LUT-GEMM (oracle of
``csrc/fused_lut_grouped.cu``), operation for operation the reference's
kernel: the same quantizer expression, the same int32 accumulate, the same
single combined-scale dequant ``acc * (xs * ws[e])``. Rows at or past a
group's count are never gathered and come back exactly 0.0 (0 with
``emit_acc``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_lut_dense.ref import quantize_shifted
from repro_torch.kernels.lut_matmul.ref import lut_gather_sum


def live_rows(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """(G, C) bool from (G,) counts: row ``r`` of group ``g`` holds a
    routed token (``r < clip(counts[g], 0, C)``)."""
    c = counts.to(torch.int64).reshape(-1)
    return (torch.arange(cap, device=c.device)[None, :]
            < torch.clamp(c, 0, cap)[:, None])


def fused_lut_grouped_ref(x: torch.Tensor, wq: torch.Tensor,
                          lut_flat: torch.Tensor, offset: int, n_codes: int,
                          x_scale, x_zp, w_scale, counts: torch.Tensor, *,
                          bits: int = 8,
                          emit_acc: bool = False) -> torch.Tensor:
    """``x`` (G, C, K) float; ``wq`` (E, K, N) int32 shifted codes, group
    ``g`` multiplying expert ``g % E``; ``w_scale`` (E,), (E, N) or (E, 1,
    N); ``counts`` (G,) live rows per group. Live rows: ``xs * ws[e, n] *
    sum_k LUT[q(x[g, r, k]) - xz + off, wq[e, k, n] + off]`` (float32), or
    the int32 sum with ``emit_acc``; the rest 0. Each expert's live rows of
    every group are gathered into one GEMM."""
    G, C, K = x.shape
    E, _, N = wq.shape
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    dev = x.device
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=dev)
    xz = torch.as_tensor(x_zp, dtype=torch.float32, device=dev)
    ws = torch.as_tensor(w_scale, dtype=torch.float32,
                         device=dev).reshape(E, -1).expand(E, N)
    live = live_rows(torch.as_tensor(counts, device=dev), C)
    expert = torch.arange(G, device=dev) % E
    out = torch.zeros((G, C, N), device=dev,
                      dtype=torch.int32 if emit_acc else torch.float32)
    lut_flat = lut_flat.reshape(-1)
    for e in range(E):
        rows = live & (expert == e)[:, None]
        xr = x[rows]                                    # (L, K)
        if xr.shape[0] == 0:
            continue
        a = quantize_shifted(xr, xs, xz, lo, hi, offset)
        acc = lut_gather_sum(a, wq[e].to(torch.int64) + offset, lut_flat,
                             n_codes)
        out[rows] = acc if emit_acc else \
            acc.to(torch.float32) * (xs * ws[e]).reshape(1, -1)
    return out
