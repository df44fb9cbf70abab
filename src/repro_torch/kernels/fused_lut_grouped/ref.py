"""Plain PyTorch version of the ragged grouped fused LUT-GEMM (oracle of
``csrc/fused_lut_grouped.cu``), operation for operation the reference's
kernel: the same quantizer expression, the same int32 accumulate, the same
single combined-scale dequant ``acc * (xs * ws[e])``. Rows at or past a
group's count are never gathered and come back exactly 0.0 (0 with
``emit_acc``)."""
from __future__ import annotations

import numpy as np
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


def packed_rows(counts: torch.Tensor, n_experts: int, cap: int
                ) -> list[torch.Tensor]:
    """Each expert's packed row list, as kernel 10 builds it: the live
    rows of group ``b * E + e`` for dispatch blocks ``b = 0, 1, ...`` in
    order, as (G * C)-row indices (int64)."""
    c = torch.clamp(torch.as_tensor(counts).to(torch.int64).reshape(-1), 0,
                    cap).tolist()
    nb = len(c) // n_experts
    return [torch.tensor([(b * n_experts + e) * cap + r for b in range(nb)
                          for r in range(c[b * n_experts + e])],
                         dtype=torch.int64)
            for e in range(n_experts)]


def fused_lut_grouped_plan_ref(x: torch.Tensor, wq: torch.Tensor,
                               lut_flat: torch.Tensor, offset: int,
                               n_codes: int, x_scale, x_zp, w_scale,
                               counts: torch.Tensor, *, plan,
                               segments=None, drop_slice: int | None = None,
                               bits: int = 8,
                               emit_acc: bool = False) -> torch.Tensor:
    """:func:`fused_lut_grouped_ref` summed segment by segment over kernel
    10's work plan, as the kernel sums: the blocks' segments
    (``ops.split_segments`` of the counts, or the ``segments`` given), each
    one's int32 partial over its tile (an expert's packed rows ``rt * bm
    ...``, ``bn`` columns) and its chunks of K; a whole tile stored, a
    split one added into its slot and taken when its chunks are complete;
    one dequant on the full sum. ``drop_slice`` leaves that segment out (a
    planted fault): its tile never completes and stays 0."""
    from .ops import split_segments
    G, C, K = x.shape
    E, _, N = wq.shape
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    dev = x.device
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=dev)
    xz = torch.as_tensor(x_zp, dtype=torch.float32, device=dev)
    ws = torch.as_tensor(w_scale, dtype=torch.float32,
                         device=dev).reshape(E, -1).expand(E, N)
    lut_flat = lut_flat.reshape(-1).to(torch.int32)
    xf = x.reshape(G * C, K)
    rows_of = [r.to(dev) for r in packed_rows(counts, E, C)]
    acc = torch.zeros((G * C, N), dtype=torch.int32, device=dev)
    bm, bn, bk = plan.bm, plan.bn, 32
    _, segs = split_segments(plan, counts) if segments is None else segments
    sums = torch.zeros((plan.n_tiles, bm, bn), dtype=torch.int32,
                       device=dev)
    arrived = [0] * plan.n_tiles
    for i, (t, c0, c1, slot) in enumerate(np.asarray(segs).tolist()):
        if i == drop_slice:
            continue
        e, rt, nt = plan.tile(t)
        rows = rows_of[e][rt * bm:(rt + 1) * bm]
        if rows.numel() == 0:
            continue
        cs = slice(nt * bn, min(N, (nt + 1) * bn))
        ks = slice(c0 * bk, min(K, c1 * bk))
        a = quantize_shifted(xf[rows, ks], xs, xz, lo, hi, offset)
        part = lut_gather_sum(a, wq[e, ks, cs].to(torch.int64) + offset,
                              lut_flat, n_codes)
        if slot < 0:
            acc[rows, cs] = part
            continue
        sums[slot, :part.shape[0], :part.shape[1]] += part
        arrived[slot] += c1 - c0
        if arrived[slot] == plan.chunks:
            acc[rows, cs] = sums[slot, :part.shape[0], :part.shape[1]]
    acc = acc.reshape(G, C, N)
    if emit_acc:
        return acc
    scale = (xs * ws)[torch.arange(G, device=dev) % E]          # (G, N)
    out = acc.to(torch.float32) * scale[:, None, :]
    return torch.where(live_rows(torch.as_tensor(counts, device=dev),
                                 C)[..., None], out, 0.0)
