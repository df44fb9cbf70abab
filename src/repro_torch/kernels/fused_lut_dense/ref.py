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


def fused_lut_dense_plan_ref(x: torch.Tensor, wq: torch.Tensor,
                             lut_flat: torch.Tensor, offset: int,
                             n_codes: int, x_scale, x_zp, w_scale, *, plan,
                             bits: int = 8,
                             emit_acc: bool = False) -> torch.Tensor:
    """:func:`fused_lut_dense_ref` summed segment by segment over kernel
    3's work plan (``ops.dense_plan``), as the kernel sums: each segment's
    int32 partial over its tile and its K groups of 4, the slots past K
    holding the offset code on both sides and ``pad * LUT[off, off]``
    subtracted; a whole tile stored, a split one added into its slot and
    taken when its groups are complete; one dequant on the full sum. A
    plan that leaves a group of a tile out leaves that tile 0."""
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    dev = x.device
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=dev)
    xz = torch.as_tensor(x_zp, dtype=torch.float32, device=dev)
    M, K = x.shape
    N = wq.shape[1]
    kp = plan.groups * 4
    a = torch.full((M, kp), offset, dtype=torch.int64, device=dev)
    a[:, :K] = quantize_shifted(x, xs, xz, lo, hi, offset)
    b = torch.full((kp, N), offset, dtype=torch.int64, device=dev)
    b[:K] = wq.to(torch.int64) + offset
    lut_flat = lut_flat.reshape(-1).to(torch.int32)
    m00 = int(lut_flat[offset * n_codes + offset])
    bm, bn = plan.bm, plan.bn
    acc = torch.zeros((M, N), dtype=torch.int32, device=dev)
    sums = torch.zeros((max(plan.n_slots, 1), bm, bn), dtype=torch.int32,
                       device=dev)
    arrived = [0] * plan.n_slots
    for t, g0, g1, slot in plan.segments.tolist():
        m0, n0 = (t // plan.tiles_n) * bm, (t % plan.tiles_n) * bn
        rs, cs = slice(m0, min(M, m0 + bm)), slice(n0, min(N, n0 + bn))
        ks = slice(4 * g0, 4 * g1)
        pad = 4 * (g1 - g0) - (min(K, 4 * g1) - 4 * g0)
        part = lut_gather_sum(a[rs, ks], b[ks, cs], lut_flat, n_codes) \
            - pad * m00
        if slot < 0:
            acc[rs, cs] = part
            continue
        sums[slot, :part.shape[0], :part.shape[1]] += part
        arrived[slot] += g1 - g0
        if arrived[slot] == plan.groups:
            acc[rs, cs] = sums[slot, :part.shape[0], :part.shape[1]]
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


def fused_lut_bwd_plan_ref(a: torch.Tensor, b: torch.Tensor,
                           lut_flat: torch.Tensor, offset: int, n_codes: int,
                           a_scale, b_scale, *, plan, bits: int = 8,
                           emit_acc: bool = False,
                           drop_slice=None) -> torch.Tensor:
    """:func:`fused_lut_bwd_ref` summed as kernel 4 sums over its plan
    (``ops.bwd_plan``): each segment's int32 partial over its item (a row
    tile and ``nt`` column tiles) and its K groups of 4, chunk by chunk of
    ``kc``, each column tile's groups split among the lanes' K slices (at
    16 columns the half-warps' alternate groups); the slots past K hold
    the offset code on both sides and ``pad * LUT[off, off]`` is
    subtracted; a segment with slot -1 stores its item, the others add
    into their slot, taken when its groups are complete; one dequant
    ``acc * (sa * sb)``. ``drop_slice`` leaves K group ``drop_slice`` out
    of every segment that walks it (a planted fault); a plan that leaves a
    group out leaves its item short."""
    from repro_torch.core.quantization import quantize_symmetric
    dev = a.device
    sa = torch.as_tensor(a_scale, dtype=torch.float32, device=dev)
    sb = torch.as_tensor(b_scale, dtype=torch.float32, device=dev)
    M, K = a.shape
    N = b.shape[1]
    kp = plan.groups * 4
    qa = torch.full((M, kp), offset, dtype=torch.int64, device=dev)
    qa[:, :K] = quantize_symmetric(a, sa, bits).to(torch.int64) + offset
    qb = torch.full((kp, N), offset, dtype=torch.int64, device=dev)
    qb[:K] = quantize_symmetric(b, sb, bits).to(torch.int64) + offset
    lut_flat = lut_flat.reshape(-1).to(torch.int32)
    m00 = int(lut_flat[offset * n_codes + offset])
    bm, bn, width = plan.bm, plan.bn, plan.nt * plan.bn
    acc = torch.zeros((M, N), dtype=torch.int32, device=dev)
    sums = torch.zeros((max(plan.n_slots, 1), bm, width), dtype=torch.int32,
                       device=dev)
    arrived = [0] * plan.n_slots
    for tile, g0, g1, slot in plan.segments.tolist():
        m0 = (tile // plan.tiles_c) * bm
        c0 = (tile % plan.tiles_c) * width
        rs, cs = slice(m0, min(M, m0 + bm)), slice(c0, min(N, c0 + width))
        part = torch.zeros((rs.stop - m0, cs.stop - c0), dtype=torch.int32,
                           device=dev)
        kb, ke = 4 * g0, min(K, 4 * g1)
        for k0 in range(kb, max(ke, kb + 1), plan.kc):
            ng = -(-min(plan.kc, ke - k0) // 4)
            for t in range(plan.nt):
                ts = slice(t * bn, min(t * bn + bn, cs.stop - c0))
                if ts.start >= ts.stop:
                    continue
                for s in range(plan.ks):
                    ks = [k0 + 4 * g + q for g in range(s, ng, plan.ks)
                          if k0 // 4 + g != drop_slice
                          for q in range(4)]
                    if ks:
                        idx = torch.tensor(ks, device=dev)
                        part[:, ts] += lut_gather_sum(
                            qa[rs][:, idx], qb[idx][:, c0 + ts.start:
                                                    c0 + ts.stop],
                            lut_flat, n_codes)
        part -= (4 * (g1 - g0) - (ke - kb)) * m00
        if slot < 0:
            acc[rs, cs] = part
            continue
        sums[slot, :part.shape[0], :part.shape[1]] += part
        arrived[slot] += g1 - g0
        if arrived[slot] == plan.groups:
            acc[rs, cs] = sums[slot, :part.shape[0], :part.shape[1]]
    if emit_acc:
        return acc
    return acc.to(torch.float32) * (sa * sb)
