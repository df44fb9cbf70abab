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


# ---------------------------------------------------------------------------
# the narrow-N core of kernels 1 and 5 (csrc/lut_narrow.cuh), in Python
# ---------------------------------------------------------------------------

def lane_map(bn: int) -> tuple[int, int, list[int], list[int]]:
    """The core's lane map of a ``bn``-column tile: (K slices of a warp,
    columns of a lane, each lane's first column, each lane's K slice). At
    16 columns the lanes are 16 columns x 2 K slices, at 32 and over 32
    lanes x ``bn / 32`` columns and one slice (``Lanes<BN>``)."""
    if bn not in (16, 32, 64, 128, 256):
        raise ValueError(f"column tiles are 16, 32, 64, 128 or 256 wide, "
                         f"not {bn}")
    ks = 2 if bn == 16 else 1
    cols = 32 // ks
    tn = bn // cols
    return ks, tn, [(l % cols) * tn for l in range(32)], \
        [l // cols for l in range(32)]


def slice_pairs(taps: int, ng: int, n_slices: int, s: int):
    """The (tap, group of 4) pairs K slice ``s`` of ``n_slices`` walks, in
    the kernels' order: pairs ``t * ng + g = s, s + n_slices, ...``,
    tap-major. Kernel 1 walks one tap (its K chunk's groups), kernel 5 a
    chunk's taps x channel groups."""
    t, g = 0, s
    while g >= ng and t < taps:
        g -= ng
        t += 1
    while t < taps:
        yield t, g
        g += n_slices
        while g >= ng:
            g -= ng
            t += 1


def lut_matmul_plan_ref(a: torch.Tensor, w: torch.Tensor,
                        lut_flat: torch.Tensor, offset: int, n_codes: int,
                        *, plan, drop_slice=None) -> torch.Tensor:
    """:func:`lut_matmul_ref` summed as kernel 1 sums over its work plan
    (``ops.lut_plan``): each segment's int32 partial over its tile and its
    K groups of 4, in chunks of 32 K each split among the warps' and
    lanes' K slices (:func:`slice_pairs`), the slots past K holding the
    offset code on both sides and ``pad * LUT[off, off]`` subtracted; a
    whole tile stored, a split one added into its slot and taken when its
    groups are complete. ``drop_slice`` leaves one K slice out (a planted
    fault); a plan that leaves a group of a tile out leaves that tile 0."""
    M, K = a.shape
    N = w.shape[1]
    dev = a.device
    kp = plan.groups * 4
    ai = torch.full((M, kp), offset, dtype=torch.int64, device=dev)
    ai[:, :K] = (a.to(torch.int64) + offset).clamp(0, n_codes - 1)
    wi = torch.full((kp, N), offset, dtype=torch.int64, device=dev)
    wi[:K] = (w.to(torch.int64) + offset).clamp(0, n_codes - 1)
    lut_flat = lut_flat.reshape(-1).to(torch.int32)
    m00 = int(lut_flat[offset * n_codes + offset])
    bm, bn = plan.bm, plan.bn
    out = torch.zeros((M, N), dtype=torch.int32, device=dev)
    sums = torch.zeros((max(plan.n_slots, 1), bm, bn), dtype=torch.int32,
                       device=dev)
    arrived = [0] * plan.n_slots
    for t, g0, g1, slot in plan.segments.tolist():
        m0, n0 = (t // plan.tiles_n) * bm, (t % plan.tiles_n) * bn
        rs, cs = slice(m0, min(M, m0 + bm)), slice(n0, min(N, n0 + bn))
        part = torch.zeros((rs.stop - m0, cs.stop - n0), dtype=torch.int32,
                           device=dev)
        kb, ke = 4 * g0, min(K, 4 * g1)
        pad = 0
        for k0 in range(kb, ke, 32):
            kn = min(32, ke - k0)
            ng = -(-kn // 4)
            pad += 4 * ng - kn
            for s in range(plan.n_slices):
                if s == drop_slice:
                    continue
                ks = [k0 + 4 * g + q for _, g in
                      slice_pairs(1, ng, plan.n_slices, s) for q in range(4)]
                if ks:    # slots past K hold the offset code (ai, wi)
                    idx = torch.tensor(ks, device=dev)
                    part += lut_gather_sum(ai[rs][:, idx], wi[idx][:, cs],
                                           lut_flat, n_codes)
        part -= pad * m00
        if slot < 0:
            out[rs, cs] = part
            continue
        sums[slot, :part.shape[0], :part.shape[1]] += part
        arrived[slot] += g1 - g0
        if arrived[slot] == plan.groups:
            out[rs, cs] = sums[slot, :part.shape[0], :part.shape[1]]
    return out
