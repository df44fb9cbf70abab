"""Mesh-aware execution of ACU plans (port of ``repro.parallel.acu_shard``,
the second level of dispatch).

``core/acu.py`` resolves *what* kernel runs (mode x fused); this module
resolves *where*. Under a mesh of ranks (``launch/mesh.py: RankMesh``)
every plan is SPMD, as the reference's ``shard_map`` under ``jit``: every
rank calls it with the same **global** operands, and the wrap

* replicates the (2^b, 2^b) product table (every rank has it),
* cuts out this rank's block: activation/output rows by its coordinate on
  the ``acu_rows`` axes, weight/output columns on ``acu_cols``, and
  optionally the contraction on ``acu_k``,
* pads M/N/K up to the axis products exactly as the reference's ``_pad2``
  does (padded rows and columns give discarded outputs; a padded k
  contributes ``M[0, 0]``),
* runs the local kernel on its block,
* sums int32 partial accumulators over the ``k`` group *before* one
  dequant, and applies the K-pad correction ``pk * m00`` once, after that
  sum,
* all-gathers the output blocks, so every rank returns the whole global
  result.

So every plan keeps its global-in, global-out contract, and model code
does not change. The collectives are the mesh's own three
(``RankMesh.psum``, ``pmax``, ``all_gather``; on a gloo group they run on
host copies). Everything stays bitwise equal to the single-device
kernels: each local kernel sees the full contraction or an exact K slice
whose int32 partials add associatively, and the dequant is the kernel's
own expression ``acc.float() * (xs * ws)`` on the reduced accumulator.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .planner import (GemmPartition, acu_attn_partition, acu_conv_partition,
                      acu_gemm_partition, acu_grouped_partition)
from .sharding import MeshContext

Tensor = torch.Tensor


def resolve_partition(ctx: MeshContext, *, float_accum: bool = False
                      ) -> Optional[GemmPartition]:
    """Partition for the active mesh, or None when every axis is trivial
    (the 1 x 1 host mesh: the wrap would do nothing, so the plan stays
    local)."""
    part, _ = acu_gemm_partition(ctx, float_accum=float_accum)
    return part if part.total > 1 else None


def resolve_conv_partition(ctx: MeshContext, *, float_accum: bool = False
                           ) -> Optional[GemmPartition]:
    """The ``acu_conv`` partition for the active mesh (rows = batch x
    output pixels, cols = output channels, k = input channels), or None
    when every axis is trivial."""
    part, _ = acu_conv_partition(ctx, float_accum=float_accum)
    return part if part.total > 1 else None


def resolve_attn_partition(ctx: MeshContext, *, hq: int, hkv: int
                           ) -> Optional[GemmPartition]:
    """The ``acu_attn`` partition for the active mesh (rows = batch, cols =
    KV heads with whole GQA groups per shard), or None when every axis is
    trivial."""
    part, _ = acu_attn_partition(ctx, hq=hq, hkv=hkv)
    return part if part.total > 1 else None


def resolve_grouped_partition(ctx: MeshContext, *, n_experts: int,
                              n_blocks: int) -> Optional[GemmPartition]:
    """The ``acu_grouped`` partition for the active mesh (rows = dispatch
    blocks, cols = whole experts per shard, k = opt-in contraction), or
    None when every axis is trivial."""
    part, _ = acu_grouped_partition(ctx, n_experts=n_experts,
                                    n_blocks=n_blocks)
    return part if part.total > 1 else None


def _pad2(x: Tensor, pr: int, pc: int) -> Tensor:
    return F.pad(x, (0, pc, 0, pr)) if (pr or pc) else x


def _block(mesh, x: Tensor, dim: int, axes: tuple[str, ...]) -> Tensor:
    """This rank's block of ``x`` along ``dim`` (already padded to the
    product of ``axes``), by its linear index along ``axes``."""
    n = mesh.group_size(axes)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axes) * size, size)


def _gather(mesh, x: Tensor, dim: int, axes: tuple[str, ...]) -> Tensor:
    return mesh.all_gather(x, axes, dim) if axes else x


def _f32(v, device) -> Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def wrap_attn(attn_call: Callable[..., Tensor], ctx: MeshContext,
              part: GemmPartition, *, hq: int, hkv: int
              ) -> Callable[..., Tensor]:
    """Shard an approximate attention plan
    ``fn(q, k, v, qs, ks, vs, rowinfo) -> (B, Hq, Sq, D) f32``.

    ``q``: (B, Hq, Sq, D); ``k``/``v``: (B, Hkv, Sk, D); ``rowinfo``: (B,
    3) int32 ``[q_base, kv_start, kv_len]``. Batch rows shard over
    ``part.rows``, KV heads over ``part.cols``: each rank gets whole GQA
    groups and runs the kernel on its (B_loc, Hq_loc) block (``attn_call``
    takes 4-D operands and a per-batch-row ``rowinfo``). No collective but
    the gathers: the kernel is embarrassingly parallel over (batch, head),
    so the wrap is bitwise equal by construction. Scales are the caller's,
    on the full tensors. Padded batch rows carry rowinfo ``[0, 0, 0]``
    (every key masked) and are sliced off.
    """
    mesh = ctx.mesh
    assert hq % hkv == 0 and hkv % part.n_cols == 0, (hq, hkv, part.n_cols)

    def fn(q: Tensor, k: Tensor, v: Tensor, qs, ks, vs,
           rowinfo: Tensor) -> Tensor:
        b = q.shape[0]
        pb = (-b) % part.n_rows
        if pb:
            q, k, v = (F.pad(a, (0, 0, 0, 0, 0, 0, 0, pb)) for a in (q, k, v))
            rowinfo = F.pad(rowinfo, (0, 0, 0, pb))
        blk = lambda a, dim, axes: _block(mesh, a, dim, axes)  # noqa: E731
        q_b, k_b, v_b = (blk(blk(a, 0, part.rows), 1, part.cols)
                         for a in (q, k, v))
        out = attn_call(q_b, k_b, v_b, qs, ks, vs, blk(rowinfo, 0, part.rows))
        out = _gather(mesh, _gather(mesh, out, 1, part.cols), 0, part.rows)
        return out[:b]

    return fn


def wrap_attn_paged(attn_call: Callable[..., Tensor], ctx: MeshContext,
                    part: GemmPartition, *, hq: int, hkv: int
                    ) -> Callable[..., Tensor]:
    """Shard a paged approximate attention plan
    ``fn(q, k_pool, v_pool, qs, ks, vs, rowinfo, page_table) ->
    (B, Hq, Sq, D) f32``.

    The geometry of :func:`wrap_attn`, with the paged twists: the ``(Hkv,
    P, bk, D)`` pools shard over ``part.cols`` on their head axis and
    replicate over the row axes; the ``(B, n_logical)`` page table shards
    with the batch rows like ``rowinfo``. The local fold keeps the global
    ``rep``, so the kernel's ``(b // rep) % Hkv_loc`` lands each local
    query head on its own KV head. Padded batch rows carry rowinfo ``[0,
    0, 0]`` and an all-zero page table (block 0, the engines' zero null
    block): every key masked, sliced off here.
    """
    mesh = ctx.mesh
    assert hq % hkv == 0 and hkv % part.n_cols == 0, (hq, hkv, part.n_cols)

    def fn(q: Tensor, k_pool: Tensor, v_pool: Tensor, qs, ks, vs,
           rowinfo: Tensor, page_table: Tensor) -> Tensor:
        b = q.shape[0]
        pb = (-b) % part.n_rows
        if pb:
            q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pb))
            rowinfo = F.pad(rowinfo, (0, 0, 0, pb))
            page_table = F.pad(page_table, (0, 0, 0, pb))
        blk = lambda a, dim, axes: _block(mesh, a, dim, axes)  # noqa: E731
        out = attn_call(blk(blk(q, 0, part.rows), 1, part.cols),
                        blk(k_pool, 0, part.cols), blk(v_pool, 0, part.cols),
                        qs, ks, vs, blk(rowinfo, 0, part.rows),
                        blk(page_table, 0, part.rows))
        out = _gather(mesh, _gather(mesh, out, 1, part.cols), 0, part.rows)
        return out[:b]

    return fn


def wrap_unfused(base_fn: Callable[[Tensor, Tensor], Tensor],
                 ctx: MeshContext, part: GemmPartition, m00: int
                 ) -> Callable[[Tensor, Tensor], Tensor]:
    """Shard an unfused integer-operand GEMM ``fn(a, w) -> acc``.

    ``m00`` is the multiplier's product at shifted codes (0, 0): what every
    K shard-pad entry contributes to the accumulator.
    """
    mesh = ctx.mesh

    def fn(a: Tensor, w: Tensor) -> Tensor:
        M, K = a.shape
        N = w.shape[1]
        pm, pk, pn = (-M) % part.n_rows, (-K) % part.n_k, (-N) % part.n_cols
        a_p = _pad2(a, pm, pk)          # code 0 == the shifted zero-point
        w_p = _pad2(w, pk, pn)
        acc = base_fn(_block(mesh, _block(mesh, a_p, 0, part.rows), 1,
                             part.k),
                      _block(mesh, _block(mesh, w_p, 0, part.k), 1,
                             part.cols))
        if part.k:
            acc = mesh.psum(acc, part.k)
        out = _gather(mesh, _gather(mesh, acc, 0, part.rows), 1, part.cols)
        if pk and m00:
            # the global K shard-padding correction: once, after the sum;
            # each pad entry added m00 to exactly one k shard
            out = out - pk * m00
        return out[:M, :N]

    return fn


def wrap_fused(fused_call: Callable[..., Tensor],
               acc_call: Callable[..., Tensor], ctx: MeshContext,
               part: GemmPartition, m00: int) -> Callable[..., Tensor]:
    """Shard a fused quantize -> LUT GEMM -> dequant plan
    ``fn(x, wq, xs, xz, ws) -> f32``.

    Without K sharding each rank runs the whole fused kernel on its block
    (the dequant stays in the kernel). With K sharding the kernel emits the
    raw int32 accumulator (``acc_call``), the partials are summed in
    integer space, the K-pad correction lands once, and the dequant, the
    kernel's own ``acc * (xs * ws)``, runs on the sum.
    """
    mesh = ctx.mesh

    def fn(x: Tensor, wq: Tensor, xs, xz, ws) -> Tensor:
        M, K = x.shape
        N = wq.shape[1]
        pm, pk, pn = (-M) % part.n_rows, (-K) % part.n_k, (-N) % part.n_cols
        x_p = _pad2(x, pm, pk)          # 0.0 quantizes to the zero-point
        wq_p = _pad2(wq, pk, pn)        # shifted code 0
        ws_row = _f32(ws, x.device).reshape(1, -1).expand(1, N)
        ws_b = _block(mesh, _pad2(ws_row, 0, pn), 1, part.cols)[0]
        x_b = _block(mesh, _block(mesh, x_p, 0, part.rows), 1, part.k)
        wq_b = _block(mesh, _block(mesh, wq_p, 0, part.k), 1, part.cols)
        if not part.k:
            out = fused_call(x_b, wq_b, xs, xz, ws_b)
        else:
            acc = mesh.psum(acc_call(x_b, wq_b, xs, xz, ws_b), part.k)
            if pk and m00:
                acc = acc - pk * m00
            # the kernel's single combined-scale multiply: bitwise the
            # single-device output
            out = acc.to(torch.float32) * (
                _f32(xs, x.device).reshape(-1)[0] * ws_b).reshape(1, -1)
        out = _gather(mesh, _gather(mesh, out, 0, part.rows), 1, part.cols)
        return out[:M, :N]

    return fn


def wrap_fused_bwd(bwd_call: Callable[..., Tensor],
                   acc_call: Callable[..., Tensor], ctx: MeshContext,
                   part: GemmPartition, m00: int) -> Callable[..., Tensor]:
    """Shard a fused approximate-backward GEMM ``fn(a, b, sa, sb) -> f32
    (M, N)``.

    Both operands are float residuals quantized in the kernel with the
    caller's per-tensor symmetric scales (computed on the full tensors, so
    every rank quantizes alike). ``part`` is a permuted forward partition
    (``planner.bwd_gemm_partitions``), so the contraction axes here are the
    forward's rows or cols axes. Without contraction sharding each rank
    runs the whole fused kernel; with it the kernel emits raw int32
    partials (``acc_call``), they are summed, the K-pad correction (zero
    pads quantize to code 0, ``M[0, 0]`` each) lands once, and the one
    combined-scale dequant ``acc * (sa * sb)`` runs on the sum.
    """
    mesh = ctx.mesh

    def fn(a: Tensor, b: Tensor, sa, sb) -> Tensor:
        M, K = a.shape
        N = b.shape[1]
        pm, pk, pn = (-M) % part.n_rows, (-K) % part.n_k, (-N) % part.n_cols
        a_b = _block(mesh, _block(mesh, _pad2(a, pm, pk), 0, part.rows), 1,
                     part.k)
        b_b = _block(mesh, _block(mesh, _pad2(b, pk, pn), 0, part.k), 1,
                     part.cols)
        if not part.k:
            out = bwd_call(a_b, b_b, sa, sb)
        else:
            acc = mesh.psum(acc_call(a_b, b_b, sa, sb), part.k)
            if pk and m00:
                acc = acc - pk * m00
            out = acc.to(torch.float32) * (_f32(sa, a.device)
                                           * _f32(sb, a.device))
        out = _gather(mesh, _gather(mesh, out, 0, part.rows), 1, part.cols)
        return out[:M, :N]

    return fn


def wrap_fused_grouped(grouped_call: Callable[..., Tensor],
                       acc_call: Callable[..., Tensor], ctx: MeshContext,
                       part: GemmPartition, m00: int, *, n_experts: int
                       ) -> Callable[..., Tensor]:
    """Shard a fused grouped ragged GEMM plan
    ``fn(xe, wq, xs, xz, ws, counts) -> (G, C, N) f32``.

    ``xe``: (G, C, K) capacity buffers, ``G = nb * E`` groups block-major,
    viewed as (nb, E, C, K): dispatch blocks shard over ``part.rows`` and
    experts over ``part.cols`` (expert parallelism). Each rank keeps whole
    experts and whole dispatch blocks (the resolver drops axes that do not
    divide), so the local group -> expert map ``g % E_loc`` is the global
    one restricted to the rank, and the counts ride with their groups.
    Without K sharding each rank runs the whole fused kernel (dead rows
    stay masked in the kernel). With K sharding the kernel emits the
    masked int32 accumulator (``acc_call``), partials are summed, the K-pad
    correction lands once (which un-zeroes the dead rows), so the live-row
    mask is applied again after the dequant.
    """
    mesh = ctx.mesh

    def fn(xe: Tensor, wq: Tensor, xs, xz, ws, counts: Tensor) -> Tensor:
        G, C, K = xe.shape
        E, _, N = wq.shape
        assert E == n_experts and G % E == 0, (G, E, n_experts)
        nb = G // E
        assert nb % part.n_rows == 0 and E % part.n_cols == 0, (
            f"partition {part.n_rows}x{part.n_cols} does not divide "
            f"blocks={nb} experts={E} (the resolver drops such axes)")
        pk = (-K) % part.n_k
        x4 = xe.reshape(nb, E, C, K)
        if pk:  # 0.0 quantizes to the zero-point -> shifted code 0
            x4 = F.pad(x4, (0, pk))
            wq = F.pad(wq, (0, 0, 0, pk))
        ws_e = _f32(ws, xe.device).reshape(E, -1).expand(E, N)
        cnt = torch.as_tensor(counts).to(device=xe.device,
                                         dtype=torch.int32).reshape(nb, E)
        blk = lambda a, dim, axes: _block(mesh, a, dim, axes)  # noqa: E731
        x_b = blk(blk(blk(x4, 0, part.rows), 1, part.cols), 3, part.k)
        wq_b = blk(blk(wq, 0, part.cols), 1, part.k)
        ws_b = blk(ws_e, 0, part.cols)
        cnt_b = blk(blk(cnt, 0, part.rows), 1, part.cols)
        nbl, el = x_b.shape[0], x_b.shape[1]
        args = (x_b.reshape(nbl * el, C, x_b.shape[3]), wq_b, xs, xz, ws_b,
                cnt_b.reshape(-1))
        if not part.k:
            out = grouped_call(*args).reshape(nbl, el, C, N)
        else:
            acc = mesh.psum(acc_call(*args), part.k)
            if pk and m00:
                acc = acc - pk * m00
            # the kernel's single combined-scale multiply; then the mask
            # again: the uniform pad correction gave dead rows -pk * m00
            deq = acc.reshape(nbl, el, C, N).to(torch.float32) * (
                _f32(xs, xe.device).reshape(-1)[0] * ws_b)[None, :, None, :]
            live = (torch.arange(C, device=xe.device)[None, None, :]
                    < cnt_b[:, :, None])
            out = torch.where(live[..., None], deq, 0.0)
        out = _gather(mesh, _gather(mesh, out, 1, part.cols), 0, part.rows)
        return out.reshape(G, C, N)

    return fn


def _conv_band_ways(n: int, ho: int, n_rows: int) -> int:
    """Output-row band ways for the conv rows partition: when the batch
    alone cannot fill the ``acu_conv_rows`` axes (N < n_rows with N |
    n_rows), each image's output rows split into ``n_rows // N`` halo'd
    bands, so the spare ranks compute spatial bands instead of padding
    images."""
    if n >= n_rows or n_rows % n != 0:
        return 1
    bw = n_rows // n
    return bw if ho >= bw else 1


def _band_geometry(spec, band_ways: int):
    ho = spec.out_spatial[0]
    sh, kh, dh = spec.stride[0], spec.w_shape[2], spec.dilation[0]
    ho_band = -(-ho // band_ways)
    slab_rows = (ho_band - 1) * sh + (kh - 1) * dh + 1
    rows_needed = (band_ways - 1) * ho_band * sh + slab_rows
    return ho_band, slab_rows, rows_needed


def _row_pad(x: Tensor, top: int, bottom: int, keep: int) -> Tensor:
    """``x`` (N, C, H, W) with ``top`` zero rows above and ``bottom`` below,
    cut to its first ``keep`` rows."""
    return F.pad(x, (0, 0, top, bottom))[:, :, :keep]


def wrap_fused_conv(conv_call: Callable[..., Tensor],
                    acc_call: Callable[..., Tensor], ctx: MeshContext,
                    part: GemmPartition, m00: int, n_taps: int, *,
                    spec=None) -> Callable[..., Tensor]:
    """Shard a fused conv plan ``fn(x, wq, xs, xz, ws) -> (N, Ho, Wo, Cout)
    f32``.

    ``x``: (N, C, H, W) float; ``wq``: (Cout, C, kh, kw) shifted weight
    codes. The batch x output-row-band dim shards over ``part.rows``: a
    rank takes whole images, or, when the batch alone cannot fill the rows
    axes, one halo'd output-row band of an image (its slab of input rows
    cut from the zero-padded image and passed with zero row padding, the
    ``padding=`` override of the plan's call). Output channels shard over
    ``part.cols``; every rank runs the whole fused kernel on its tile, so
    there is no collective but the gathers and the wrap is bitwise equal
    by construction. With ``part.k`` the input channels split: each rank's
    kernel emits its raw int32 partial (``acc_call``), the partials are
    summed, the channel-pad correction ``pad_c * n_taps * M[0, 0]`` lands
    once, and the one combined-scale dequant follows. ``n_taps`` is ``kh *
    kw``; ``spec`` is the plan's ``ConvSpec`` (banding needs its static
    geometry and is skipped without it).
    """
    mesh = ctx.mesh

    def fn(x: Tensor, wq: Tensor, xs, xz, ws) -> Tensor:
        n, c, h = x.shape[0], x.shape[1], x.shape[2]
        cout = wq.shape[0]
        band_ways = 1
        if spec is not None and part.rows:
            band_ways = _conv_band_ways(n, spec.out_spatial[0], part.n_rows)
        pk = (-c) % part.n_k
        pn = (-cout) % part.n_cols
        call_kw = {}
        if band_ways > 1:
            (ph0, _), (pw0, pw1) = spec.padding
            ho_band, slab_rows, rows_needed = _band_geometry(spec, band_ways)
            x = F.pad(x, (0, 0, 0, 0, 0, pk)) if pk else x
            x = _row_pad(x, ph0, max(0, rows_needed - h - ph0), rows_needed)
            r = mesh.axis_index(part.rows)
            b_idx, band = r // band_ways, r % band_ways
            x_b = x[b_idx:b_idx + 1, :, band * ho_band * spec.stride[0]:
                    band * ho_band * spec.stride[0] + slab_rows]
            call_kw = {"padding": ((0, 0), (pw0, pw1))}
        else:
            pb = (-n) % part.n_rows
            if pb or pk:
                x = F.pad(x, (0, 0, 0, 0, 0, pk, 0, pb))
            x_b = _block(mesh, x, 0, part.rows)
        x_b = _block(mesh, x_b, 1, part.k)
        if pn or pk:  # pad channels: shifted code 0; pad couts: discarded
            wq = F.pad(wq, (0, 0, 0, 0, 0, pk, 0, pn))
        wq_b = _block(mesh, _block(mesh, wq, 0, part.cols), 1, part.k)
        ws_row = _f32(ws, x.device).reshape(1, -1).expand(1, cout)
        ws_b = _block(mesh, _pad2(ws_row, 0, pn), 1, part.cols)[0]
        if not part.k:
            out = conv_call(x_b, wq_b, xs, xz, ws_b, **call_kw)
        else:
            acc = mesh.psum(acc_call(x_b, wq_b, xs, xz, ws_b, **call_kw),
                            part.k)
            if pk and m00:
                # each padded channel added m00 through every tap, to
                # exactly one channel shard: corrected once, after the sum
                acc = acc - pk * n_taps * m00
            out = acc.to(torch.float32) * (
                _f32(xs, x.device).reshape(-1)[0] * ws_b).reshape(1, 1, 1, -1)
        out = _gather(mesh, _gather(mesh, out, 3, part.cols), 0, part.rows)
        if band_ways > 1:
            ho, wo = spec.out_spatial
            out = out[:, :, :, :cout]
            out = out.reshape(n, band_ways * out.shape[1], wo, cout)
            return out[:, :ho]
        return out[:n, :, :, :cout]

    return fn


def wrap_conv_bwd_w(acc_call: Callable[..., Tensor], ctx: MeshContext,
                    part: GemmPartition, spec) -> Callable[..., Tensor]:
    """Shard the banded approximate conv weight gradient
    ``fn(xf, g, sx, sg) -> (kh*kw, Cin, Cout) int32``.

    The weight gradient contracts over output pixels, the *rows* of the
    conv partition: the batch x output-row-band dim shards over
    ``part.rows`` (the forward's halo'd band slabs) and the per-rank int32
    partials are summed over the rows axes. Output channels shard over
    ``part.cols`` and input channels over ``part.k``: both are *output*
    dims of gw, so they cut the accumulator with no sum. There is no pad
    correction: padded images and dead band-slab rows carry a zero
    ``rmask`` (kernel 7 leaves them out, since an invalid row would add
    the non-constant ``M[x, 0]``), and padded channels only fill discarded
    slices. ``acc_call(x, g, rmask, sx, sg, padding)`` is the single-device
    kernel 7 call.
    """
    mesh = ctx.mesh

    def fn(xf: Tensor, g: Tensor, sx, sg) -> Tensor:
        n, c, h = xf.shape[0], xf.shape[1], xf.shape[2]
        cout = g.shape[3]
        ho = spec.out_spatial[0]
        band_ways = 1
        if part.rows:
            band_ways = _conv_band_ways(n, ho, part.n_rows)
        pk = (-c) % part.n_k
        pn = (-cout) % part.n_cols
        (ph0, _), (pw0, pw1) = spec.padding
        if band_ways > 1:
            ho_band, slab_rows, rows_needed = _band_geometry(spec, band_ways)
            xf = F.pad(xf, (0, 0, 0, 0, 0, pk)) if pk else xf
            xf = _row_pad(xf, ph0, max(0, rows_needed - h - ph0), rows_needed)
            g = F.pad(g, (0, pn, 0, 0, 0, band_ways * ho_band - ho))
            r = mesh.axis_index(part.rows)
            b_idx, band = r // band_ways, r % band_ways
            sh = spec.stride[0]
            x_b = xf[b_idx:b_idx + 1, :, band * ho_band * sh:
                     band * ho_band * sh + slab_rows]
            g_b = g[b_idx:b_idx + 1, band * ho_band:(band + 1) * ho_band]
            # slab rows past Ho (the last band of an uneven split) are dead
            rm = ((band * ho_band + torch.arange(ho_band, device=g.device))
                  < ho).to(torch.int32).reshape(1, ho_band)
            pad_kw = {"padding": ((0, 0), (pw0, pw1))}
        else:
            pb = (-n) % part.n_rows
            if pb or pk:
                xf = F.pad(xf, (0, 0, 0, 0, 0, pk, 0, pb))
            if pb or pn:
                g = F.pad(g, (0, pn, 0, 0, 0, 0, 0, pb))
            rmask = F.pad(torch.ones((n, ho), dtype=torch.int32,
                                     device=g.device), (0, 0, 0, pb))
            x_b = _block(mesh, xf, 0, part.rows)
            g_b = _block(mesh, g, 0, part.rows)
            rm = _block(mesh, rmask, 0, part.rows)
            pad_kw = {"padding": spec.padding}
        x_b = _block(mesh, x_b, 1, part.k)
        g_b = _block(mesh, g_b, 3, part.cols)
        acc = acc_call(x_b, g_b, rm, sx, sg, **pad_kw)
        if part.rows:
            # the pixel contraction: int32 partials, one per band slab
            acc = mesh.psum(acc, part.rows)
        out = _gather(mesh, _gather(mesh, acc, 1, part.k), 2, part.cols)
        return out[:, :c, :cout]

    return fn


def wrap_conv_gx_gemm(acc_call: Callable[..., Tensor], ctx: MeshContext,
                      part: GemmPartition, m00: int
                      ) -> Callable[..., Tensor]:
    """Shard one per-band input-gradient GEMM ``fn(g2, wfmat, sg, sw) ->
    int32``.

    ``g2``: (band pixels, Cout) float gradient rows; ``wfmat``: (Cout,
    C*kh*kw) float residual weights. The contraction is Cout, the conv
    partition's *cols* axes: each cols rank runs the fused backward kernel
    on its Cout slice (``acc_call`` = ``fused_lut_bwd`` with ``emit_acc``),
    the int32 partials are summed over ``part.cols``, and the Cout pad
    correction (zero pads quantize to code 0, ``M[0, 0]`` each) lands once,
    after the sum. The rows and k axes compute replicated. The caller
    scatters the accumulator into its integer gradient canvas and dequants
    once.
    """
    mesh = ctx.mesh

    def fn(g2: Tensor, bmat: Tensor, sg, sw) -> Tensor:
        K = g2.shape[1]
        pk = (-K) % part.n_cols
        a_b = _block(mesh, _pad2(g2, 0, pk), 1, part.cols)
        b_b = _block(mesh, _pad2(bmat, pk, 0), 0, part.cols)
        acc = acc_call(a_b, b_b, sg, sw)
        if part.cols:
            acc = mesh.psum(acc, part.cols)
        if pk and m00:
            acc = acc - pk * m00
        return acc

    return fn


def bwd_gemms(ctx: MeshContext, part: GemmPartition
              ) -> tuple[Callable[[Tensor, Tensor], Tensor],
                         Callable[[Tensor, Tensor], Tensor]]:
    """The exact STE backward GEMMs with the forward partition's layout:
    ``gx = g @ wf.T`` computed row-blocked like the activations, ``gw =
    xf.T @ g`` column-blocked like the weights. Each local matmul
    contracts the *full* reduction dim, so the gradients are bitwise the
    unsharded backward's (each output element is one row-by-column
    product whatever the block)."""
    mesh = ctx.mesh

    def gx_fn(g: Tensor, wf: Tensor) -> Tensor:
        M = g.shape[0]
        pm = (-M) % part.n_rows
        g_b = _block(mesh, _pad2(g, pm, 0), 0, part.rows)
        return _gather(mesh, g_b @ wf.T, 0, part.rows)[:M]

    def gw_fn(xf: Tensor, g: Tensor) -> Tensor:
        N = g.shape[1]
        pn = (-N) % part.n_cols
        g_b = _block(mesh, _pad2(g, 0, pn), 1, part.cols)
        return _gather(mesh, xf.T @ g_b, 1, part.cols)[:, :N]

    return gx_fn, gw_fn
