"""Plain PyTorch versions of the fused conv kernels.

The whole-image forward materialises the im2col patch tensor, then runs the
fused dense plain version: the reference's own oracle, on the same patch
extraction as the eager ``im2col`` route. The plan mirrors
(``fused_lut_conv_plan_ref``, ``fused_lut_conv_tiled_plan_ref``) walk
the loops of kernels 5 and 6 item by item. The banded forward walks
output-row bands as the reference's ``_tiled_kernel`` does, so that its
band and halo arithmetic is tested by something other than im2col. The
weight gradient is the reference's oracle for its banded kernel:
quantize, take the im2col of the **codes** (pads become code 0), then run
the unfused LUT GEMM."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.fused_lut_dense.ref import (fused_lut_dense_ref,
                                                     quantize_shifted)
from repro_torch.kernels.lut_matmul.ref import lut_gather_sum


def fused_lut_conv_ref(x: torch.Tensor, wq: torch.Tensor,
                       lut_flat: torch.Tensor, offset: int, n_codes: int,
                       x_scale, x_zp, w_scale, *, stride=(1, 1),
                       padding=((0, 0), (0, 0)), dilation=(1, 1),
                       bits: int = 8, emit_acc: bool = False
                       ) -> torch.Tensor:
    """x: (N, C, H, W) float; wq: (Cout, C, kh, kw) shifted weight codes.
    Returns (N, Ho, Wo, Cout) float32 (int32 with ``emit_acc``)."""
    from repro_torch.core.approx_ops import _im2col
    cout, _, kh, kw = wq.shape
    cols, (ho, wo) = _im2col(x, kh, kw, stride, padding, dilation)
    m = cols.reshape(-1, cols.shape[-1])                 # (N*P, C*kh*kw)
    wmat = wq.reshape(cout, -1).t()                      # (C*kh*kw, Cout)
    out = fused_lut_dense_ref(m, wmat, lut_flat, offset, n_codes,
                              x_scale, x_zp, w_scale, bits=bits,
                              emit_acc=emit_acc)
    return out.reshape(x.shape[0], ho, wo, cout)


def fused_lut_conv_tiled_ref(x: torch.Tensor, wq: torch.Tensor,
                             lut_flat: torch.Tensor, offset: int,
                             n_codes: int, x_scale, x_zp, w_scale, *,
                             stride=(1, 1), padding=((0, 0), (0, 0)),
                             dilation=(1, 1), bits: int = 8, bh: int = 1,
                             emit_acc: bool = False) -> torch.Tensor:
    """x: (N, C, H, W) float; wq: (Cout, C, kh, kw) shifted weight codes.
    Returns (N, Ho, Wo, Cout) float32 (int32 with ``emit_acc``).

    For each band of ``bh`` output rows the ``(bh-1)*sh + (kh-1)*dh + 1``
    halo'd input rows (0.0 outside the image: the zero-point code) are
    quantized once; each tap (u, v) then gather-sums its strided window
    of the band's codes against its (C, Cout) weight codes. Rows of the
    last band past Ho are dropped."""
    n, c, h, w_in = x.shape
    cout, _, kh, kw = wq.shape
    sh, sw = stride
    dh, dw = dilation
    (ph0, ph1), (pw0, pw1) = padding
    ho = (h + ph0 + ph1 - (kh - 1) * dh - 1) // sh + 1
    wo = (w_in + pw0 + pw1 - (kw - 1) * dw - 1) // sw + 1
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    dev = x.device
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=dev)
    xz = torch.as_tensor(x_zp, dtype=torch.float32, device=dev)
    wtap = wq.permute(2, 3, 1, 0).reshape(kh * kw, c, cout).to(torch.int64) \
        + offset                                        # (taps, C, Cout)
    rows_in = (bh - 1) * sh + (kh - 1) * dh + 1
    acc = torch.zeros((n, max(ho, 0), max(wo, 0), cout), dtype=torch.int32,
                      device=dev)
    for b0 in range(0, ho, bh):
        r0 = b0 * sh - ph0                  # first input row of the band
        top, bottom = max(0, -r0), max(0, r0 + rows_in - h)
        rows = x[:, :, max(r0, 0):min(r0 + rows_in, h)]
        band = F.pad(rows, (pw0, pw1, top, bottom))     # 0.0 pads
        codes = quantize_shifted(band, xs, xz, lo, hi, offset)
        nb = min(bh, ho - b0)
        for t in range(kh * kw):
            u, v = divmod(t, kw)
            win = codes[:, :, u * dh:u * dh + (nb - 1) * sh + 1:sh,
                        v * dw:v * dw + (wo - 1) * sw + 1:sw]
            a = win.permute(0, 2, 3, 1).reshape(-1, c)  # (N*nb*wo, C)
            acc[:, b0:b0 + nb] += lut_gather_sum(
                a, wtap[t], lut_flat, n_codes).reshape(n, nb, wo, cout)
    if emit_acc:
        return acc
    ws = torch.as_tensor(w_scale, dtype=torch.float32, device=dev)
    return acc.to(torch.float32) * (xs * ws.reshape(-1))


def tiled_weight_codes(wq: torch.Tensor, offset: int, n_codes: int,
                       c4: int, bn: int) -> torch.Tensor:
    """Kernels 5's and 6's weight operand: (kh*kw, c4, Cout padded to whole
    ``bn`` tiles) uint8 codes ``wq + offset``, tap-major (each tap's (C,
    Cout) slab, the reference's layout), the channel and Cout pads the
    offset code (the kernels correct the channel pad as ``taps * (c4 - C)
    * LUT[off, off]``). Three elementwise passes when nothing is padded,
    the wrappers' cost on every call."""
    cout, c, kh, kw = wq.shape
    codes = (wq.permute(2, 3, 1, 0).add(offset).clamp_(0, n_codes - 1)
             .to(torch.uint8, memory_format=torch.contiguous_format)
             .reshape(kh * kw, c, cout))
    cout_pad = -(-cout // bn) * bn
    if (c4, cout_pad) == (c, cout):
        return codes
    out = torch.full((kh * kw, c4, cout_pad), offset, dtype=torch.uint8,
                     device=wq.device)
    cc = min(c, c4)
    out[:, :cc, :cout] = codes[:, :cc]
    return out


def fused_lut_conv_tiled_plan_ref(x: torch.Tensor, wq: torch.Tensor,
                                  lut_flat: torch.Tensor, offset: int,
                                  n_codes: int, x_scale, x_zp, w_scale, *,
                                  tiling, stride=(1, 1),
                                  padding=((0, 0), (0, 0)), dilation=(1, 1),
                                  bits: int = 8, emit_acc: bool = False
                                  ) -> torch.Tensor:
    """Kernel 6's loop in plain PyTorch, item by item as ``tiling``
    (``ops.pick_tiled_kernel_tiling``) cuts the work
    (``csrc/fused_lut_conv_tiled.cu``): for each tile of ``bh`` x ``bw``
    output pixels (all images at once) the halo'd band of input pixels,
    0.0 outside the image, quantized once and padded with offset codes to
    ``c4`` channels; steps of ``cc`` channels, each summing every tap's
    window of the band against the tap's uint8 weight codes
    (:func:`tiled_weight_codes`, whole ``bn``-wide Cout tiles); then
    ``taps * (c4 - C) * LUT[off, off]`` subtracted, and the tile's pixels
    inside Ho x Wo and its channels below Cout stored. Returns (N, Ho, Wo,
    Cout) float32 (int32 with ``emit_acc``), the reference's bits."""
    n, c, h, w_in = x.shape
    cout, _, kh, kw = wq.shape
    sh, sw = stride
    dh, dw = dilation
    (ph0, ph1), (pw0, pw1) = padding
    ho = (h + ph0 + ph1 - (kh - 1) * dh - 1) // sh + 1
    wo = (w_in + pw0 + pw1 - (kw - 1) * dw - 1) // sw + 1
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    dev = x.device
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=dev)
    xz = torch.as_tensor(x_zp, dtype=torch.float32, device=dev)
    t = tiling
    bh, bw, cc, c4 = t.bh, t.bw, t.cc, t.c4
    taps = kh * kw
    wcodes = tiled_weight_codes(wq, offset, n_codes, c4, t.bn).to(
        torch.int64)                                    # (taps, c4, Np)
    lut_flat = lut_flat.reshape(-1).to(torch.int32)
    corr = taps * (c4 - c) * int(lut_flat[offset * n_codes + offset])
    acc = torch.zeros((n, max(ho, 0), max(wo, 0), cout), dtype=torch.int32,
                      device=dev)
    pr = torch.arange(bh, device=dev)[:, None] * sh     # tile pixel rows
    pc = torch.arange(bw, device=dev)[None, :] * sw     # ... and columns
    for oh0 in range(0, ho, bh):
        for ow0 in range(0, wo, bw):
            ih0, iw0 = oh0 * sh - ph0, ow0 * sw - pw0
            # the band, 0.0 outside the image, quantized once
            band = x.new_zeros((n, c, t.rows_in, t.cols_in))
            r0, r1 = max(ih0, 0), min(ih0 + t.rows_in, h)
            q0, q1 = max(iw0, 0), min(iw0 + t.cols_in, w_in)
            if r0 < r1 and q0 < q1:
                band[:, :, r0 - ih0:r1 - ih0, q0 - iw0:q1 - iw0] = \
                    x[:, :, r0:r1, q0:q1]
            codes = quantize_shifted(band, xs, xz, lo, hi, offset)
            codes = F.pad(codes, (0, 0, 0, 0, 0, c4 - c), value=offset)
            sums = torch.zeros((n * bh * bw, wcodes.shape[2]),
                               dtype=torch.int32, device=dev)
            for c0 in range(0, c4, cc):                 # the steps
                for tap in range(taps):
                    u, v = divmod(tap, kw)
                    win = codes[:, c0:c0 + cc, u * dh + pr, v * dw + pc]
                    a = win.permute(0, 2, 3, 1).reshape(-1, win.shape[1])
                    sums += lut_gather_sum(a, wcodes[tap, c0:c0 + cc],
                                           lut_flat, n_codes)
            sums = (sums - corr).reshape(n, bh, bw, -1)
            nb, nw = min(bh, ho - oh0), min(bw, wo - ow0)
            acc[:, oh0:oh0 + nb, ow0:ow0 + nw] = sums[:, :nb, :nw, :cout]
    if emit_acc:
        return acc
    ws = torch.as_tensor(w_scale, dtype=torch.float32, device=dev)
    return acc.to(torch.float32) * (xs * ws.reshape(-1))


def fused_lut_conv_plan_ref(x: torch.Tensor, wq: torch.Tensor,
                            lut_flat: torch.Tensor, offset: int,
                            n_codes: int, x_scale, x_zp, w_scale, *, tiling,
                            stride=(1, 1), padding=((0, 0), (0, 0)),
                            dilation=(1, 1), bits: int = 8,
                            emit_acc: bool = False, drop_slice=None
                            ) -> torch.Tensor:
    """Kernel 5's loop in plain PyTorch, item by item as ``tiling``
    (``ops.pick_conv_kernel_tiling``) cuts the work
    (``csrc/fused_lut_conv.cu``): for each item of ``bh`` x ``bw`` output
    pixels (all images and Cout tiles at once) the halo'd band, 0.0
    outside the image, quantized once and padded with offset codes to
    ``c4`` channels; steps of ``cc`` channels; in each, the item's pixels
    by 64-pixel tiles (pixel ``p`` at row ``p // bw``, column ``p % bw``,
    the slots past ``bh * bw`` dead), each K slice of a warp summing its
    (tap, group of 4 channels) pairs (``lut_matmul.ref.slice_pairs``)
    against the uint8 weight codes (:func:`tiled_weight_codes`), the
    slices then added; ``taps * (c4 - C) * LUT[off, off]`` subtracted and
    the pixels inside Ho x Wo stored. ``drop_slice`` leaves one K slice
    out (a planted fault). Returns (N, Ho, Wo, Cout) float32 (int32 with
    ``emit_acc``), the reference's bits."""
    from repro_torch.kernels.lut_matmul.ref import slice_pairs
    n, c, h, w_in = x.shape
    cout, _, kh, kw = wq.shape
    sh, sw = stride
    dh, dw = dilation
    (ph0, ph1), (pw0, pw1) = padding
    ho = (h + ph0 + ph1 - (kh - 1) * dh - 1) // sh + 1
    wo = (w_in + pw0 + pw1 - (kw - 1) * dw - 1) // sw + 1
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    dev = x.device
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=dev)
    xz = torch.as_tensor(x_zp, dtype=torch.float32, device=dev)
    t = tiling
    bh, bw, cc, c4, ks = t.bh, t.bw, t.cc, t.c4, t.ks
    taps = kh * kw
    wcodes = tiled_weight_codes(wq, offset, n_codes, c4, t.bn).to(
        torch.int64)                                    # (taps, c4, Np)
    lut_flat = lut_flat.reshape(-1).to(torch.int32)
    corr = taps * (c4 - c) * int(lut_flat[offset * n_codes + offset])
    acc = torch.zeros((n, max(ho, 0), max(wo, 0), cout), dtype=torch.int32,
                      device=dev)
    for oh0 in range(0, ho, bh):
        for ow0 in range(0, wo, bw):
            ih0, iw0 = oh0 * sh - ph0, ow0 * sw - pw0
            band = x.new_zeros((n, c, t.rows_in, t.cols_in))
            r0, r1 = max(ih0, 0), min(ih0 + t.rows_in, h)
            q0, q1 = max(iw0, 0), min(iw0 + t.cols_in, w_in)
            if r0 < r1 and q0 < q1:
                band[:, :, r0 - ih0:r1 - ih0, q0 - iw0:q1 - iw0] = \
                    x[:, :, r0:r1, q0:q1]
            codes = quantize_shifted(band, xs, xz, lo, hi, offset)
            codes = F.pad(codes, (0, 0, 0, 0, 0, c4 - c), value=offset)
            for tile in range(t.tile_px):
                p = torch.arange(tile * 64, tile * 64 + 64, device=dev)
                pr, pc = p // bw, p % bw
                live = pr < bh
                pr, pc = pr[live], pc[live]
                if len(pr) == 0:
                    continue
                sums = torch.zeros((n * len(pr), wcodes.shape[2]),
                                   dtype=torch.int32, device=dev)
                for c0 in range(0, c4, cc):             # the steps
                    ng = min(cc, c4 - c0) // 4
                    for s in range(ks):
                        if s == drop_slice:
                            continue
                        for tap, g in slice_pairs(taps, ng, ks, s):
                            u, v = divmod(tap, kw)
                            ch = c0 + 4 * g
                            win = codes[:, ch:ch + 4, u * dh + pr * sh,
                                        v * dw + pc * sw]   # (n, 4, P)
                            sums += lut_gather_sum(
                                win.permute(0, 2, 1).reshape(-1, 4),
                                wcodes[tap, ch:ch + 4], lut_flat, n_codes)
                sums = (sums - corr).reshape(n, len(pr), -1)
                oh, ow = oh0 + pr, ow0 + pc
                keep = (oh < ho) & (ow < wo)
                acc[:, oh[keep], ow[keep]] = sums[:, keep, :cout]
    if emit_acc:
        return acc
    ws = torch.as_tensor(w_scale, dtype=torch.float32, device=dev)
    return acc.to(torch.float32) * (xs * ws.reshape(-1))


def fused_lut_conv_bwd_w_ref(x: torch.Tensor, g: torch.Tensor,
                             lut_flat: torch.Tensor, offset: int,
                             n_codes: int, x_scale, g_scale, *,
                             ksize: tuple[int, int], stride=(1, 1),
                             padding=((0, 0), (0, 0)), dilation=(1, 1),
                             bits: int = 8,
                             rmask: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """x: (N, C, H, W) float residual; g: (N, Ho, Wo, Cout) float
    gradient. Returns the int32 (kh*kw, C, Cout) tap-major accumulator
    ``sum_pixels LUT[qx(tap) + off, qg + off]``; with ``rmask`` (N, Ho)
    0/1, over the pixels of the output rows whose entry is nonzero."""
    from repro_torch.core.approx_ops import _im2col
    from repro_torch.core.quantization import quantize_symmetric
    kh, kw = ksize
    c, cout = x.shape[1], g.shape[3]
    qx = quantize_symmetric(x, torch.as_tensor(x_scale), bits)
    qg = quantize_symmetric(g, torch.as_tensor(g_scale), bits)
    # codes are small integers, exact in float32; the 0.0 pads are code 0
    cols, _ = _im2col(qx.to(torch.float32), kh, kw, stride, padding,
                      dilation)                         # (N, P, C*kh*kw)
    cols = cols.reshape(-1, cols.shape[-1]).t().to(torch.int64) + offset
    rows = qg.reshape(-1, cout).to(torch.int64) + offset
    if rmask is not None:
        keep = (rmask != 0)[:, :, None].expand(g.shape[:3]).reshape(-1)
        cols, rows = cols[:, keep], rows[keep]
    acc = lut_gather_sum(cols, rows, lut_flat, n_codes)  # (C*kh*kw, Cout)
    return acc.reshape(c, kh * kw, cout).transpose(0, 1).contiguous()


def fused_lut_conv_bwd_w_plan_ref(x: torch.Tensor, g: torch.Tensor,
                                  lut_flat: torch.Tensor, offset: int,
                                  n_codes: int, x_scale, g_scale, *, tiling,
                                  ksize: tuple[int, int], stride=(1, 1),
                                  padding=((0, 0), (0, 0)), dilation=(1, 1),
                                  bits: int = 8, drop_slice=None
                                  ) -> torch.Tensor:
    """Kernel 7's loop in plain PyTorch, item by item as ``tiling``
    (``ops.pick_bwd_w_tiling``) cuts the work
    (``csrc/fused_lut_conv_bwd_w.cu``): for each item of ``bh`` x ``bw``
    output pixels (all images at once), ``cg`` channels and a ``bn``-wide
    Cout tile, the halo'd input band quantized once (code 0 outside the
    image), the gradient slice quantized once; the item's pixels in
    groups of 4 (pixel ``p`` at row ``p // nw``, column ``p % nw`` of the
    item), group ``i`` summed by pixel slice ``i % n_slices`` (the warps
    across the pixels x a warp's half-warps), each slice summing every
    (tap, channel) row of the item against the Cout tile's columns; the
    slices' sums added into the output rows of channels below C and the
    columns below Cout. ``drop_slice`` leaves one pixel slice out (a
    planted fault); a tiling that leaves a band out leaves its pixels out.
    Returns the int32 (kh*kw, C, Cout) tap-major accumulator, the
    reference's bits."""
    from repro_torch.core.quantization import quantize_symmetric
    n, c, h, w_in = x.shape
    cout = g.shape[3]
    kh, kw = ksize
    sh, sw = stride
    dh, dw = dilation
    (ph0, _), (pw0, _) = padding
    ho, wo = g.shape[1], g.shape[2]
    dev = x.device
    t = tiling
    qx = quantize_symmetric(x, torch.as_tensor(x_scale), bits).to(
        torch.int64) + offset
    qg = quantize_symmetric(g, torch.as_tensor(g_scale), bits).to(
        torch.int64) + offset
    lut_flat = lut_flat.reshape(-1).to(torch.int32)
    out = torch.zeros((kh * kw, c, cout), dtype=torch.int32, device=dev)
    for band in range(t.tiles_h):
        for strip in range(t.tiles_w):
            oh0, ow0 = band * t.bh, strip * t.bw
            nb, nw = min(t.bh, ho - oh0), min(t.bw, wo - ow0)
            if nb <= 0 or nw <= 0:
                continue
            ih0, iw0 = oh0 * sh - ph0, ow0 * sw - pw0
            # the band's codes, code 0 (index off) outside the image
            codes = torch.full((n, c, t.rows_in, t.cols_in), offset,
                               dtype=torch.int64, device=dev)
            r0, r1 = max(ih0, 0), min(ih0 + t.rows_in, h)
            q0, q1 = max(iw0, 0), min(iw0 + t.cols_in, w_in)
            if r0 < r1 and q0 < q1:
                codes[:, :, r0 - ih0:r1 - ih0, q0 - iw0:q1 - iw0] = \
                    qx[:, :, r0:r1, q0:q1]
            p = torch.arange(nb * nw, device=dev)
            pr, pc = p // nw, p % nw
            if drop_slice is not None:
                keep = (p // 4) % t.n_slices != drop_slice
                pr, pc = pr[keep], pc[keep]
            if len(pr) == 0:
                continue
            gs = qg[:, oh0 + pr, ow0 + pc].reshape(-1, cout)   # (n*P, Cout)
            for c0 in range(0, t.c4, t.cg):
                ch = torch.arange(c0, min(c0 + t.cg, c), device=dev)
                if len(ch) == 0:
                    continue
                for tap in range(kh * kw):
                    u, v = divmod(tap, kw)
                    win = codes[:, ch][:, :, u * dh + pr * sh,
                                       v * dw + pc * sw]       # (n, cg, P)
                    a = win.permute(1, 0, 2).reshape(len(ch), -1)
                    for co0 in range(0, cout, t.bn):
                        cs = slice(co0, min(co0 + t.bn, cout))
                        out[tap, ch, cs] += lut_gather_sum(
                            a, gs[:, cs], lut_flat, n_codes)
    return out
