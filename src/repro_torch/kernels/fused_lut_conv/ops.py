"""Public wrappers of the fused conv kernels: the whole-image forward
(kernel 5, ``csrc/fused_lut_conv.cu``), the banded forward (kernel 6,
``csrc/fused_lut_conv_tiled.cu``) and the approximate weight gradient
(kernel 7, ``csrc/fused_lut_conv_bwd_w.cu``); the conv geometry helpers;
and the reference's route arithmetic.

Kernels 5 and 6 both stage a halo'd band of the NCHW image, quantize each
of its pixels once into one-byte codes (pixels outside the image are the
reference's quantized 0.0 padding) and pad the channels to a multiple of 4
with the offset code, subtracting ``taps * c_pad * LUT[off, off]``. Kernel
5's items are whole images or bands of whole output rows of every channel
where they fit (:func:`pick_conv_kernel_tiling`), its Cout tiles as narrow
as 16 (two K slices a warp); kernel 6's items are tiles of at most 64
output pixels in channel steps (:func:`pick_tiled_kernel_tiling`).

**Routing only.** ``CONV_VMEM_BUDGET``, ``MAX_BAND_COPIES``,
``pick_conv_tiling``, ``conv_vmem_bytes``, ``band_copies``,
``conv_tiled_vmem_bytes`` and ``pick_conv_spatial_tiling`` are copies of
the reference's TPU VMEM model. The port uses them for one thing: to send
each conv down the route the reference sends it (``core.acu.conv_plan``).
The 12 MiB is the reference's threshold, not a property of the H100, and
nothing here sizes a CUDA tile with it: kernel 5's and kernel 6's tilings
come from this card's shared memory.

The weight-gradient wrapper (kernel 7) drops the reference's ``bh``,
``bn`` and ``mc`` arguments: they size VMEM row bands. Kernel 7 runs its
own tiling (:func:`pick_bwd_w_tiling`: items of a band of output rows x a
channel group x a Cout tile, quantized once into shared memory, at least
two an SM at ResNet-20's and CNN-224's shapes) and masks the pixels past a
slice. It keeps the reference's ``rmask``, a (N, Ho) 0/1 output-row mask:
the mesh runtime (``parallel/acu_shard.py: wrap_conv_bwd_w``) gives every
band slab and padded image one, and a masked row adds nothing.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.fused_lut_dense.ops import scale_operands
from repro_torch.kernels.lut_matmul.ref import lane_map
from .ref import (fused_lut_conv_bwd_w_ref, fused_lut_conv_ref,
                  fused_lut_conv_tiled_ref, tiled_weight_codes)

# the reference's conservative per-core VMEM budget of its fused conv
# kernels: a conv whose whole-image working set exceeds it takes the tiled
# route there (and here), and one where even a one-row band exceeds it
# takes eager im2col
CONV_VMEM_BUDGET = 12 << 20

# halo blocks per band the reference's tiled kernel streams before its
# planner calls the geometry degenerate
MAX_BAND_COPIES = 4


def conv_out_size(size: int, k: int, stride: int, dilation: int,
                  pad: tuple[int, int]) -> int:
    """Output extent of one spatial dim under explicit padding."""
    eff_k = (k - 1) * dilation + 1
    return (size + pad[0] + pad[1] - eff_k) // stride + 1


def conv_padded_geometry(h: int, w: int, kh: int, kw: int, sh: int, sw: int,
                         dh: int, dw: int,
                         padding: tuple[tuple[int, int], tuple[int, int]],
                         bh: int) -> tuple[int, int, int, int, int]:
    """(ho, wo, ho_pad, hp, wp): the output extents, the output rows padded
    to a multiple of ``bh``, and the padded input extents every tap of
    those rows reads (the reference's geometry, for its VMEM model)."""
    (ph0, ph1), (pw0, pw1) = padding
    ho = conv_out_size(h, kh, sh, dh, (ph0, ph1))
    wo = conv_out_size(w, kw, sw, dw, (pw0, pw1))
    ho_pad = -(-ho // bh) * bh
    need_h = (ho_pad - 1) * sh + (kh - 1) * dh + 1
    need_w = (wo - 1) * sw + (kw - 1) * dw + 1
    return ho, wo, ho_pad, max(h + ph0 + ph1, need_h), \
        max(w + pw0 + pw1, need_w)


def pick_conv_tiling(c: int, ho: int, wo: int, cout: int, *,
                     inner: int = 32, bh: int = 0, bn: int = 128
                     ) -> tuple[int, int, int]:
    """The (inner, bh, bn) tiles of the reference's whole-image kernel at
    this geometry (routing only)."""
    inner = min(inner, c)
    if bh <= 0:  # target ~256 patch rows per strip
        bh = max(1, min(ho, 256 // max(wo, 1)))
    bh = min(bh, ho)
    bn = min(bn, cout)
    return inner, bh, bn


def _grid_step_bytes(c_pad: int, bh: int, wo: int, sh: int, sw: int,
                     inner: int, bn: int) -> int:
    """Per-grid-step VMEM of both reference kernels: the tap window before
    and after the strided slice, the gather tensors, the accumulator and
    output tile."""
    bm = bh * wo
    win_rows = (bh - 1) * sh + 1
    win_cols = (wo - 1) * sw + 1
    return (4 * c_pad * win_rows * win_cols
            + 4 * bm * c_pad
            + 8 * bm * inner * bn
            + 8 * bm * bn)


def conv_vmem_bytes(c: int, h: int, w: int, cout: int, kh: int, kw: int,
                    sh: int, sw: int, dh: int, dw: int,
                    padding: tuple[tuple[int, int], tuple[int, int]],
                    n_codes: int, *, inner: int = 32, bh: int = 0,
                    bn: int = 128) -> int:
    """VMEM working set of the reference's whole-image kernel (routing
    only): image block and code scratch, LUT, weight codes, one grid
    step."""
    ho, wo, _, _, _ = conv_padded_geometry(h, w, kh, kw, sh, sw, dh, dw,
                                           padding, 1)
    inner, bh, bn = pick_conv_tiling(c, ho, wo, cout, inner=inner, bh=bh,
                                     bn=bn)
    _, _, _, hp, wp = conv_padded_geometry(h, w, kh, kw, sh, sw, dh, dw,
                                           padding, bh)
    c_pad = c + (-c) % inner
    return (8 * c_pad * hp * wp
            + 4 * n_codes * n_codes
            + 4 * kh * kw * c_pad * bn
            + _grid_step_bytes(c_pad, bh, wo, sh, sw, inner, bn))


def band_copies(bh: int, kh: int, sh: int, dh: int) -> int:
    """Halo blocks of ``bh*sh`` rows the reference's tiled kernel streams
    per band of ``bh`` output rows."""
    s_rows = bh * sh
    need = (bh - 1) * sh + (kh - 1) * dh + 1
    return -(-need // s_rows)


def conv_tiled_vmem_bytes(c: int, h: int, w: int, cout: int, kh: int,
                          kw: int, sh: int, sw: int, dh: int, dw: int,
                          padding: tuple[tuple[int, int], tuple[int, int]],
                          n_codes: int, *, inner: int, bh: int, bn: int
                          ) -> int:
    """VMEM working set of the reference's tiled kernel at band height
    ``bh`` (routing only): the halo blocks, never the whole image."""
    ho, wo, _, _, wp = conv_padded_geometry(h, w, kh, kw, sh, sw, dh, dw,
                                            padding, bh)
    c_pad = c + (-c) % inner
    rows = band_copies(bh, kh, sh, dh) * bh * sh
    return (8 * c_pad * rows * wp
            + 4 * n_codes * n_codes
            + 4 * kh * kw * c_pad * bn
            + _grid_step_bytes(c_pad, bh, wo, sh, sw, inner, bn))


def pick_conv_spatial_tiling(c: int, h: int, w: int, cout: int, kh: int,
                             kw: int, sh: int, sw: int, dh: int, dw: int,
                             padding: tuple[tuple[int, int], tuple[int, int]],
                             n_codes: int, *,
                             budget: int = CONV_VMEM_BUDGET,
                             inner: int = 32, bn: int = 128
                             ) -> Optional[tuple[int, int, int, int]]:
    """The reference's (inner, bh, bn, n_copies) banding: the tallest band
    whose working set fits ``budget``, or None for degenerate geometry
    (routing only: the port's planner reads whether it is None)."""
    ho, wo, _, _, _ = conv_padded_geometry(h, w, kh, kw, sh, sw, dh, dw,
                                           padding, 1)
    inner = min(inner, c)
    bn = min(bn, cout)
    for bh in range(min(ho, 64), 0, -1):
        n_copies = band_copies(bh, kh, sh, dh)
        if n_copies > MAX_BAND_COPIES:
            continue
        if conv_tiled_vmem_bytes(c, h, w, cout, kh, kw, sh, sw, dh, dw,
                                 padding, n_codes, inner=inner, bh=bh,
                                 bn=bn) <= budget:
            return inner, bh, bn, n_copies
    return None


# shared memory one block of kernel 6 may use (the H100's opt-in limit)
SMEM_PER_BLOCK = 232_448
# kernel 6's block: 8 warps of 8 output pixels each, every lane TN output
# channels (TN = 1, 2 or 4: Cout tiles of 32, 64 or 128)
TILED_PIXELS = 64
TILED_COUT_TILES = (128, 64, 32)
TILED_MAX_CHUNK = 64     # input channels staged per step, at most


def _round16(n: int) -> int:
    return (n + 15) & ~15


@dataclasses.dataclass(frozen=True)
class TiledKernelTiling:
    """Kernel 6's tiles: one work item computes ``bh`` output rows x ``bw``
    output columns (at most 64 pixels, 8 a warp) x ``bn`` output channels
    of one image, staging ``cc`` input channels a step (a multiple of 4;
    the channels padded to ``c4``) as one-byte codes of the halo'd band
    (``rows_in`` x ``cols_in`` input pixels)."""

    bh: int
    bw: int
    cc: int
    bn: int
    rows_in: int
    cols_in: int
    smem_bytes: int
    tiles: int          # tiles per image: row bands x column strips x Cout
    c4: int = 0         # input channels padded to a multiple of 4
    chunks: int = 1     # steps of cc channels per item

    @property
    def tn(self) -> int:
        """Output channels of one lane."""
        return self.bn // 32

    def describe(self, ho: int) -> str:
        return (f"tiles of {self.bh} output rows x {self.bw} columns "
                f"({-(-ho // self.bh)} bands, {self.tiles} tiles per image), "
                f"Cout tile {self.bn} ({self.tn} a lane), channel chunk "
                f"{self.cc} ({self.chunks} steps; {self.c4} channels with the "
                f"pad), band {self.rows_in} x {self.cols_in} input pixels, "
                f"{self.smem_bytes} B of shared memory")


def _tiled_smem(n_codes: int, plane: int, taps: int, cc: int, bn: int
                ) -> int:
    """Dynamic shared memory of one kernel-6 block, as the source's
    ``Layout`` sizes it: the int16 table, one chunk's raw float band and
    its codes, two buffers of the tile's weight codes."""
    return (_round16(n_codes * n_codes * 2) + _round16(plane * cc * 4)
            + _round16(plane * cc) + 2 * _round16(taps * cc * bn))


def pick_tiled_kernel_tiling(c: int, ho: int, wo: int, cout: int, kh: int,
                             kw: int, sh: int, sw: int, dh: int, dw: int,
                             n_codes: int, *, bh: int = 0, bn: int = 0
                             ) -> TiledKernelTiling:
    """Kernel 6's tiling on this card, from its shared memory alone.

    The Cout tile is 32, 64 or 128 wide (``bn`` pins one of them): the one
    that pads Cout least, the widest on a tie. A tile has at most 64 output
    pixels (8 warps of 8), laid out as ``bh`` rows x ``bw`` columns;
    ``bh > 0`` pins the band height (clamped to 64 and Ho), otherwise the
    shape with the fewest tiles (every tile computes 64 pixels, the ones
    past the image or the tile's shape too), then the fewest halo'd input
    pixels staged, wins. The channel chunk is the fewest steps of a
    multiple of 4 channels, up to 64, whose band, codes and two weight
    buffers fit beside the 128 KiB table, evened out over the steps. Every
    choice gives the same bits."""
    if bn <= 0:
        bn = min(TILED_COUT_TILES, key=lambda t: (-(-cout // t) * t, -t))
    if bn not in TILED_COUT_TILES:
        raise ValueError(f"kernel 6's Cout tile is 32, 64 or 128, not {bn}")
    taps = kh * kw
    c4 = -(-c // 4) * 4
    if bh > 0:
        rows = min(bh, TILED_PIXELS, ho)
        shapes = [(rows, max(1, min(TILED_PIXELS // rows, wo)))]
    else:
        widths = sorted({min(b, wo) for b in (1, 2, 4, 8, 16, 32, 64)})
        shapes = [(min(TILED_PIXELS // b, ho), b) for b in widths]
    best = None
    for rows, cols in shapes:
        rows_in = (rows - 1) * sh + (kh - 1) * dh + 1
        cols_in = (cols - 1) * sw + (kw - 1) * dw + 1
        plane = rows_in * cols_in
        cc = min(c4, TILED_MAX_CHUNK)
        while cc > 4 and _tiled_smem(n_codes, plane, taps, cc, bn) \
                > SMEM_PER_BLOCK:
            cc -= 4
        if _tiled_smem(n_codes, plane, taps, cc, bn) > SMEM_PER_BLOCK:
            continue
        chunks = -(-c4 // cc)
        cc = -(-(c4 // 4) // chunks) * 4         # even the steps out
        th, tw = -(-ho // rows), -(-wo // cols)
        key = (th * tw, th * tw * plane, -cols)
        tiling = TiledKernelTiling(
            rows, cols, cc, bn, rows_in, cols_in,
            _tiled_smem(n_codes, plane, taps, cc, bn),
            th * tw * -(-cout // bn), c4, chunks)
        if best is None or key < best[0]:
            best = (key, tiling)
    if best is None:
        raise ValueError(
            f"kernel 6 cannot stage four channels of a {kh}x{kw} tap window "
            f"(dilation {dh}x{dw}) and its {bn}-wide weight codes beside the "
            f"table in {SMEM_PER_BLOCK} B of shared memory")
    return best[1]


# kernel 5's block: 8 warps of 8 output pixels (a 64-pixel tile), every
# lane TN output channels, or at Cout <= 16 one of 16 channels in one of
# two K slices (``lut_matmul.ref.lane_map``)
CONV_COUT_TILES = (128, 64, 32)
CONV_NARROW = 16


@dataclasses.dataclass(frozen=True)
class ConvKernelTiling:
    """Kernel 5's tiles. A work item is ``bh`` output rows x ``bw``
    output columns of one image x a ``bn``-wide Cout tile; it stages the
    halo'd band (``rows_in`` x ``cols_in`` input pixels) of ``cc``
    channels a step (a multiple of 4; the channels padded to ``c4``) as
    one-byte codes and walks its pixels in ``tile_px`` tiles of 64. An item
    of several pixel tiles holds every channel (``chunks`` 1); with one
    Cout tile too the weight codes stay resident (``wbufs`` 1), else two
    buffers stream them."""

    bh: int
    bw: int
    cc: int
    bn: int
    rows_in: int
    cols_in: int
    c4: int
    chunks: int
    tiles_h: int
    tiles_w: int
    tiles_n: int
    wbufs: int
    smem_bytes: int

    @property
    def tile_px(self) -> int:
        """64-pixel tiles of one item."""
        return -(-self.bh * self.bw // TILED_PIXELS)

    @property
    def ks(self) -> int:
        """K slices of a warp (2 at the 16-wide Cout tile)."""
        return 2 if self.bn == CONV_NARROW else 1

    @property
    def tn(self) -> int:
        """Output channels of one lane."""
        return self.bn * self.ks // 32

    def items(self, n: int) -> int:
        return n * self.tiles_h * self.tiles_w * self.tiles_n

    def describe(self, n: int) -> str:
        return (f"items of {self.bh} output rows x {self.bw} columns x "
                f"Cout tile {self.bn} ({self.tn} a lane, {self.ks} K "
                f"slice(s) a warp), {self.tile_px} pixel tile(s) of 64 an "
                f"item, {self.items(n)} items; channel chunk {self.cc} "
                f"({self.chunks} steps; {self.c4} channels with the pad), "
                f"band {self.rows_in} x {self.cols_in} input pixels, weight "
                f"codes {'resident' if self.wbufs == 1 else 'streamed'}, "
                f"{self.smem_bytes} B of shared memory")


def _conv_smem(n_codes: int, plane: int, taps: int, cc: int, bn: int,
               wbufs: int) -> int:
    """Dynamic shared memory of one kernel-5 block, as the source's
    ``Layout`` sizes it: the int16 table, one step's raw float band and its
    codes, the step's (tap, group of 4 channels) pairs (two ints each), one
    or two buffers of weight codes."""
    return (_round16(n_codes * n_codes * 2) + _round16(plane * cc * 4)
            + _round16(plane * cc) + _round16(taps * (cc // 4) * 8)
            + wbufs * _round16(taps * cc * bn))


def _conv_tiling(c4, ho, wo, cout, kh, kw, sh, sw, dh, dw, n_codes, bn, bh,
                 bw, cc):
    rows_in = (bh - 1) * sh + (kh - 1) * dh + 1
    cols_in = (bw - 1) * sw + (kw - 1) * dw + 1
    chunks = -(-c4 // cc)
    tiles_n = -(-cout // bn)
    wbufs = 1 if chunks == 1 and tiles_n == 1 else 2
    return ConvKernelTiling(
        bh, bw, cc, bn, rows_in, cols_in, c4, chunks, -(-ho // bh),
        -(-wo // bw), tiles_n, wbufs,
        _conv_smem(n_codes, rows_in * cols_in, kh * kw, cc, bn, wbufs))


@functools.lru_cache(maxsize=512)
def pick_conv_kernel_tiling(n: int, c: int, ho: int, wo: int, cout: int,
                            kh: int, kw: int, sh: int, sw: int, dh: int,
                            dw: int, n_codes: int, n_sm: int = 132
                            ) -> ConvKernelTiling:
    """Kernel 5's tiling on this card, from its shared memory and SMs.

    The Cout tile is 16 at Cout <= 16 (16 channels x 2 K slices a warp),
    else the one of 32, 64 and 128 that pads Cout least, the widest on a
    tie. Items are bands of whole output rows holding every channel when
    one fits: the band height with the fewest pixel tiles per SM (rounds
    of ``n_sm`` items x 64-pixel tiles an item), the tallest on a tie; a
    whole image at every ResNet-20 conv. When not even one row fits,
    items are single tiles of at most 64 pixels walked in channel steps,
    as kernel 6's (:func:`pick_tiled_kernel_tiling`'s choice of tile
    shape and step, on kernel 5's shared memory). Every choice gives the
    same bits."""
    bn = CONV_NARROW if cout <= CONV_NARROW else min(
        CONV_COUT_TILES, key=lambda t: (-(-cout // t) * t, -t))
    c4 = -(-c // 4) * 4
    best = None
    for bh in range(1, ho + 1):
        t = _conv_tiling(c4, ho, wo, cout, kh, kw, sh, sw, dh, dw, n_codes,
                         bn, bh, wo, c4)
        if t.smem_bytes > SMEM_PER_BLOCK:
            break
        key = (-(-t.items(n) // n_sm) * t.tile_px, -bh)
        if best is None or key < best[0]:
            best = (key, t)
    if best is not None:
        return best[1]
    widths = sorted({min(b, wo) for b in (1, 2, 4, 8, 16, 32, 64)})
    for rows, cols in [(min(TILED_PIXELS // b, ho), b) for b in widths]:
        cc = min(c4, TILED_MAX_CHUNK)
        while cc > 4 and _conv_tiling(c4, ho, wo, cout, kh, kw, sh, sw, dh,
                                      dw, n_codes, bn, rows, cols,
                                      cc).smem_bytes > SMEM_PER_BLOCK:
            cc -= 4
        chunks = -(-c4 // cc)
        cc = -(-(c4 // 4) // chunks) * 4         # even the steps out
        t = _conv_tiling(c4, ho, wo, cout, kh, kw, sh, sw, dh, dw, n_codes,
                         bn, rows, cols, cc)
        if t.smem_bytes > SMEM_PER_BLOCK:
            continue
        key = (t.tiles_h * t.tiles_w, t.tiles_h * t.tiles_w * t.rows_in
               * t.cols_in, -cols)
        if best is None or key < best[0]:
            best = (key, t)
    if best is None:
        raise ValueError(
            f"kernel 5 cannot stage four channels of a {kh}x{kw} tap window "
            f"(dilation {dh}x{dw}) and its {bn}-wide weight codes beside the "
            f"table in {SMEM_PER_BLOCK} B of shared memory")
    return best[1]


def check_conv_tiling(t: ConvKernelTiling, cout: int, kh: int, kw: int,
                      sh: int, sw: int, dh: int, dw: int,
                      n_codes: int) -> None:
    """Refuses what the launch refuses: a Cout tile other than 16, 32, 64
    and 128, a band that is not the tile's halo, shared memory not sized as
    the source's ``Layout`` (or over the block's limit), an item of several
    pixel tiles in channel steps, resident weight codes that would change
    between steps."""
    chunks, tiles_n = -(-t.c4 // t.cc), -(-cout // t.bn)
    ok = (t.bn in (CONV_NARROW,) + CONV_COUT_TILES and t.cc >= 4
          and t.cc % 4 == 0 and t.c4 >= 4 and t.c4 % 4 == 0
          and t.rows_in == (t.bh - 1) * sh + (kh - 1) * dh + 1
          and t.cols_in == (t.bw - 1) * sw + (kw - 1) * dw + 1
          and t.smem_bytes == _conv_smem(n_codes, t.rows_in * t.cols_in,
                                         kh * kw, t.cc, t.bn, t.wbufs)
          and t.smem_bytes <= SMEM_PER_BLOCK
          and not (t.tile_px > 1 and chunks > 1)
          and (t.wbufs == 2 or (t.wbufs == 1 and chunks == 1
                                and tiles_n == 1)))
    if not ok:
        raise ValueError(f"kernel 5 is not built for the tiling {t}")


def fused_lut_conv(x: torch.Tensor, wq: torch.Tensor, lut: torch.Tensor,
                   offset: int, x_scale, x_zp, w_scale, *, stride=(1, 1),
                   padding=((0, 0), (0, 0)), dilation=(1, 1), bits: int = 8,
                   emit_acc: bool = False,
                   tiling: Optional[ConvKernelTiling] = None
                   ) -> torch.Tensor:
    """Fused approximate conv2d forward (kernel 5).

    ``x``: (N, C, H, W) float32; ``wq``: (Cout, C, kh, kw) int32 shifted
    weight codes; ``lut``: the product table (int32, or the int16 table from
    :func:`runtime.lut_to_int16`); ``x_scale``/``x_zp``: per-tensor
    activation qparams; ``w_scale``: scalar or (Cout,) scales; ``padding``:
    explicit ((ph_lo, ph_hi), (pw_lo, pw_hi)). Returns (N, Ho, Wo, Cout)
    float32, or the raw int32 accumulator with ``emit_acc=True``.
    ``tiling`` launches the CUDA kernel with the one given, as given (a
    check's planted fault); it is refused (:func:`check_conv_tiling`) if
    the kernel is not built for it. Every tiling gives the same bits.
    """
    n_codes = int(round(lut.numel() ** 0.5))
    n, c, h, w_in = x.shape
    cout, cin, kh, kw = wq.shape
    if cin != c:
        raise ValueError(f"weight expects {cin} input channels, x has {c}")
    sh, sw = stride
    dh, dw = dilation
    (ph0, ph1), (pw0, pw1) = padding
    ho = conv_out_size(h, kh, sh, dh, (ph0, ph1))
    wo = conv_out_size(w_in, kw, sw, dw, (pw0, pw1))
    if tiling is not None:
        check_conv_tiling(tiling, cout, kh, kw, sh, sw, dh, dw, n_codes)
    if x.device.type == "cpu":
        return fused_lut_conv_ref(x, wq, lut.reshape(-1), offset, n_codes,
                                  x_scale, x_zp, w_scale, stride=stride,
                                  padding=padding, dilation=dilation,
                                  bits=bits, emit_acc=emit_acc)
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    out = torch.empty((n, max(ho, 0), max(wo, 0), cout), device=x.device,
                      dtype=torch.int32 if emit_acc else torch.float32)
    if out.numel() == 0:
        return out
    if out.numel() >= 2 ** 31:
        raise ValueError("conv output has too many elements for 32-bit "
                         "indices")
    blocks, stream = runtime.launch_config(x)
    if tiling is None:
        tiling = pick_conv_kernel_tiling(n, c, ho, wo, cout, kh, kw, sh, sw,
                                         dh, dw, n_codes, blocks)
    table = runtime.lut_to_int16(lut)
    x = x.contiguous()
    wcodes = tiled_weight_codes(wq, offset, n_codes, tiling.c4, tiling.bn)
    xs, xz, ws = scale_operands(x_scale, x_zp, w_scale, cout, x.device)
    for t, name, dt in ((x, "x", torch.float32), (wcodes, "wq", torch.uint8),
                        (table, "lut", torch.int16)):
        runtime.check_cuda_operand(t, name, dt, x.device)
    lib = runtime.kernel_library("fused_lut_conv")
    lib.check(lib.launch(x.data_ptr(), wcodes.data_ptr(), table.data_ptr(),
                         xs.data_ptr(), xz.data_ptr(), ws.data_ptr(),
                         out.data_ptr(), int(emit_acc), n, c, h, w_in, cout,
                         kh, kw, sh, sw, ph0, pw0, dh, dw, ho, wo, n_codes,
                         offset, lo, hi, tiling.bh, tiling.bw, tiling.cc,
                         tiling.bn, tiling.c4, wcodes.shape[2], tiling.wbufs,
                         tiling.smem_bytes, blocks, stream))
    fused_lut_conv.launches += 1
    return out


fused_lut_conv.launches = 0


def fused_lut_conv_tiled(x: torch.Tensor, wq: torch.Tensor,
                         lut: torch.Tensor, offset: int, x_scale, x_zp,
                         w_scale, *, stride=(1, 1),
                         padding=((0, 0), (0, 0)), dilation=(1, 1),
                         bits: int = 8, bh: int = 0, bn: int = 0,
                         emit_acc: bool = False,
                         tiling: Optional[TiledKernelTiling] = None
                         ) -> torch.Tensor:
    """Fused approximate conv2d forward over halo'd output-row bands
    (kernel 6): the reference's ``fused_lut_conv_tiled`` contract.

    Operands as :func:`fused_lut_conv`. Returns (N, Ho, Wo, Cout) float32,
    or the raw int32 accumulator with ``emit_acc=True``. ``bh > 0`` pins
    the band height and ``bn`` the Cout tile (32, 64 or 128); 0 takes
    :func:`pick_tiled_kernel_tiling`'s; ``tiling`` launches the CUDA
    kernel with the one given, as given (a check's planted fault). Every
    band height gives the same bits: integer sums do not depend on how the
    pixels are tiled.
    """
    n_codes = int(round(lut.numel() ** 0.5))
    n, c, h, w_in = x.shape
    cout, cin, kh, kw = wq.shape
    if cin != c:
        raise ValueError(f"weight expects {cin} input channels, x has {c}")
    sh, sw = stride
    dh, dw = dilation
    (ph0, ph1), (pw0, pw1) = padding
    ho = conv_out_size(h, kh, sh, dh, (ph0, ph1))
    wo = conv_out_size(w_in, kw, sw, dw, (pw0, pw1))
    if tiling is None:
        tiling = pick_tiled_kernel_tiling(c, max(ho, 1), max(wo, 1), cout,
                                          kh, kw, sh, sw, dh, dw, n_codes,
                                          bh=bh, bn=bn)
    if x.device.type == "cpu":
        return fused_lut_conv_tiled_ref(
            x, wq, lut.reshape(-1), offset, n_codes, x_scale, x_zp, w_scale,
            stride=stride, padding=padding, dilation=dilation, bits=bits,
            bh=tiling.bh, emit_acc=emit_acc)
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    table = runtime.lut_to_int16(lut)
    x = x.contiguous()
    wcodes = tiled_weight_codes(wq, offset, n_codes, tiling.c4, tiling.bn)
    xs, xz, ws = scale_operands(x_scale, x_zp, w_scale, cout, x.device)
    for t, name, dt in ((x, "x", torch.float32), (wcodes, "wq", torch.uint8),
                        (table, "lut", torch.int16)):
        runtime.check_cuda_operand(t, name, dt, x.device)
    out = torch.empty((n, max(ho, 0), max(wo, 0), cout), device=x.device,
                      dtype=torch.int32 if emit_acc else torch.float32)
    if out.numel() == 0:
        return out
    if out.numel() >= 2 ** 31:
        raise ValueError("conv output has too many elements for 32-bit "
                         "indices")
    lib = runtime.kernel_library("fused_lut_conv_tiled")
    blocks, stream = runtime.launch_config(x)
    lib.check(lib.launch(x.data_ptr(), wcodes.data_ptr(), table.data_ptr(),
                         xs.data_ptr(), xz.data_ptr(), ws.data_ptr(),
                         out.data_ptr(), int(emit_acc), n, c, h, w_in, cout,
                         kh, kw, sh, sw, ph0, pw0, dh, dw, ho, wo, n_codes,
                         offset, lo, hi, tiling.bh, tiling.bw, tiling.cc,
                         tiling.tn, tiling.c4, wcodes.shape[2],
                         tiling.smem_bytes, blocks, stream))
    fused_lut_conv_tiled.launches += 1
    return out


fused_lut_conv_tiled.launches = 0


# kernel 7's Cout tiles (the narrow-N lane map: two K slices at 16), row
# words a warp (4 (tap, channel) rows each: 9 for a 3x3 tap set), and the
# cost model's weights (SM cycles: a lookup issued by a warp, a quantized
# value, an atomic add of the output, an item's fixed work; bytes a cycle
# of one SM's share of HBM)
BWD_W_COUT_TILES = (16, 32, 64, 128)
BWD_W_ROW_WORDS = (9, 4)
_CYC_LOOKUP, _CYC_QUANT, _CYC_ATOMIC, _CYC_ITEM = 8, 0.2, 0.5, 600
_BYTES_CYC = 12.8


@dataclasses.dataclass(frozen=True)
class BwdWTiling:
    """Kernel 7's tiles. An item is ``bh`` output rows x ``bw`` output
    columns of one image (``tiles_h`` bands, ``tiles_w`` strips), ``cg``
    input channels (a multiple of 4; ``tiles_c`` groups over ``c4``) with
    all kh x kw taps, and a ``bn``-wide Cout tile (``tiles_n``). Its rows
    are (tap, channel) pairs listed as row words of 4 channels; each warp
    owns ``tw`` row words, ``wr`` warps across them and ``8 // wr`` across
    the item's groups of 4 pixels. ``rows_in`` x ``cols_in`` is the halo'd
    input band of one item."""

    bh: int
    bw: int
    tiles_h: int
    tiles_w: int
    cg: int
    c4: int
    tiles_c: int
    bn: int
    tiles_n: int
    tw: int
    wr: int
    rows_in: int
    cols_in: int
    smem_bytes: int

    @property
    def ks(self) -> int:
        """K (pixel) slices of a warp (2 at the 16-wide Cout tile)."""
        return lane_map(self.bn)[0]

    @property
    def tn(self) -> int:
        """Output channels of one lane."""
        return lane_map(self.bn)[1]

    @property
    def n_slices(self) -> int:
        """Pixel slices of an item: warps across the pixels x a warp's."""
        return (8 // self.wr) * self.ks

    def items(self, n: int) -> int:
        return n * self.tiles_h * self.tiles_w * self.tiles_c * self.tiles_n

    def n_sets(self, taps: int) -> int:
        """Row-word sets of ``tw`` over an item's taps x cg / 4 words."""
        return -(-(taps * self.cg // 4) // self.tw)

    def describe(self, n: int, n_sm: int = 132) -> str:
        return (f"items of {self.bh} output rows x {self.bw} columns x "
                f"{self.cg} channels x Cout tile {self.bn} ({self.tn} a lane, "
                f"{self.ks} pixel slice(s) a warp), {self.items(n)} items "
                f"({self.items(n) / n_sm:.2f} an SM), {self.tw} row words a "
                f"warp on {self.wr} warp(s) x {8 // self.wr} across the "
                f"pixels, band {self.rows_in} x {self.cols_in} input pixels, "
                f"{self.smem_bytes} B of shared memory")


def _bwd_w_smem(n_codes: int, plane: int, cg: int, pgroups: int, bn: int,
                n_sets: int, tw: int) -> int:
    """Dynamic shared memory of one kernel-7 block, as the source's
    ``Layout`` sizes it: the int16 table, the raw band and raw gradient
    slice (float32), the band's and the gradient's one-byte codes, each
    pixel's band offset, the row list (16 bytes a row word)."""
    px = 4 * pgroups
    return (_round16(n_codes * n_codes * 2) + _round16(plane * cg * 4)
            + _round16(px * bn * 4) + _round16(plane * cg)
            + _round16(pgroups * bn * 4) + _round16(px * 4)
            + _round16(n_sets * tw * 16))


def bwd_w_tiling_for(c4, ho, wo, cout, kh, kw, sh, sw, dh, dw, n_codes,
                     bh, bw, cg, bn, tw) -> BwdWTiling:
    """Kernel 7's tiling at a given item (``bh`` x ``bw`` output pixels,
    ``cg`` channels), Cout tile and row words a warp, with the most warps
    across the row words (1, 2, 4 or 8) that its sets fill."""
    taps = kh * kw
    rows_in = (bh - 1) * sh + (kh - 1) * dh + 1
    cols_in = (bw - 1) * sw + (kw - 1) * dw + 1
    n_sets = -(-(taps * cg // 4) // tw)
    wr = 1 << (min(8, n_sets).bit_length() - 1)
    return BwdWTiling(
        bh, bw, -(-ho // bh), -(-wo // bw), cg, c4, -(-c4 // cg),
        bn, -(-cout // bn), tw, wr, rows_in, cols_in,
        _bwd_w_smem(n_codes, rows_in * cols_in, cg, -(-bh * bw // 4), bn,
                    n_sets, tw))


@functools.lru_cache(maxsize=512)
def pick_bwd_w_tiling(n: int, c: int, ho: int, wo: int, cout: int, kh: int,
                      kw: int, sh: int, sw: int, dh: int, dw: int,
                      n_codes: int, n_sm: int = 132) -> BwdWTiling:
    """Kernel 7's tiling on this card, from its shared memory and SMs.

    The Cout tile is the narrowest of 16, 32, 64 and 128 that holds Cout
    (128-wide tiles past 128). Row words a warp: 9 or 4 (4 at 128
    columns), the one that leaves fewer dead words, 9 on a tie; ``wr``
    warps across the row words, the most of 1, 2, 4, 8 that the sets
    fill. Over channel groups (all channels, then halves while a multiple
    of 4), column strips (whole rows, then halves) and band heights, the
    tiling whose shared memory fits and whose rounds of items over the SMs
    cost least (per item the larger of its gathers and its copy, plus its
    quantization, its atomic adds into the output and a fixed cost) wins, among those that give every SM at
    least two items where any does; a taller band, then a wider strip and
    more channels, on a tie. Every choice gives the same bits."""
    bn = next((t for t in BWD_W_COUT_TILES if cout <= t), 128)
    ks, tn = lane_map(bn)[:2]
    c4 = -(-c // 4) * 4
    taps = kh * kw
    cgs = [c4]
    while cgs[-1] % 8 == 0:
        cgs.append(cgs[-1] // 2)
    bws = [wo]
    while bws[-1] > 4:
        bws.append(-(-bws[-1] // 2))
    best = None
    for cg in cgs:
        words = taps * cg // 4
        tw = 4 if bn == 128 else min(
            BWD_W_ROW_WORDS, key=lambda t: (-(-words // t) * t, -t))
        for bw in bws:
            for bh in range(1, ho + 1):
                t = bwd_w_tiling_for(c4, ho, wo, cout, kh, kw, sh, sw, dh,
                                     dw, n_codes, bh, bw, cg, bn, tw)
                if t.smem_bytes > SMEM_PER_BLOCK:
                    break
                pg = -(-bh * bw // 4)
                n_sets = t.n_sets(taps)
                passes = -(-n_sets // t.wr)
                gather = (passes * -(-pg // (8 // t.wr * ks)) * 16 * t.tw
                          * tn * _CYC_LOOKUP)
                plane = t.rows_in * t.cols_in
                copy = (plane * cg + 4 * pg * bn) * 4 / _BYTES_CYC
                quant = (plane * cg + 4 * pg * bn) * _CYC_QUANT
                atomics = taps * cg * min(bn, cout) * (8 // t.wr)
                items = t.items(n)
                cost = -(-items // n_sm) * (max(gather, copy) + quant
                                            + atomics * _CYC_ATOMIC
                                            + _CYC_ITEM)
                key = (items < 2 * n_sm, cost, -bh, -bw, -cg)
                if best is None or key < best[0]:
                    best = (key, t)
    if best is None:
        raise ValueError(
            f"kernel 7 cannot stage four channels of a {kh}x{kw} tap window "
            f"(dilation {dh}x{dw}) of a {wo}-wide row beside the table in "
            f"{SMEM_PER_BLOCK} B of shared memory")
    return best[1]


def check_bwd_w_tiling(t: BwdWTiling, c: int, ho: int, wo: int, cout: int,
                       kh: int, kw: int, sh: int, sw: int, dh: int, dw: int,
                       n_codes: int) -> None:
    """Refuses what the launch refuses: a Cout tile other than 16, 32, 64
    and 128, row words other than 9 or 4 (4 at 128 columns), warps across
    them other than 1, 2, 4, 8, channel groups not a multiple of 4, a band
    that is not the item's halo, a strip wider than the image, shared
    memory not sized as the source's ``Layout`` (or over the block's
    limit). A tiling that leaves bands out is well formed and runs."""
    taps = kh * kw
    ok = (t.bn in BWD_W_COUT_TILES and t.tw in BWD_W_ROW_WORDS
          and not (t.tw == 9 and t.bn == 128) and t.wr in (1, 2, 4, 8)
          and t.cg >= 4 and t.cg % 4 == 0 and t.c4 >= 4 and t.c4 % 4 == 0
          and t.tiles_c == -(-t.c4 // t.cg) and t.tiles_n == -(-cout // t.bn)
          and 1 <= t.bw <= wo and t.tiles_w == -(-wo // t.bw)
          and t.bh >= 1 and t.tiles_h >= 1
          and t.rows_in == (t.bh - 1) * sh + (kh - 1) * dh + 1
          and t.cols_in == (t.bw - 1) * sw + (kw - 1) * dw + 1
          and t.smem_bytes == _bwd_w_smem(
              n_codes, t.rows_in * t.cols_in, t.cg, -(-t.bh * t.bw // 4),
              t.bn, t.n_sets(taps), t.tw)
          and t.smem_bytes <= SMEM_PER_BLOCK)
    if not ok:
        raise ValueError(f"kernel 7 is not built for the tiling {t}")


def fused_lut_conv_bwd_w(x: torch.Tensor, g: torch.Tensor, lut: torch.Tensor,
                         offset: int, x_scale, g_scale, *,
                         ksize: tuple[int, int], stride=(1, 1),
                         padding=((0, 0), (0, 0)), dilation=(1, 1),
                         bits: int = 8,
                         tiling: Optional[BwdWTiling] = None,
                         rmask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Approximate conv weight gradient (kernel 7, the ApproxTrain regime).

    ``x``: (N, C, H, W) float residual (the saved fake-quantized input);
    ``g``: (N, Ho, Wo, Cout) float incoming gradient, the fused forward's
    output layout; ``x_scale`` / ``g_scale``: per-tensor symmetric scales
    the caller computed on the full tensors. Both are quantized in-kernel,
    ``clip(round(v / s))``; an out-of-image tap is code 0 and contributes
    ``LUT[off, qg + off]``, as the reference's quantized 0.0 pad does.
    Returns the raw int32 (kh*kw, C, Cout) tap-major accumulator; the
    caller dequants once, ``acc * (sx * sg)``. ``tiling`` launches the
    CUDA kernel with the one given, as given (a check's planted fault); it
    is refused (:func:`check_bwd_w_tiling`) if the kernel is not built for
    it. Every tiling gives the same bits. ``rmask`` (N, Ho), 0/1: an
    output row whose entry is 0 is left out of the sum (zeroing its
    gradient would not do: a zero code still adds ``LUT[qx + off, off]``);
    counted by ``fused_lut_conv_bwd_w.rmask_launches`` beside
    ``launches``.
    """
    n_codes = int(round(lut.numel() ** 0.5))
    n, c, h, w_in = x.shape
    cout = g.shape[3]
    kh, kw = ksize
    sh, sw = stride
    dh, dw = dilation
    (ph0, ph1), (pw0, pw1) = padding
    ho = conv_out_size(h, kh, sh, dh, (ph0, ph1))
    wo = conv_out_size(w_in, kw, sw, dw, (pw0, pw1))
    if tuple(g.shape) != (n, ho, wo, cout):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected "
                         f"{(n, ho, wo, cout)} for this geometry")
    if tiling is not None:
        check_bwd_w_tiling(tiling, c, ho, wo, cout, kh, kw, sh, sw, dh, dw,
                           n_codes)
    if rmask is not None and tuple(rmask.shape) != (n, ho):
        raise ValueError(f"rmask has shape {tuple(rmask.shape)}, expected "
                         f"{(n, ho)}")
    if x.device.type == "cpu":
        return fused_lut_conv_bwd_w_ref(
            x, g, lut.reshape(-1), offset, n_codes, x_scale, g_scale,
            ksize=ksize, stride=stride, padding=padding, dilation=dilation,
            bits=bits, rmask=rmask)
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    table = runtime.lut_to_int16(lut)
    x = x.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    f = dict(dtype=torch.float32, device=x.device)
    sx = torch.as_tensor(x_scale, **f).reshape(1).contiguous()
    sg = torch.as_tensor(g_scale, **f).reshape(1).contiguous()
    if rmask is not None:
        rmask = rmask.to(device=x.device, dtype=torch.int32).contiguous()
    for t, name, dt in ((x, "x", torch.float32), (g, "g", torch.float32),
                        (table, "lut", torch.int16)) + (
                            () if rmask is None else
                            ((rmask, "rmask", torch.int32),)):
        runtime.check_cuda_operand(t, name, dt, x.device)
    # items add their partial sums into it
    out = torch.zeros((kh * kw, c, cout), device=x.device, dtype=torch.int32)
    if g.numel() == 0 or out.numel() == 0:
        return out
    blocks, stream = runtime.launch_config(x)
    if tiling is None:
        tiling = pick_bwd_w_tiling(n, c, ho, wo, cout, kh, kw, sh, sw, dh, dw,
                                   n_codes, blocks)
    t = tiling
    lib = runtime.kernel_library("fused_lut_conv_bwd_w")
    lib.check(lib.launch(x.data_ptr(), g.data_ptr(), table.data_ptr(),
                         sx.data_ptr(), sg.data_ptr(),
                         None if rmask is None else rmask.data_ptr(),
                         out.data_ptr(), n, c, h, w_in, cout, kh, kw, sh, sw,
                         ph0, pw0, dh, dw, ho, wo, n_codes, offset, lo, hi,
                         t.bh, t.bw, t.tiles_h, t.cg, t.c4, t.bn, t.tw, t.wr,
                         t.smem_bytes, blocks, stream))
    fused_lut_conv_bwd_w.launches += 1
    if rmask is not None:
        fused_lut_conv_bwd_w.rmask_launches += 1
    return out


fused_lut_conv_bwd_w.launches = 0
fused_lut_conv_bwd_w.rmask_launches = 0
