"""Public wrappers of the fused dense kernels: the forward
(kernel 3, ``csrc/fused_lut_dense.cu``) and the approximate STE gradient
GEMM (kernel 4, ``csrc/fused_lut_bwd.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py``. Nothing is padded in memory; the forward kernel
pads the last group of 4 K slots with offset codes and subtracts
``pad * LUT[off, off]`` itself.

Both kernels run a work plan made here: the tile shape, and for each
persistent block its list of segments (output tile, K range, workspace
slot): :func:`dense_plan` for the forward, :func:`bwd_plan` for the
backward, whose items are a row tile with every column tile of N where B's
codes stay resident. The CPU tests hold the same plans against the plain
versions (``ref.fused_lut_dense_plan_ref``, ``ref.fused_lut_bwd_plan_ref``)
that the card runs.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.lut_matmul.ref import lane_map
from .ref import fused_lut_bwd_ref, fused_lut_dense_ref

DENSE_KG = 4        # K slots in one group: the unit of a segment's K range


@dataclass(frozen=True, eq=False)
class DensePlan:
    """Kernel 3's work plan for one (M, K, N) on ``n_sm`` SMs.

    A block has 8 warps: ``wm`` of them across the tile's rows (``tm``
    rows each, ``bm = tm * wm``) and ``8 // wm`` across each K chunk; a
    warp's 32 lanes hold ``tn`` columns each (``bn = 32 * tn``). Tiles are
    numbered row-major (``tiles_n`` per row band); K is cut into
    ``groups`` groups of 4. ``segments`` is an (S, 4) int32 array of
    (tile, first group, end group, slot), block ``b`` running rows
    ``offsets[b]:offsets[b + 1]`` in order. A segment that covers all of
    its tile's groups has slot -1 and stores the tile; the others add
    into workspace slot ``slot`` (``bm * bn`` int32 sums, then one
    arrival counter per slot)."""
    M: int
    K: int
    N: int
    tm: int
    tn: int
    wm: int
    tiles_m: int
    tiles_n: int
    groups: int
    offsets: tuple
    segments: np.ndarray
    n_slots: int

    @property
    def bm(self) -> int:
        return self.tm * self.wm

    @property
    def bn(self) -> int:
        return 32 * self.tn

    @property
    def grid(self) -> int:
        return len(self.offsets) - 1

    @property
    def slot_elems(self) -> int:
        return self.bm * self.bn

    def summary(self) -> dict:
        """What a report prints: the tile, the items (segments), the most
        segments on one tile (splits), the SMs with work, and the tile rows
        past M (the kernel's warps skip them: none gathers for a row past
        M)."""
        per_tile = np.bincount(self.segments[:, 0],
                               minlength=self.tiles_m * self.tiles_n)
        return dict(tile=f"{self.bm}x{self.bn}", items=len(self.segments),
                    splits=int(per_tile.max()), sms=self.grid,
                    rows_past_m=self.tiles_m * self.bm - self.M)


def dense_tile(M: int, K: int, N: int, n_sm: int) -> tuple[int, int, int]:
    """(tm, wm, tn): rows per warp, warps across rows, columns per lane.
    The row tile is the smallest of 1, 2, 4, 8, 16 and 32 rows that holds
    M (64 from M = 64 on), so that no warp gathers for a row past M at M
    up to 32. The column tile, 128 or 256, is the one that pads N least
    (256 on a tie), except that 128 is taken when 256-column tiles would
    leave each SM's share of K under 128: many short K splits of a few
    tiles cost more in their atomic sums and per-segment work than twice
    the tiles of half the width."""
    if M >= 64:
        tm, wm = 8, 8
    elif M > 16:
        tm, wm = 4, 8
    elif M > 2:
        tm = 4
        wm = max(1, -(-M // tm))
        wm = 1 << (wm - 1).bit_length()           # 1, 2 or 4 warps
    else:
        tm, wm = max(M, 1), 1
    tn = min((8, 4), key=lambda t: (-(-N // (32 * t)) * 32 * t, -t))
    tiles = -(-M // (tm * wm)) * -(-N // 256)
    if tn == 8 and tiles < n_sm and K * tiles < 128 * n_sm:
        tn = 4
    return tm, wm, tn


def stream_k(n_tiles: int, groups: int, n_sm: int
             ) -> tuple[tuple, np.ndarray, int]:
    """The segments each persistent block runs over ``n_tiles`` output
    tiles of ``groups`` K groups on ``n_sm`` SMs: (offsets, segments,
    n_slots), as :class:`DensePlan` holds them. Whole tiles go round-robin
    while at least two rounds of them remain; the rest (all of them when
    there are fewer tiles than SMs) is cut along K into ``n_sm`` equal runs
    of groups over the tiles in order (stream-K), so that every SM gets the
    same share. A run may end or start inside a tile: those tiles get a
    workspace slot. Kernels 1 and 3 run it."""
    whole = n_tiles if n_tiles % n_sm == 0 else \
        max(0, n_tiles // n_sm - 1) * n_sm
    rest = n_tiles - whole
    total = rest * groups
    grid = n_sm if n_tiles >= n_sm else max(1, min(n_sm, total))
    per_block = [[(t, 0, groups) for t in range(b, whole, grid)]
                 for b in range(grid)]
    for b in range(grid):
        it, it1 = b * total // grid, (b + 1) * total // grid
        while it < it1:
            t, g0 = divmod(it, groups)
            g1 = min(groups, g0 + it1 - it)
            per_block[b].append((whole + t, g0, g1))
            it += g1 - g0
    split = sorted({t for segs in per_block for t, g0, g1 in segs
                    if (g0, g1) != (0, groups)})
    slot_of = {t: i for i, t in enumerate(split)}
    rows, offsets = [], [0]
    for segs in per_block:
        rows += [(t, g0, g1, slot_of.get(t, -1)) for t, g0, g1 in segs]
        offsets.append(len(rows))
    segments = np.asarray(rows, dtype=np.int32).reshape(-1, 4)
    segments.setflags(write=False)
    return tuple(offsets), segments, len(split)


@functools.lru_cache(maxsize=512)
def dense_plan(M: int, K: int, N: int, n_sm: int) -> DensePlan:
    """Kernel 3's tile (:func:`dense_tile`) and the segments each of
    ``n_sm`` persistent blocks runs (:func:`stream_k`)."""
    tm, wm, tn = dense_tile(M, K, N, n_sm)
    bm, bn = tm * wm, 32 * tn
    tiles_m, tiles_n = -(-M // bm), -(-N // bn)
    groups = -(-K // DENSE_KG)
    offsets, segments, n_slots = stream_k(tiles_m * tiles_n, groups, n_sm)
    return DensePlan(M, K, N, tm, tn, wm, tiles_m, tiles_n, groups,
                     offsets, segments, n_slots)


@functools.lru_cache(maxsize=512)
def _device_plan(plan: DensePlan, device: torch.device) -> torch.Tensor:
    """The plan as the kernel reads it: ``offsets`` then the segments, one
    int32 tensor on ``device``, uploaded once per plan and device."""
    flat = np.concatenate([np.asarray(plan.offsets, np.int32),
                           plan.segments.reshape(-1)])
    return torch.from_numpy(flat).to(device)


def scale_operands(x_scale, x_zp, w_scale, n: int, device):
    """The scales as the kernels read them: shape-(1,) activation scale and
    zero-point, (N,) per-output-channel weight scale, float32, on
    ``device``."""
    f = dict(dtype=torch.float32, device=device)
    xs = torch.as_tensor(x_scale, **f).reshape(1).contiguous()
    xz = torch.as_tensor(x_zp, **f).reshape(1).contiguous()
    ws = torch.as_tensor(w_scale, **f).reshape(-1).expand(n).contiguous()
    return xs, xz, ws


def fused_lut_dense(x: torch.Tensor, wq: torch.Tensor, lut: torch.Tensor,
                    offset: int, x_scale, x_zp, w_scale, *, bits: int = 8,
                    emit_acc: bool = False) -> torch.Tensor:
    """Fused approximate dense forward.

    ``x``: (M, K) float activations (bfloat16 is widened to float32
    first, an exact conversion, as the reference's kernel does in-kernel);
    ``wq``: (K, N) int32 shifted weight
    codes; ``lut``: the product table (int32, or int16 from
    :func:`runtime.lut_to_int16`); ``x_scale``/``x_zp``: per-tensor
    activation qparams; ``w_scale``: scalar or (N,) weight scales; ``bits``:
    the activation code width (clip range). Returns (M, N) float32, or the
    raw int32 accumulator with ``emit_acc=True``.
    """
    n_codes = int(round(lut.numel() ** 0.5))
    M, K = x.shape
    K2, N = wq.shape
    if K2 != K:
        raise ValueError(f"inner dims differ: x {tuple(x.shape)}, "
                         f"wq {tuple(wq.shape)}")
    if x.device.type == "cpu":
        return fused_lut_dense_ref(x, wq, lut.reshape(-1), offset, n_codes,
                                   x_scale, x_zp, w_scale, bits=bits,
                                   emit_acc=emit_acc)
    if x.device.type == "meta":
        runtime.count_work("fused_lut_dense", lookups=M * K * N,
                           bytes_=runtime.nbytes(x, wq, x_scale, x_zp,
                                                 w_scale)
                           + n_codes ** 2 * 2 + M * N * 4)
        return runtime.meta_empty(
            M, N, dtype=torch.int32 if emit_acc else torch.float32)
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), device=x.device,
                           dtype=torch.int32 if emit_acc else torch.float32)
    blocks, _ = runtime.launch_config(x)
    return fused_lut_dense_planned(x, wq, lut, offset, x_scale, x_zp,
                                   w_scale, plan=dense_plan(M, K, N, blocks),
                                   bits=bits, emit_acc=emit_acc)


fused_lut_dense.launches = 0


def fused_lut_dense_planned(x: torch.Tensor, wq: torch.Tensor,
                            lut: torch.Tensor, offset: int, x_scale, x_zp,
                            w_scale, *, plan: DensePlan, bits: int = 8,
                            emit_acc: bool = False) -> torch.Tensor:
    """Launch kernel 3 on CUDA operands with the given work plan (the one
    :func:`fused_lut_dense` makes, or another for a test) and add one to
    ``fused_lut_dense.launches``."""
    n_codes = int(round(lut.numel() ** 0.5))
    M, K = x.shape
    N = wq.shape[1]
    if (plan.M, plan.K, plan.N) != (M, K, N):
        raise ValueError(f"plan is for {(plan.M, plan.K, plan.N)}, the "
                         f"operands are {(M, K, N)}")
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    table = runtime.lut_to_int16(lut)
    x = x.to(torch.float32).contiguous()
    wq = wq.contiguous()
    xs, xz, ws = scale_operands(x_scale, x_zp, w_scale, N, x.device)
    for t, name, dt in ((x, "x", torch.float32), (wq, "wq", torch.int32),
                        (table, "lut", torch.int16)):
        runtime.check_cuda_operand(t, name, dt, x.device)
    out = torch.empty((M, N), device=x.device,
                      dtype=torch.int32 if emit_acc else torch.float32)
    # split tiles' sums and arrival counters, zeroed; none when no tile is
    # split
    work = (torch.zeros if plan.n_slots else torch.empty)(
        max(1, plan.n_slots * (plan.slot_elems + 1)), dtype=torch.int32,
        device=x.device)
    lib = runtime.kernel_library("fused_lut_dense")
    _, stream = runtime.launch_config(x)
    lib.check(lib.launch(x.data_ptr(), wq.data_ptr(), table.data_ptr(),
                         xs.data_ptr(), xz.data_ptr(), ws.data_ptr(),
                         out.data_ptr(), int(emit_acc), M, K, N, n_codes,
                         offset, lo, hi,
                         _device_plan(plan, x.device).data_ptr(), plan.grid,
                         plan.tm, plan.tn, plan.wm, plan.tiles_n, plan.groups,
                         work.data_ptr(), plan.n_slots, stream))
    fused_lut_dense.launches += 1
    return out


# kernel 4 (fused_lut_bwd): column tiles on the narrow-N lane map (16 for
# N <= 16), K chunks of at most 64 (one chunk, and the item several column
# tiles, where B stays resident), else chunks of 32 with B staged per
# column tile; rows 8 warps x 4, 8 or 16 (16 at up to 64 columns)
BWD_COL_TILES = (256, 128, 64, 32)
BWD_ROWS = (16, 8, 4)
BWD_MAX_CHUNK = 64
BWD_CHUNK = 32
# the plan's cost model, in issued instructions: quantizing one value, an
# item's fixed work (its syncs, copies and stores)
_QUANT_COST, _ITEM_COST = 20, 20000
SMEM_PER_BLOCK = 232_448     # the H100's opt-in shared memory of a block


def _round16(n: int) -> int:
    return (n + 15) & ~15


def _raw_stride(kc: int) -> int:
    """Floats of one staged A row (``raw_stride`` in the source): ``kc``
    and a pad to an odd number of 16-byte words (conflict-free float4
    reads of 8 rows)."""
    return kc + 4 * (1 + (kc // 4) % 2)


def _bwd_smem(n_codes: int, tm: int, bn: int, kc: int, resident: bool,
              groups: int, tiles_n: int) -> int:
    """Dynamic shared memory of one kernel-4 block, as the source's
    ``Layout`` sizes it: the int16 table, two raw A buffers and A's codes,
    B's codes (resident over all of K and N, or one chunk's with two raw
    buffers), the warps' turn-round buffers (fewer than 4 columns a lane),
    the completion flag."""
    bm = 8 * tm
    tn = lane_map(bn)[1]
    b = (_round16(groups * tiles_n * bn * 4) if resident else
         2 * _round16(kc * bn * 4) + _round16(kc // 4 * bn * 4))
    return (_round16(n_codes * n_codes * 2)
            + 2 * _round16(bm * _raw_stride(kc) * 4)
            + _round16(kc // 4 * bm * 4) + b
            + (8 * _round16(tm * bn * 4) if tn < 4 else 0) + 16)


@dataclass(frozen=True, eq=False)
class BwdPlan:
    """Kernel 4's work plan for one (M, K, N) on ``n_sm`` SMs.

    A block has 8 warps across the row tile (``tm`` rows each, ``bm = 8 *
    tm``); a warp's lanes hold a ``bn``-column tile on the narrow-N lane
    map (``lut_matmul.ref.lane_map``: at 16 columns, N <= 16, two K
    slices). K runs
    in chunks of ``kc`` (a multiple of 4) over ``groups`` groups of 4. An
    item (a plan "tile") is one row tile with ``nt`` column tiles, numbered
    row tile major over ``tiles_c`` column groups: with ``nt`` > 1 every
    column tile of N, walked after A's codes are quantized once, which
    needs the whole of K in one chunk. ``resident``: B's codes are
    quantized once per block and kept. ``segments`` is an (S, 4) int32
    array of (tile, first group, end group, slot), block ``b`` running rows
    ``offsets[b]:offsets[b + 1]``; slot -1 stores its item, the others add
    into workspace slot ``slot`` (``bm * nt * bn`` int32 sums, then one
    arrival counter per slot)."""
    M: int
    K: int
    N: int
    tm: int
    bn: int
    kc: int
    nt: int
    resident: bool
    tiles_m: int
    tiles_n: int
    tiles_c: int
    groups: int
    offsets: tuple
    segments: np.ndarray
    n_slots: int
    smem_bytes: int

    @property
    def bm(self) -> int:
        return 8 * self.tm

    @property
    def ks(self) -> int:
        """K slices of one warp (2 at 16 columns)."""
        return lane_map(self.bn)[0]

    @property
    def tn(self) -> int:
        """Columns of one lane."""
        return lane_map(self.bn)[1]

    @property
    def grid(self) -> int:
        return len(self.offsets) - 1

    @property
    def slot_elems(self) -> int:
        return self.bm * self.nt * self.bn

    def summary(self) -> dict:
        """What a report prints: the row tile x the columns of one item,
        the column tile, the K chunk, whether B is resident, the items
        (segments), the most segments on one item (splits), the SMs with
        work, the fewest items on one of them, the shared memory."""
        per_tile = np.bincount(self.segments[:, 0],
                               minlength=self.tiles_m * self.tiles_c)
        per_sm = np.diff(np.asarray(self.offsets))
        return dict(item=f"{self.bm}x{self.nt * self.bn}",
                    col_tile=self.bn, kc=self.kc, resident=self.resident,
                    items=len(self.segments), splits=int(per_tile.max()),
                    sms=self.grid, min_items_per_sm=int(per_sm.min()),
                    smem=self.smem_bytes)

    def describe(self) -> str:
        sm = self.summary()
        return (f"items of {self.bm} rows x {self.nt} column tile(s) of "
                f"{self.bn} ({self.tn} a lane, {self.ks} K slice(s) a "
                f"warp), K in chunks of {self.kc}, B "
                f"{'resident' if self.resident else 'staged per item'}; "
                f"{sm['items']} segments on {sm['sms']} SMs (at least "
                f"{sm['min_items_per_sm']} each, at most {sm['splits']} on "
                f"one item), {self.smem_bytes} B of shared memory")


def _lookup_cost(bn: int) -> float:
    """Issue cost of one lookup at ``bn``'s columns per lane: an address,
    a gather and an add, and a row code's byte extract shared by the
    lane's columns."""
    return 3 + 1 / lane_map(bn)[1]


def _whole_tiles(n_tiles: int, groups: int, n_sm: int
                 ) -> tuple[tuple, np.ndarray, int]:
    """Whole items round-robin over ``min(n_tiles, n_sm)`` blocks, as
    :func:`stream_k` lays them out, with no slot."""
    grid = min(n_tiles, n_sm)
    rows, offsets = [], [0]
    for b in range(grid):
        rows += [(t, 0, groups, -1) for t in range(b, n_tiles, grid)]
        offsets.append(len(rows))
    segments = np.asarray(rows, dtype=np.int32).reshape(-1, 4)
    segments.setflags(write=False)
    return tuple(offsets), segments, 0


def bwd_plan_for(M: int, K: int, N: int, n_sm: int, tm: int, bn: int,
                 nt: int, n_codes: int = 256) -> BwdPlan:
    """Kernel 4's plan at a given row tile (``tm`` rows a warp), column
    tile ``bn`` and ``nt`` column tiles an item (1 unless K is one chunk
    and B resident): items round-robin, whole, when there are at least as
    many as SMs and K is one chunk; otherwise stream-K
    (:func:`stream_k`) splits them along K."""
    groups = -(-K // DENSE_KG)
    tiles_n = -(-N // bn)
    one_chunk = 4 * groups <= BWD_MAX_CHUNK
    kc = 4 * groups if one_chunk else BWD_CHUNK
    resident = _bwd_smem(n_codes, 8, bn, kc, True, groups,
                         tiles_n) <= SMEM_PER_BLOCK
    nt = min(nt, tiles_n) if one_chunk and resident else 1
    tiles_c = -(-tiles_n // nt)
    tiles_m = -(-M // (8 * tm))
    n_tiles = tiles_m * tiles_c
    if one_chunk and n_tiles >= n_sm:
        offsets, segments, n_slots = _whole_tiles(n_tiles, groups, n_sm)
    else:
        offsets, segments, n_slots = stream_k(n_tiles, groups, n_sm)
    return BwdPlan(M, K, N, tm, bn, kc, nt, resident, tiles_m, tiles_n,
                   tiles_c, groups, offsets, segments, n_slots,
                   _bwd_smem(n_codes, tm, bn, kc, resident, groups,
                             tiles_n))


@functools.lru_cache(maxsize=512)
def bwd_plan(M: int, K: int, N: int, n_sm: int, n_codes: int = 256
             ) -> BwdPlan:
    """Kernel 4's plan (:func:`bwd_plan_for`). The column tile is 16 at N
    <= 16, else the one of 32..256 that costs least for N (padded columns
    times :func:`_lookup_cost`; the widest on a tie). K of at most 64 is
    one chunk; then B's codes stay resident where they fit beside the
    table and an item is a row tile with ``nt`` column tiles, all of N's
    or a share of them. Rows: 8 warps of 16 (up to 64 columns), 8 or 4.
    Of those (rows, ``nt``) whose shared memory fits, the one whose rounds
    of items over the SMs cost least (rounds x an item's lookups at their
    lookup cost, plus quantizing its A rows and a fixed cost) wins, among
    those that give every SM an item where any does (so that no item is
    split along K); the larger item on a tie."""
    bn = 16 if N <= 16 else min(
        BWD_COL_TILES, key=lambda b: (-(-N // b) * b * _lookup_cost(b), -b))
    groups = -(-K // DENSE_KG)
    tiles_n = -(-N // bn)
    one_chunk = 4 * groups <= BWD_MAX_CHUNK
    kc = 4 * groups if one_chunk else BWD_CHUNK
    resident = _bwd_smem(n_codes, 8, bn, kc, True, groups,
                         tiles_n) <= SMEM_PER_BLOCK
    nts = sorted({-(-tiles_n // d) for d in range(1, tiles_n + 1)}) \
        if one_chunk and resident else [1]

    def key(shape):
        tm, nt = shape
        items = -(-M // (8 * tm)) * -(-tiles_n // nt)
        item = 8 * tm * K * (nt * bn * _lookup_cost(bn) + _QUANT_COST)
        return (items < n_sm, -(-items // n_sm) * (item + _ITEM_COST),
                -tm * nt)

    shapes = [(tm, nt) for tm in BWD_ROWS for nt in nts
              if (tm < 16 or bn <= 64) and _bwd_smem(
                  n_codes, tm, bn, kc, resident, groups, tiles_n)
              <= SMEM_PER_BLOCK]
    tm, nt = min(shapes, key=key)
    return bwd_plan_for(M, K, N, n_sm, tm, bn, nt, n_codes)


def check_bwd_plan(plan: BwdPlan, M: int, K: int, N: int,
                   n_codes: int) -> None:
    """Refuses what the launch refuses: a plan for other operands, a tile
    the kernel has no instance of, a chunk past 64 or not a multiple of 4,
    several column tiles an item over more than one chunk of K, shared
    memory not sized as the source's ``Layout`` (or over the block's
    limit)."""
    if (plan.M, plan.K, plan.N) != (M, K, N):
        raise ValueError(f"plan is for {(plan.M, plan.K, plan.N)}, the "
                         f"operands are {(M, K, N)}")
    ok = (plan.tm in BWD_ROWS and (plan.tm < 16 or plan.bn <= 64)
          and plan.bn in (16,) + BWD_COL_TILES
          and 4 <= plan.kc <= BWD_MAX_CHUNK and plan.kc % 4 == 0
          and plan.nt >= 1 and plan.groups == -(-K // DENSE_KG)
          and plan.tiles_n == -(-N // plan.bn)
          and plan.tiles_c == -(-plan.tiles_n // plan.nt)
          and (plan.nt == 1 or 4 * plan.groups <= plan.kc)
          and plan.smem_bytes == _bwd_smem(n_codes, plan.tm, plan.bn,
                                           plan.kc, plan.resident,
                                           plan.groups, plan.tiles_n)
          and plan.smem_bytes <= SMEM_PER_BLOCK)
    if not ok:
        raise ValueError(
            f"kernel 4 is not built for the plan of {plan.tm}-row x "
            f"{plan.bn}-column tiles, {plan.nt} an item, K chunks of "
            f"{plan.kc}, {plan.smem_bytes} B of shared memory")


def fused_lut_bwd(a: torch.Tensor, b: torch.Tensor, lut: torch.Tensor,
                  offset: int, a_scale, b_scale, *, bits: int = 8,
                  emit_acc: bool = False,
                  plan: BwdPlan | None = None) -> torch.Tensor:
    """Fused approximate backward GEMM (kernel 4): both float operands
    quantized in-kernel, per-tensor symmetric (zero point 0), LUT-gather
    GEMM, int32 accumulate, one combined-scale dequant ``acc * (sa * sb)``.

    ``a``: (M, K) float; ``b``: (K, N) float (the incoming gradient and a
    saved fake-quantized residual, in either order); ``a_scale`` /
    ``b_scale``: per-tensor scales. A transposed operand (``wf.T``,
    ``xf.T``) is copied contiguous here: the kernel reads row-major
    operands only. Returns (M, N) float32, or the raw int32 accumulator
    with ``emit_acc=True`` (the conv input gradient's integer col2im).
    ``plan`` launches the CUDA kernel with the one given, as given (a
    check's planted fault); it is refused (:func:`check_bwd_plan`) if the
    kernel is not built for it. Every plan gives the same bits.
    """
    n_codes = int(round(lut.numel() ** 0.5))
    M, K = a.shape
    K2, N = b.shape
    if K2 != K:
        raise ValueError(f"inner dims differ: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if plan is not None:
        check_bwd_plan(plan, M, K, N, n_codes)
    if a.device.type == "cpu":
        return fused_lut_bwd_ref(a, b, lut.reshape(-1), offset, n_codes,
                                 a_scale, b_scale, bits=bits,
                                 emit_acc=emit_acc)
    if a.device.type == "meta":
        runtime.count_work("fused_lut_bwd", lookups=M * K * N,
                           bytes_=runtime.nbytes(a, b, a_scale, b_scale)
                           + n_codes ** 2 * 2 + M * N * 4)
        return runtime.meta_empty(
            M, N, dtype=torch.int32 if emit_acc else torch.float32)
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    table = runtime.lut_to_int16(lut)
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    f = dict(dtype=torch.float32, device=a.device)
    sa = torch.as_tensor(a_scale, **f).reshape(1).contiguous()
    sb = torch.as_tensor(b_scale, **f).reshape(1).contiguous()
    for t, name, dt in ((a, "a", torch.float32), (b, "b", torch.float32),
                        (table, "lut", torch.int16)):
        runtime.check_cuda_operand(t, name, dt, a.device)
    out = torch.empty((M, N), device=a.device,
                      dtype=torch.int32 if emit_acc else torch.float32)
    if M == 0 or N == 0 or K == 0:
        return out.zero_()
    blocks, stream = runtime.launch_config(a)
    if plan is None:
        plan = bwd_plan(M, K, N, blocks, n_codes)
    # split items' sums and arrival counters, zeroed; none when none is
    # split
    work = (torch.zeros if plan.n_slots else torch.empty)(
        max(1, plan.n_slots * (plan.slot_elems + 1)), dtype=torch.int32,
        device=a.device)
    lib = runtime.kernel_library("fused_lut_bwd")
    lib.check(lib.launch(a.data_ptr(), b.data_ptr(), table.data_ptr(),
                         sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
                         int(emit_acc), M, K, N, n_codes, offset, lo, hi,
                         _device_plan(plan, a.device).data_ptr(), plan.grid,
                         plan.tm, plan.bn, plan.kc, plan.nt,
                         int(plan.resident), plan.tiles_n, plan.tiles_c,
                         plan.groups, work.data_ptr(), plan.n_slots,
                         plan.smem_bytes, stream))
    fused_lut_bwd.launches += 1
    return out


fused_lut_bwd.launches = 0
