"""Public wrapper of the ragged grouped fused LUT-GEMM kernel
(``csrc/fused_lut_grouped.cu``): all expert GEMMs of one MoE projection in
one launch.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py``. Nothing is padded in memory, and the live-row counts
stay on the device: the wrapper never reads them back.

The kernel runs a work plan made here from shapes only
(:func:`grouped_plan`): tiles of (expert, row tile of packed live rows,
column tile), K in chunks of 32, a ring of cp.async stages and the cost of
one chunk in live rows. The kernel itself splits the tiles' chunks over the
persistent blocks, weighted by each tile's live rows, which it reads from
the counts on the device; :func:`split_segments` computes the same split on
the host, for the plain version that walks it
(``ref.fused_lut_grouped_plan_ref``), the tests, and segments pinned by a
check (``fused_lut_grouped_planned(..., segments=)``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.fused_lut_dense.ops import (SMEM_PER_BLOCK,
                                                     _round16)
from .ref import fused_lut_grouped_ref

GROUPED_BK = 32     # K chunk: the unit of a segment's K range
GROUPED_TM = 16     # packed rows of one warp
GROUPED_TN = (4, 2, 1)   # columns of one lane (tiles of 128, 64, 32)

# The split's fixed cost of one chunk (streaming its weight codes, staging,
# quantizing, barriers), in live rows' gathers: 16 when the warps own K
# slices (one row group, wm = 1), twice the row tile with row groups.
# Swept on an H100 at granite-moe-3b-a800m's decode and prefill shapes.
def grouped_alpha(bm: int) -> int:
    return 16 if bm == GROUPED_TM else 2 * bm


def grouped_smem(n_codes: int, E: int, nb: int, bm: int, bn: int,
                 stages: int, x_bytes: int) -> int:
    """Dynamic shared memory of one kernel-10 block, as the source's
    ``Layout`` sizes it: the int16 table, ``stages`` ring stages of one
    chunk's raw weight codes and activations, two buffers each of one-byte
    weight and activation codes, the tile's row list, the expert's prefix
    over the ``nb`` dispatch blocks, the arrival flag, the ``E`` experts'
    live rows and their costs' prefix."""
    k = GROUPED_BK
    stage = _round16(k * bn * 4) + _round16(bm * k * x_bytes)
    return (_round16(n_codes * n_codes * 2) + stages * stage
            + 2 * _round16(k * bn) + 2 * _round16(bm * k) + _round16(bm * 4)
            + _round16((nb + 1) * 4) + 16 + _round16(E * 4)
            + _round16((E + 1) * 8))


@dataclass(frozen=True, eq=False)
class GroupedPlan:
    """Kernel 10's work plan for one projection of ``E`` experts over
    ``nb`` dispatch blocks of ``C`` rows, (K, N), on ``grid`` persistent
    blocks (one an SM).

    A block has 8 warps: ``wm`` groups of 16 packed live rows (``bm = 16
    * wm``), the other warps splitting each chunk's K; a lane holds ``tn``
    columns (``bn = 32 * tn``). Tiles are numbered (expert, row tile, column tile), column tile
    fastest. K runs in ``chunks`` chunks of 32 through a ring of ``stages``
    cp.async stages. One chunk of a tile with ``r`` live rows costs
    ``alpha + r`` in the split (:func:`split_segments`); a split tile adds
    into workspace slot ``tile`` (``bm * bn`` int32 sums, then one arrival
    counter a tile). With one row group (``wm == 1``) each warp owns a K
    slice of every chunk."""
    E: int
    nb: int
    C: int
    K: int
    N: int
    tn: int
    wm: int
    stages: int
    row_tiles: int
    tiles_n: int
    chunks: int
    alpha: int
    grid: int
    smem_bytes: int

    @property
    def bm(self) -> int:
        return GROUPED_TM * self.wm

    @property
    def bn(self) -> int:
        return 32 * self.tn

    @property
    def slot_elems(self) -> int:
        return self.bm * self.bn

    @property
    def n_tiles(self) -> int:
        return self.E * self.row_tiles * self.tiles_n

    def tile(self, t: int) -> tuple[int, int, int]:
        """(expert, row tile, column tile) of tile ``t``."""
        return (t // (self.tiles_n * self.row_tiles),
                t // self.tiles_n % self.row_tiles, t % self.tiles_n)

    def summary(self) -> dict:
        """What a report prints: the tile, the tiles and chunks, the
        ring's stages, the split's cost of a chunk, the shared memory."""
        return dict(tile=f"{self.bm}x{self.bn}", tiles=self.n_tiles,
                    chunks=self.chunks, stages=self.stages, alpha=self.alpha,
                    smem=self.smem_bytes)

    def describe(self) -> str:
        return (f"tiles of {self.bm} packed rows ({self.wm} group(s) of 16, "
                f"{8 // self.wm} warp(s) across K) x "
                f"{self.bn} columns ({self.tn} a lane) over {self.E} experts"
                f" x {self.row_tiles} row tile(s) x {self.tiles_n} column "
                f"tiles, K in {self.chunks} chunks of {GROUPED_BK} through a "
                f"{self.stages}-stage ring, split over {self.grid} blocks at "
                f"{self.alpha} + live rows a chunk; {self.smem_bytes} B of "
                f"shared memory")


def grouped_tile(nb: int, C: int, N: int) -> tuple[int, int]:
    """(wm, tn): row groups of the tile and columns per lane. The row
    tile holds every packed row an expert can have (``nb * C``), up to
    128 (8 groups of 16), in the fewest groups (a power of two: the other
    warps split K), so each chunk of weight codes is read once for all of
    an expert's live rows. The column tile, 128, 64 or 32, is the one that
    pads N least (the widest on a tie)."""
    rows = max(1, nb * C)
    wm = 1
    while wm < 8 and GROUPED_TM * wm < rows:
        wm *= 2
    tn = min(GROUPED_TN, key=lambda t: (-(-N // (32 * t)) * 32 * t, -t))
    return wm, tn


@functools.lru_cache(maxsize=512)
def grouped_plan(E: int, nb: int, C: int, K: int, N: int, n_sm: int,
                 n_codes: int = 256, x_bytes: int = 4) -> GroupedPlan:
    """Kernel 10's tile (:func:`grouped_tile`), the deepest ring of 4, 3 or
    2 stages that fits a block's shared memory, and ``n_sm`` persistent
    blocks."""
    wm, tn = grouped_tile(nb, C, N)
    bm, bn = GROUPED_TM * wm, 32 * tn
    fits = [s for s in (4, 3, 2)
            if grouped_smem(n_codes, E, nb, bm, bn, s, x_bytes)
            <= SMEM_PER_BLOCK]
    if not fits:
        raise ValueError(f"kernel 10 has no ring that fits shared memory "
                         f"at {E} experts, {nb} dispatch blocks and a table "
                         f"of {n_codes} codes")
    stages = fits[0]
    return GroupedPlan(E, nb, C, K, N, tn, wm, stages,
                       -(-max(1, nb * C) // bm), -(-N // bn),
                       -(-K // GROUPED_BK), grouped_alpha(bm), n_sm,
                       grouped_smem(n_codes, E, nb, bm, bn, stages, x_bytes))


def split_segments(plan: GroupedPlan, counts) -> tuple[tuple, np.ndarray]:
    """The kernel's split of the tiles' chunks over ``plan.grid`` blocks,
    from the counts (as ``SplitCursor`` walks it): one chunk of a row tile
    with ``r`` live rows costs ``alpha + r`` (tiles with none cost 0 and
    are skipped); the total ``W`` is cut into the blocks' ranges ``[W b //
    grid, W (b + 1) // grid)``, and a chunk goes to the block whose range
    holds its first cost unit. Returns (offsets, segments) as the kernel's
    explicit plan takes them: block ``b`` runs rows ``offsets[b]:offsets[b
    + 1]`` of the (S, 4) int32 (tile, first chunk, end chunk, slot), slot
    -1 for a whole tile, else the tile."""
    c = np.clip(np.asarray(torch.as_tensor(counts).cpu()).reshape(-1), 0,
                plan.C).reshape(plan.nb, plan.E).sum(0).astype(np.int64)
    rt = np.arange(plan.row_tiles)
    rows = np.clip(c[:, None] - rt[None, :] * plan.bm, 0, plan.bm)
    unit = np.where(rows > 0, plan.alpha + rows, 0)           # (E, row tiles)
    unit = np.repeat(unit.reshape(-1), plan.tiles_n)          # by tile
    tile_cost = unit * plan.chunks
    starts = np.concatenate([[0], np.cumsum(tile_cost)])
    W = int(starts[-1])
    lo = np.array([W * b // plan.grid for b in range(plan.grid)], np.int64)
    rows_out = [[] for _ in range(plan.grid)]
    for t in np.flatnonzero(unit):
        chunk_start = starts[t] + unit[t] * np.arange(plan.chunks)
        owner = np.searchsorted(lo, chunk_start, side="right") - 1
        cuts = np.flatnonzero(np.diff(owner)) + 1
        for c0, c1 in zip(np.r_[0, cuts], np.r_[cuts, plan.chunks]):
            whole = c0 == 0 and c1 == plan.chunks
            rows_out[owner[c0]].append((t, c0, c1, -1 if whole else t))
    offsets, flat = [0], []
    for segs in rows_out:
        flat += segs
        offsets.append(len(flat))
    segments = np.asarray(flat, dtype=np.int32).reshape(-1, 4)
    segments.setflags(write=False)
    return tuple(offsets), segments


def check_grouped_plan(plan: GroupedPlan, G: int, C: int, K: int, N: int,
                       n_codes: int, x_bytes: int) -> None:
    """Refuses what the launch refuses: a plan for other operands, a tile
    the kernel has no instance of, or shared memory not sized as the
    source's ``Layout`` (or over the block's limit)."""
    ok = ((plan.E * plan.nb, plan.C, plan.K, plan.N) == (G, C, K, N)
          and plan.wm in (1, 2, 4, 8) and plan.tn in GROUPED_TN
          and 2 <= plan.stages <= 4 and plan.alpha >= 0
          and plan.chunks == -(-K // GROUPED_BK)
          and plan.tiles_n == -(-N // plan.bn)
          and plan.row_tiles == -(-max(1, plan.nb * C) // plan.bm)
          and plan.smem_bytes == grouped_smem(n_codes, plan.E, plan.nb,
                                              plan.bm, plan.bn, plan.stages,
                                              x_bytes)
          and plan.smem_bytes <= SMEM_PER_BLOCK)
    if not ok:
        raise ValueError(
            f"kernel 10 is not built for the plan of {plan.bm}x{plan.bn} "
            f"tiles, {plan.stages} stages, {plan.smem_bytes} B of shared "
            f"memory, for operands G={G} C={C} K={K} N={N}")


def fused_lut_grouped(x: torch.Tensor, wq: torch.Tensor, lut: torch.Tensor,
                      offset: int, x_scale, x_zp, w_scale,
                      counts: torch.Tensor, *, bits: int = 8,
                      emit_acc: bool = False) -> torch.Tensor:
    """Ragged grouped approximate GEMM over MoE capacity buffers.

    ``x``: (G, C, K) float dispatched activations, G groups of C capacity
    rows (float32 or bfloat16; bfloat16 is widened in-kernel, exactly);
    group ``g`` multiplies expert ``g % E``. ``wq``: (E, K, N) int32 shifted
    weight codes; ``lut``: the product table (int32, or int16 from
    :func:`runtime.lut_to_int16`); ``x_scale``/``x_zp``: per-tensor
    activation qparams shared by every group; ``w_scale``: (E,), (E, N) or
    (E, 1, N) per-expert weight scales; ``counts``: (G,) live rows per
    group. Returns (G, C, N) float32 with rows ``>= counts[g]`` exactly 0.0,
    or the int32 accumulator (dead rows 0) with ``emit_acc=True``.
    """
    n_codes = int(round(lut.numel() ** 0.5))
    G, C, K = x.shape
    E, K2, N = wq.shape
    if K2 != K:
        raise ValueError(f"inner dims differ: x {tuple(x.shape)}, "
                         f"wq {tuple(wq.shape)}")
    if E == 0 or G % E != 0:
        raise ValueError(f"groups {G} not a multiple of experts {E}")
    if tuple(counts.shape) != (G,):
        raise ValueError(f"counts {tuple(counts.shape)}, expected ({G},)")
    if x.device.type == "cpu":
        return fused_lut_grouped_ref(x, wq, lut.reshape(-1), offset, n_codes,
                                     x_scale, x_zp, w_scale, counts,
                                     bits=bits, emit_acc=emit_acc)
    if x.device.type == "meta":
        # the live rows (``counts``) are data: every capacity row counts
        runtime.count_work("fused_lut_grouped", lookups=G * C * K * N,
                           bytes_=runtime.nbytes(x, wq, x_scale, x_zp,
                                                 w_scale, counts)
                           + n_codes ** 2 * 2 + G * C * N * 4)
        return runtime.meta_empty(
            G, C, N, dtype=torch.int32 if emit_acc else torch.float32)
    x_bytes = 2 if x.dtype == torch.bfloat16 else 4
    blocks, _ = runtime.launch_config(x)
    plan = grouped_plan(E, G // E, C, K, N, blocks, n_codes, x_bytes)
    return fused_lut_grouped_planned(x, wq, lut, offset, x_scale, x_zp,
                                     w_scale, counts, plan=plan, bits=bits,
                                     emit_acc=emit_acc)


fused_lut_grouped.launches = 0


def fused_lut_grouped_planned(x: torch.Tensor, wq: torch.Tensor,
                              lut: torch.Tensor, offset: int, x_scale, x_zp,
                              w_scale, counts: torch.Tensor, *,
                              plan: GroupedPlan, segments=None,
                              out: torch.Tensor | None = None,
                              bits: int = 8,
                              emit_acc: bool = False) -> torch.Tensor:
    """Launch kernel 10 on CUDA operands with the given work plan and add
    one to ``fused_lut_grouped.launches``. The kernel splits the plan's
    tiles over its blocks itself; ``segments`` (offsets, segments), as
    :func:`split_segments` makes them, pins the blocks' segments instead (a
    check's planted fault). ``out`` is written in place: a tile whose
    segments do not cover its K is never stored, so a check that drops a
    split passes a poisoned buffer. Refuses a plan the kernel is not built
    for (:func:`check_grouped_plan`)."""
    n_codes = int(round(lut.numel() ** 0.5))
    G, C, K = x.shape
    E, _, N = wq.shape
    if x.dtype != torch.bfloat16:
        x = x.to(torch.float32)
    check_grouped_plan(plan, G, C, K, N, n_codes, x.element_size())
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    table = runtime.lut_to_int16(lut)
    if table.data_ptr() % 16:          # the kernel copies it 16 bytes a load
        table = table.clone()
    x = x.contiguous()
    wq = wq.contiguous()
    counts = counts.to(torch.int32).contiguous()
    f = dict(dtype=torch.float32, device=x.device)
    xs = torch.as_tensor(x_scale, **f).reshape(1).contiguous()
    xz = torch.as_tensor(x_zp, **f).reshape(1).contiguous()
    ws = torch.as_tensor(w_scale, **f).reshape(E, -1).expand(E, N).contiguous()
    for t, name, dt in ((x, "x", x.dtype), (wq, "wq", torch.int32),
                        (table, "lut", torch.int16),
                        (counts, "counts", torch.int32)):
        runtime.check_cuda_operand(t, name, dt, x.device)
    dtype = torch.int32 if emit_acc else torch.float32
    if out is None:
        out = torch.empty((G, C, N), device=x.device, dtype=dtype)
    elif tuple(out.shape) != (G, C, N):
        raise ValueError(f"out {tuple(out.shape)}, expected {(G, C, N)}")
    else:
        runtime.check_cuda_operand(out, "out", dtype, x.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    # each tile's slot of int32 sums and its arrival counter, zeroed
    work = torch.zeros(plan.n_tiles * (plan.slot_elems + 1),
                       dtype=torch.int32, device=x.device)
    pinned = None
    if segments is not None:
        offsets, segs = segments
        pinned = torch.from_numpy(np.concatenate(
            [np.asarray(offsets, np.int32),
             np.asarray(segs, np.int32).reshape(-1)])).to(x.device)
    lib = runtime.kernel_library("fused_lut_grouped")
    _, stream = runtime.launch_config(x)
    lib.check(lib.launch(x.data_ptr(), int(x.dtype == torch.bfloat16),
                         wq.data_ptr(), table.data_ptr(), xs.data_ptr(),
                         xz.data_ptr(), ws.data_ptr(), counts.data_ptr(),
                         out.data_ptr(), int(emit_acc), G, E, C, K, N,
                         n_codes, offset, lo, hi,
                         None if pinned is None else pinned.data_ptr(),
                         plan.grid, plan.tn, plan.wm, plan.stages,
                         plan.row_tiles, plan.tiles_n, plan.chunks,
                         plan.alpha, work.data_ptr(), plan.smem_bytes,
                         stream))
    fused_lut_grouped.launches += 1
    return out
