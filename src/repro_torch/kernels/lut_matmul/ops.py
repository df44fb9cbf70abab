"""Public wrapper of the LUT-gather GEMM kernel (``csrc/lut_matmul.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py``. There is no fallback between the two.

The kernel runs a work plan made here (:func:`lut_plan`): the tile (rows
per warp, warps across rows, a 16- to 256-column tile on the narrow-N
core's lane map) and, for each persistent block, its list of segments
(output tile, K range, workspace slot), split along K as kernel 3's
(``fused_lut_dense.ops.stream_k``). The CPU tests hold the same plan
against the plain version (``ref.lut_matmul_plan_ref``) that the card
runs.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.fused_lut_dense.ops import DENSE_KG, stream_k
from .ref import lane_map, lut_matmul_ref

LUT_COL_TILES = (256, 128, 64, 32)   # N > 16; N <= 16 takes 16 x 2 slices
KBK = 32                             # K chunk the kernel stages per step


def _round16(n: int) -> int:
    return (n + 15) & ~15


def _lut_smem(n_codes: int, tm: int, bn: int) -> int:
    """Dynamic shared memory of one kernel-1 block, as the source's
    ``Layout`` sizes it: the int16 table, two buffers each of raw A and W
    codes (int32, 32 K a chunk), their one-byte codes, a flag."""
    bm_max = 8 * tm
    return (_round16(n_codes * n_codes * 2) + 2 * _round16(bm_max * KBK * 4)
            + 2 * _round16(KBK * bn * 4) + _round16(bm_max * KBK)
            + _round16(KBK * bn) + 16)


@dataclass(frozen=True, eq=False)
class LutPlan:
    """Kernel 1's work plan for one (M, K, N) on ``n_sm`` SMs.

    A block has 8 warps: ``wm`` of them across the tile's rows (``tm``
    rows each, ``bm = tm * wm``) and ``8 // wm`` across each K chunk; a
    warp's lanes hold a ``bn``-column tile on the narrow-N lane map
    (``ref.lane_map``: at ``bn`` 16 two K slices of 16 columns). Tiles are
    numbered row-major (``tiles_n`` per row band); K is cut into
    ``groups`` groups of 4. ``segments`` is an (S, 4) int32 array of
    (tile, first group, end group, slot), block ``b`` running rows
    ``offsets[b]:offsets[b + 1]`` in order; slot -1 stores a whole tile,
    the others add into workspace slot ``slot`` (``bm * bn`` int32 sums,
    then one arrival counter per slot)."""
    M: int
    K: int
    N: int
    tm: int
    wm: int
    bn: int
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
    def ks(self) -> int:
        """K slices of one warp (2 at 16 columns)."""
        return lane_map(self.bn)[0]

    @property
    def n_slices(self) -> int:
        """K slices of one chunk: warps across K x a warp's slices."""
        return (8 // self.wm) * self.ks

    @property
    def grid(self) -> int:
        return len(self.offsets) - 1

    @property
    def slot_elems(self) -> int:
        return self.bm * self.bn

    def summary(self) -> dict:
        """What a report prints: the tile, the K slices of a chunk, the
        items (segments), the most segments on one tile (splits), the SMs
        with work, and the tile rows past M (no warp gathers for them)."""
        per_tile = np.bincount(self.segments[:, 0],
                               minlength=self.tiles_m * self.tiles_n)
        return dict(tile=f"{self.bm}x{self.bn}", k_slices=self.n_slices,
                    items=len(self.segments), splits=int(per_tile.max()),
                    sms=self.grid, rows_past_m=self.tiles_m * self.bm - self.M)


def lut_tile(M: int, N: int) -> tuple[int, int, int]:
    """(tm, wm, bn): rows per warp, warps across rows, the column tile.
    N <= 16 takes the 16-column tile (16 columns x 2 K slices a warp);
    wider N the one of 32, 64, 128 and 256 that pads N least, the widest
    on a tie. Rows: 128-row tiles (16 a warp) at 16 and 32 columns from
    M = 4096 on, so that a tile's gathers outweigh its staging; else 64
    rows from M = 64, 32 from M = 17, and for smaller M the fewest warps
    of 4 rows that hold it (the others split each K chunk; at 16 columns
    at least 2 warps across rows, so that a chunk's 8 groups cover its K
    slices)."""
    bn = 16 if N <= 16 else min(LUT_COL_TILES,
                                key=lambda b: (-(-N // b) * b, -b))
    if M >= 4096 and bn <= 32:
        tm, wm = 16, 8
    elif M >= 64:
        tm, wm = 8, 8
    elif M > 16:
        tm, wm = 4, 8
    else:
        tm = 4
        wm = 1 << (max(1, -(-M // tm)) - 1).bit_length()   # 1, 2 or 4
    if bn == 16:
        wm = max(wm, 2)
    return tm, wm, bn


@functools.lru_cache(maxsize=512)
def lut_plan(M: int, K: int, N: int, n_sm: int) -> LutPlan:
    """Kernel 1's tile (:func:`lut_tile`) and the segments each of
    ``n_sm`` persistent blocks runs (whole tiles round-robin, the rest
    stream-K: ``fused_lut_dense.ops.stream_k``)."""
    tm, wm, bn = lut_tile(M, N)
    tiles_m, tiles_n = -(-M // (tm * wm)), -(-N // bn)
    groups = -(-K // DENSE_KG)
    offsets, segments, n_slots = stream_k(tiles_m * tiles_n, groups, n_sm)
    return LutPlan(M, K, N, tm, wm, bn, tiles_m, tiles_n, groups, offsets,
                   segments, n_slots)


def check_plan(plan: LutPlan, M: int, K: int, N: int) -> None:
    """Refuses a plan made for other operands or a tile the kernel is not
    built for (the launch refuses the latter too)."""
    if (plan.M, plan.K, plan.N) != (M, K, N):
        raise ValueError(f"plan is for {(plan.M, plan.K, plan.N)}, the "
                         f"operands are {(M, K, N)}")
    lane_map(plan.bn)
    if plan.tm not in (4, 8, 16) or plan.wm not in (1, 2, 4, 8) \
            or (plan.tm == 16 and (plan.wm != 8 or plan.bn > 32)) \
            or plan.n_slices > KBK // DENSE_KG:
        raise ValueError(f"kernel 1 has no {plan.tm}-row x {plan.wm}-warp "
                         f"tile at {plan.bn} columns")


@functools.lru_cache(maxsize=512)
def _device_plan(plan: LutPlan, device: torch.device) -> torch.Tensor:
    """The plan as the kernel reads it: ``offsets`` then the segments, one
    int32 tensor on ``device``, uploaded once per plan and device."""
    flat = np.concatenate([np.asarray(plan.offsets, np.int32),
                           plan.segments.reshape(-1)])
    return torch.from_numpy(flat).to(device)


def lut_matmul(a: torch.Tensor, w: torch.Tensor, lut: torch.Tensor,
               offset: int) -> torch.Tensor:
    """``out[m, n] = sum_k LUT[a[m, k] + off, w[k, n] + off]``.

    ``a``: (M, K) int32 shifted codes; ``w``: (K, N) int32 shifted codes;
    ``lut``: (n_codes, n_codes) or flat, int32 (or the int16 table from
    :func:`runtime.lut_to_int16`, which skips the range check). Returns
    (M, N) int32. Codes are clamped to the table.
    """
    n_codes = int(round(lut.numel() ** 0.5))
    M, K = a.shape
    K2, N = w.shape
    if K2 != K:
        raise ValueError(f"inner dims differ: a {tuple(a.shape)}, "
                         f"w {tuple(w.shape)}")
    if a.device.type == "cpu":
        return lut_matmul_ref(a, w, lut.reshape(-1), offset, n_codes)
    if a.device.type == "meta":
        runtime.count_work("lut_matmul", lookups=M * K * N,
                           bytes_=runtime.nbytes(a, w) + n_codes ** 2 * 2
                           + M * N * 4)
        return runtime.meta_empty(M, N, dtype=torch.int32)
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), dtype=torch.int32, device=a.device)
    blocks, _ = runtime.launch_config(a)
    return lut_matmul_planned(a, w, lut, offset,
                              plan=lut_plan(M, K, N, blocks))


lut_matmul.launches = 0


def lut_matmul_planned(a: torch.Tensor, w: torch.Tensor, lut: torch.Tensor,
                       offset: int, *, plan: LutPlan) -> torch.Tensor:
    """Launch kernel 1 on CUDA operands with the given work plan (the one
    :func:`lut_matmul` makes, or another for a check) and add one to
    ``lut_matmul.launches``."""
    n_codes = int(round(lut.numel() ** 0.5))
    M, K = a.shape
    N = w.shape[1]
    check_plan(plan, M, K, N)
    table = runtime.lut_to_int16(lut)
    a = a.contiguous()
    w = w.contiguous()
    for t, name, dt in ((a, "a", torch.int32), (w, "w", torch.int32),
                        (table, "lut", torch.int16)):
        runtime.check_cuda_operand(t, name, dt, a.device)
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    # split tiles' sums and arrival counters, zeroed; none when no tile is
    # split
    work = (torch.zeros if plan.n_slots else torch.empty)(
        max(1, plan.n_slots * (plan.slot_elems + 1)), dtype=torch.int32,
        device=a.device)
    lib = runtime.kernel_library("lut_matmul")
    _, stream = runtime.launch_config(a)
    lib.check(lib.launch(a.data_ptr(), w.data_ptr(), table.data_ptr(),
                         out.data_ptr(), M, K, N, n_codes, offset,
                         _device_plan(plan, a.device).data_ptr(), plan.grid,
                         plan.tm, plan.wm, plan.bn, plan.tiles_n,
                         plan.groups, work.data_ptr(), plan.n_slots, stream))
    lut_matmul.launches += 1
    return out
