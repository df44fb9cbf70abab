"""Public wrapper of the affine quantize kernel (``csrc/quantize.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py``. There is no fallback between the two.

The scale and zero point reach the kernel as broadcast views of ``x``'s
shape with their own strides (stride 0 along broadcast dims), so a
per-channel scale along any axis, or the (E, 1, N) grouped weight scale,
takes no copy; nor does a strided ``x``. Dims that all three operands can
walk as one are merged first, so the kernel indexes at most four.

:func:`quantize_plan` picks one of the kernel's three paths for a call:

* ``strip``: the merged dims are (groups, rows, columns) with ``x`` dense
  along the columns, 16-byte aligned rows and a scale and zero point that
  each vary along the rows or along the columns, not both. A block's ``tx``
  threads take adjacent 16-byte column vectors and its ``256 / tx`` thread
  rows take a band of ``rows`` rows of one group, 4 vectors in flight a
  thread (one row step a block). A scale that varies along the columns is
  loaded once a thread (those columns' values kept in registers), one that
  varies along the rows once a row;
* ``flat``: ``x`` dense but its rows ragged or not 16-byte aligned (a
  ResNet stem's 27 columns, a sliced start): the flat stream in 16-byte
  vectors from the first aligned element, the elements before it and
  after the last whole vector one a thread;
* ``strided``: anything else (a non-unit inner stride, four merged dims):
  one element a thread through the strides.

Each launch adds one to ``quantize.launches`` and, on ``strip`` or
``flat``, to ``quantize.vector_launches``.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace

import torch

from repro_torch.kernels import runtime
from .ref import as_f32, code_range, quantize_ref

MAX_RANK = 4
# the kernel's element type codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PATHS = {"strided": 0, "strip": 1, "flat": 2}
THREADS = 256            # threads of a block (every path)
VEC_BYTES = 16           # bytes of one vector load
UNROLL = 4               # vectors (strip, flat) or elements (strided) a
                         # thread has in flight
STRIDED_ITEMS = 4
MAX_GRID_YZ = 65535


def merged_dims(shape, *strides) -> list[tuple[int, tuple[int, ...]]]:
    """``shape`` with its size-1 dims dropped and every pair of adjacent
    dims merged where each operand's strides let one index walk both:
    ``[(size, (stride of each operand)), ...]``, outermost first. The
    output is contiguous in ``shape``, so it never blocks a merge."""
    dims: list[tuple[int, tuple[int, ...]]] = []
    for d, size in enumerate(shape):
        if size == 1:
            continue
        st = tuple(s[d] for s in strides)
        if dims:
            psize, pst = dims[-1]
            if all(p == c * size for p, c in zip(pst, st)):
                dims[-1] = (psize * size, st)
                continue
        dims.append((size, st))
    return dims


@dataclass(frozen=True)
class QuantizePlan:
    """How kernel 2 walks one call (see the module docstring).

    ``dims``: the merged ``(size, (x, scale, zero point strides))``, padded
    with size-1 dims to four, outermost first; the vector paths read the
    last three as (groups, rows, columns). ``vec``: elements of a 16-byte
    vector. ``tx``, ``rows``: a strip block's threads across column vectors
    and rows. ``grid``: blocks (x, y, z). ``vectors``: vectors the kernel
    walks (strip: groups x rows x column vectors; flat: the whole vectors
    of the stream); a plan with fewer drops the last ones. ``head``,
    ``tail``: flat elements before the first aligned vector and the first
    after the last whole one."""
    path: str
    rank: int
    dims: tuple
    vec: int = 0
    tx: int = 0
    rows: int = 0
    grid: tuple = (1, 1, 1)
    vectors: int = 0
    head: int = 0
    tail: int = 0

    @property
    def vector(self) -> bool:
        return self.path != "strided"

    def drop_last_vector(self) -> "QuantizePlan":
        """The same plan with its last vector dropped (a planted fault)."""
        return replace(self, vectors=self.vectors - 1)


def _strip_tx(cv: int) -> int:
    """Threads of a strip block across column vectors: of 256, 128, 64
    and 32, the one that leaves the fewest idle at the last column tile
    (the larger on a tie)."""
    return min((256, 128, 64, 32), key=lambda t: (-(-cv // t) * t - cv, -t))


@functools.lru_cache(maxsize=1024)
def quantize_plan(shape: tuple, x_strides: tuple, s_strides: tuple,
                  z_strides: tuple, itemsize: int, x_align: int,
                  n_sm: int) -> QuantizePlan:
    """The kernel's path and geometry for ``x`` of ``shape`` and
    ``x_strides`` (elements of ``itemsize`` bytes, its first element at
    ``x_align`` bytes past a 16-byte boundary), with its scale and zero
    point broadcast to ``shape`` at ``s_strides`` and ``z_strides``, on a
    card of ``n_sm`` SMs. The output is a fresh contiguous int32 tensor
    (16-byte aligned). Raises for more than four merged dims."""
    dims = merged_dims(shape, x_strides, s_strides, z_strides)
    if len(dims) > MAX_RANK:
        raise ValueError(f"quantize indexes at most {MAX_RANK} dims after "
                         f"merging, got {len(dims)} for x {shape}")
    n = math.prod(shape)
    pad = [(1, (0, 0, 0))] * (MAX_RANK - len(dims)) + dims
    rank = max(len(dims), 1)
    strided = QuantizePlan("strided", rank, tuple(pad), grid=(max(1, min(
        -(-n // (THREADS * STRIDED_ITEMS)), 8 * n_sm)), 1, 1))
    if n == 0 or len(dims) > 3 or x_align % itemsize:
        return strided
    (G, (xg, sg, zg)), (R, (xr, sr, zr)), (C, (xc, sc, zc)) = pad[1:]
    # every x offset and the output's index in 32 bits
    x_end = sum((size - 1) * abs(st[0]) for size, st in pad)
    if xc != 1 or x_end >= 2 ** 31 or min(xg, xr) < 0:
        return strided
    vec = VEC_BYTES // itemsize
    one_axis = (sr == 0 or sc == 0) and (zr == 0 or zc == 0)
    if (x_align == 0 and C % vec == 0 and xr % vec == 0 and xg % vec == 0
            and one_axis and G <= MAX_GRID_YZ):
        cv = C // vec
        tx = _strip_tx(cv)
        ty = THREADS // tx
        n_ct = -(-cv // tx)
        # a block takes UNROLL rows a thread row and ends, so the blocks in
        # flight cover adjacent rows (a one-wave grid of equal row bands
        # that each block walks ran 7 % slower on the card); more only
        # where the row bands would pass the grid's limit
        rows = ty * UNROLL * max(1, -(-R // (ty * UNROLL * MAX_GRID_YZ)))
        return QuantizePlan("strip", rank, tuple(pad), vec, tx, rows,
                            (n_ct, -(-R // rows), G), G * R * cv)
    if (R == 1 or xr == C) and (G == 1 or xg == R * C):
        head = min(n, (VEC_BYTES - x_align) % VEC_BYTES // itemsize)
        nv = (n - head) // vec
        blocks = max(1, min(-(-nv // (THREADS * UNROLL)), 32 * n_sm))
        return QuantizePlan("flat", rank, tuple(pad), vec, grid=(blocks, 1, 1),
                            vectors=nv, head=head, tail=head + nv * vec)
    return strided


def quantize(x: torch.Tensor, scale, zero_point, bits: int = 8, *,
             plan: QuantizePlan | None = None,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """``clip(round_half_even(float32(x) / s + z), lo, hi)`` as int32 in
    ``x``'s shape (contiguous). ``x``: float32 or bfloat16, any strides;
    ``scale`` / ``zero_point``: float32, 0-d or broadcast against ``x``
    (e.g. (1, N) against (K, N), (Cout, 1, 1, 1) against a conv weight,
    (E, 1, N) against (E, K, N)). ``plan`` pins a :class:`QuantizePlan`
    and ``out`` an output buffer (contiguous int32 of ``x``'s shape), for
    planted faults; by default :func:`quantize_plan` picks the path."""
    if x.device.type == "cpu":
        return quantize_ref(x, scale, zero_point, bits)
    if x.device.type == "meta":
        runtime.count_work("quantize", bytes_=runtime.nbytes(
            x, scale, zero_point) + x.numel() * 4)
        return runtime.meta_empty(*x.shape, dtype=torch.int32) \
            if out is None else out
    if x.dtype not in DTYPES:
        raise ValueError(f"quantize takes float32 or bfloat16, got "
                         f"{x.dtype}")
    s, z = as_f32(scale, x.device), as_f32(zero_point, x.device)
    shape = tuple(x.shape)
    if torch.broadcast_shapes(shape, s.shape, z.shape) != shape:
        raise ValueError(f"scale {tuple(s.shape)} and zero point "
                         f"{tuple(z.shape)} must broadcast to x {shape}")
    n = x.numel()
    if n >= 2 ** 31:
        raise ValueError(f"x has {n} elements; the kernel indexes with "
                         f"32-bit ints")
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=x.device)
    else:
        runtime.check_cuda_operand(out, "out", torch.int32, x.device)
        if tuple(out.shape) != shape:
            raise ValueError(f"out {tuple(out.shape)} is not x's {shape}")
    if n == 0:
        return out
    se, ze = s.expand(shape), z.expand(shape)
    blocks, stream = runtime.launch_config(x)
    if plan is None:
        plan = quantize_plan(shape, x.stride(), se.stride(), ze.stride(),
                             x.element_size(), x.data_ptr() % VEC_BYTES,
                             blocks)
    sizes = [d[0] for d in plan.dims]
    xst, sst, zst = ([d[1][i] for d in plan.dims] for i in range(3))
    lo, hi = code_range(bits)
    lib = runtime.kernel_library("quantize")
    lib.check(lib.launch(x.data_ptr(), DTYPES[x.dtype], s.data_ptr(),
                         z.data_ptr(), out.data_ptr(), PATHS[plan.path],
                         plan.rank, *sizes, *xst, *sst, *zst, n, lo, hi,
                         *plan.grid, plan.tx, plan.rows, plan.vectors,
                         plan.head, plan.tail, stream))
    quantize.launches += 1
    if plan.vector:
        quantize.vector_launches += 1
    return out


quantize.launches = 0
quantize.vector_launches = 0
