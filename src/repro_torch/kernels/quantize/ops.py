"""Public wrapper of the affine quantize kernel (``csrc/quantize.cu``).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py``. There is no fallback between the two.

The scale and zero point reach the kernel as broadcast views of ``x``'s
shape with their own strides (stride 0 along broadcast dims), so a
per-channel scale along any axis, or the (E, 1, N) grouped weight scale,
takes no copy; nor does a strided ``x``. Dims that all three operands can
walk as one are merged first, so the kernel indexes at most four.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from .ref import as_f32, code_range, quantize_ref

MAX_RANK = 4
# the kernel's element type codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def quantize(x: torch.Tensor, scale, zero_point,
             bits: int = 8) -> torch.Tensor:
    """``clip(round_half_even(float32(x) / s + z), lo, hi)`` as int32 in
    ``x``'s shape (contiguous). ``x``: float32 or bfloat16, any strides;
    ``scale`` / ``zero_point``: float32, 0-d or broadcast against ``x``
    (e.g. (1, N) against (K, N), (Cout, 1, 1, 1) against a conv weight,
    (E, 1, N) against (E, K, N))."""
    if x.device.type == "cpu":
        return quantize_ref(x, scale, zero_point, bits)
    if x.dtype not in DTYPES:
        raise ValueError(f"quantize takes float32 or bfloat16, got "
                         f"{x.dtype}")
    s, z = as_f32(scale, x.device), as_f32(zero_point, x.device)
    shape = tuple(x.shape)
    if torch.broadcast_shapes(shape, s.shape, z.shape) != shape:
        raise ValueError(f"scale {tuple(s.shape)} and zero point "
                         f"{tuple(z.shape)} must broadcast to x {shape}")
    se, ze = s.expand(shape), z.expand(shape)
    dims = merged_dims(shape, x.stride(), se.stride(), ze.stride())
    if len(dims) > MAX_RANK:
        raise ValueError(f"quantize indexes at most {MAX_RANK} dims after "
                         f"merging, got {len(dims)} for x {shape}, scale "
                         f"{tuple(s.shape)}")
    n = x.numel()
    if n >= 2 ** 31:
        raise ValueError(f"x has {n} elements; the kernel indexes with "
                         f"32-bit ints")
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    rank = max(len(dims), 1)
    dims = [(1, (0, 0, 0))] * (MAX_RANK - len(dims)) + dims
    sizes = [d[0] for d in dims]
    xst, sst, zst = ([d[1][i] for d in dims] for i in range(3))
    lo, hi = code_range(bits)
    lib = runtime.kernel_library("quantize")
    blocks, stream = runtime.launch_config(x)
    lib.check(lib.launch(x.data_ptr(), DTYPES[x.dtype], s.data_ptr(),
                         z.data_ptr(), out.data_ptr(), rank, *sizes,
                         *xst, *sst, *zst, n, lo, hi, 8 * blocks, stream))
    quantize.launches += 1
    return out


quantize.launches = 0
