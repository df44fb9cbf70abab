"""Plain PyTorch version of the affine quantizer (oracle of the kernel):
``clip(round_half_even(float32(x) / s + z), lo, hi)`` as int32.

``s`` and ``z`` are float32, 0-d (per tensor) or broadcast against ``x``
(per channel). The divide is correctly rounded and the add rounded on its
own, as the reference's ``quantize_ref`` does; ``torch.round`` rounds half
to even. The operand is widened to float32 first, exactly: JAX promotes
``bfloat16 / float32`` to float32, where PyTorch would keep the quotient of
a 0-d float32 divisor in bfloat16.
"""
from __future__ import annotations

import torch


def code_range(bits: int) -> tuple[int, int]:
    """``(lo, hi)`` of signed ``bits``-bit codes."""
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


def as_f32(v, device) -> torch.Tensor:
    """A scale or zero point as a float32 tensor on ``device``. On CUDA a
    divisor must be a tensor on the card: PyTorch turns a divide by a
    Python or CPU scalar into a multiply by its reciprocal there."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def quantize_ref(x: torch.Tensor, scale, zero_point,
                 bits: int = 8) -> torch.Tensor:
    """real -> int32 code within ``code_range(bits)``; ``scale`` and
    ``zero_point`` broadcast against ``x``."""
    lo, hi = code_range(bits)
    s, z = as_f32(scale, x.device), as_f32(zero_point, x.device)
    q = torch.round(x.to(torch.float32) / s + z)
    return torch.clamp(q, lo, hi).to(torch.int32)


def _walk_elements(plan, n: int) -> torch.Tensor:
    """The flat output index of every element kernel 2 writes under
    ``plan`` (a ``QuantizePlan``), once per write, in the order of its
    loops: blocks, threads, steps, the vectors (or elements) a step has
    in flight, and the elements of a vector."""
    threads, unroll = 256, 4
    sizes = [d[0] for d in plan.dims]
    hits = []
    if plan.path == "strided":
        stride = plan.grid[0] * threads
        gtid = torch.arange(stride)
        for base in range(0, n, stride * unroll):
            for j in range(unroll):
                i = base + gtid + j * stride
                hits.append(i[i < n])
        return torch.cat(hits)
    G, R, C = sizes[1:]
    vec = plan.vec
    lanes = torch.arange(vec)
    if plan.path == "strip":
        cv, tx = C // vec, plan.tx
        ty_n = threads // tx
        for grp in range(plan.grid[2]):
            for by in range(plan.grid[1]):
                r_end = min(R, (by + 1) * plan.rows)
                for bx in range(plan.grid[0]):
                    cvs = bx * tx + torch.arange(tx)
                    cvs = cvs[cvs < cv]
                    for ty in range(ty_n):
                        for r in range(by * plan.rows + ty, r_end,
                                       ty_n * unroll):
                            for u in range(unroll):
                                rr = r + u * ty_n
                                if rr >= r_end:
                                    continue
                                vid = (grp * R + rr) * cv + cvs
                                vid = vid[vid < plan.vectors]
                                hits.append((vid[:, None] * vec
                                             + lanes).reshape(-1))
        return torch.cat(hits) if hits else torch.zeros(0, dtype=torch.long)
    stride = plan.grid[0] * threads                          # flat
    gtid = torch.arange(stride)
    for e0 in range(0, plan.head, stride):
        e = e0 + gtid
        hits.append(e[e < plan.head])
    for e0 in range(plan.tail, n, stride):
        e = e0 + gtid
        hits.append(e[e < n])
    for v0 in range(0, plan.vectors, stride * unroll):
        for u in range(unroll):
            v = v0 + gtid + u * stride
            v = v[v < plan.vectors]
            hits.append((plan.head + v[:, None] * vec + lanes).reshape(-1))
    return torch.cat(hits) if hits else torch.zeros(0, dtype=torch.long)


def quantize_plan_ref(x: torch.Tensor, scale, zero_point, plan,
                      bits: int = 8, *, poison: int = 1 << 20):
    """Kernel 2's walk under ``plan`` in plain PyTorch: every element the
    kernel's loops visit, read from ``x``'s, the scale's and the zero
    point's storage at the offsets the kernel computes from the plan's
    merged strides, and quantized as :func:`quantize_ref` does. Returns
    ``(codes, writes)`` in ``x``'s shape: the codes, ``poison`` where
    nothing was written, and how often each element was written."""
    lo, hi = code_range(bits)
    shape = tuple(x.shape)
    n = x.numel()
    idx = _walk_elements(plan, n)
    sizes = [d[0] for d in plan.dims]
    coords, rest = [], idx
    for size in reversed(sizes):
        coords.append(rest % size)
        rest = rest // size
    coords.reverse()
    s = as_f32(scale, x.device).expand(shape)
    z = as_f32(zero_point, x.device).expand(shape)
    vals = []
    for i, t in enumerate((x, s, z)):
        storage = torch.as_strided(
            t, (t.untyped_storage().nbytes() // t.element_size(),), (1,), 0)
        off = t.storage_offset() + sum(c * d[1][i]
                                       for c, d in zip(coords, plan.dims))
        vals.append(storage[off])
    q = torch.round(vals[0].to(torch.float32) / vals[1] + vals[2])
    codes = torch.full((n,), poison, dtype=torch.int32)
    codes[idx] = torch.clamp(q, lo, hi).to(torch.int32)
    writes = torch.bincount(idx, minlength=n)
    return codes.reshape(shape), writes.reshape(shape)
