"""Public wrapper of the WKV-6 recurrence kernel (``csrc/wkv.cu``), in the
(B, T, H, hd) layout of the reference's ``kernels/wkv/ops.py:wkv``.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py`` (heads folded h-major, as the reference's ``fold``).
There is no fallback between the two. The kernel reads r/k/v/w through
their strides, so it needs none of the fold transposes.

``state_out`` receives ``S_T`` in place; it may be ``s0`` itself (each
(b, h) state is read whole before it is written), which is how the port's
time mix updates its cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import runtime
from .ref import wkv_ref

HEAD_DIMS = (16, 64)      # the kernel's instantiations: rwkv6-3b's and
                          # its reduced config's


def _fold(a: torch.Tensor) -> torch.Tensor:
    b, t, h, hd = a.shape
    return a.to(torch.float32).transpose(1, 2).reshape(b * h, t, hd)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, s0: torch.Tensor,
        state_out: Optional[torch.Tensor] = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``r``/``k``/``v``/``w``: (B, T, H, hd); ``u``: (H, hd); ``s0``:
    (B, H, hd, hd). Returns ``(out (B, T, H, hd), S_T (B, H, hd, hd))``,
    float32; ``S_T`` is ``state_out`` when given."""
    b, t, h, hd = r.shape
    for name, a in (("k", k), ("v", v), ("w", w)):
        if a.shape != r.shape:
            raise ValueError(f"{name} {tuple(a.shape)} differs from r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (h, hd) or tuple(s0.shape) != (b, h, hd, hd):
        raise ValueError(f"u {tuple(u.shape)} / s0 {tuple(s0.shape)} do not "
                         f"fit r {tuple(r.shape)}")
    if state_out is not None and state_out.shape != s0.shape:
        raise ValueError(f"state_out {tuple(state_out.shape)} differs from "
                         f"s0 {tuple(s0.shape)}")
    if r.device.type == "meta":
        # per token and head: k v^T, u * kv, S + u kv, r (S + u kv) and
        # w S + kv, hd^2 each, as multiplies and adds: 7 hd^2 operations
        runtime.count_work("wkv", flops=7 * b * t * h * hd * hd,
                           bytes_=runtime.nbytes(r, k, v, w, u, s0)
                           + (b * t * h * hd + b * h * hd * hd) * 4)
        s_t = runtime.meta_empty(b, h, hd, hd, dtype=torch.float32) \
            if state_out is None else state_out
        return runtime.meta_empty(b, t, h, hd, dtype=torch.float32), s_t
    if r.device.type == "cpu":
        out, s_t = wkv_ref(_fold(r), _fold(k), _fold(v), _fold(w), u,
                           s0.reshape(b * h, hd, hd))
        out = out.reshape(b, h, t, hd).transpose(1, 2).contiguous()
        s_t = s_t.reshape(b, h, hd, hd)
        if state_out is None:
            return out, s_t
        return out, state_out.copy_(s_t)
    if hd not in HEAD_DIMS:
        raise ValueError(f"the wkv kernel takes head dims {HEAD_DIMS}, got "
                         f"{hd}")
    rkvw = [a.to(torch.float32) for a in (r, k, v, w)]
    for a, name in zip(rkvw, "rkvw"):
        if a.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along hd")
    u = u.to(torch.float32).contiguous()
    s0 = s0.to(torch.float32).contiguous()
    s_t = torch.empty_like(s0) if state_out is None else state_out
    for a, name in ((u, "u"), (s0, "s0"), (s_t, "state_out")):
        runtime.check_cuda_operand(a, name, torch.float32, r.device)
    for a, name in zip(rkvw, "rkvw"):
        if a.device != r.device:
            raise ValueError(f"{name} is on {a.device}, expected {r.device}")
    out = torch.empty((b, t, h, hd), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return out, s_t
    strides = [st for a in rkvw for st in a.stride()[:3]]
    lib = runtime.kernel_library("wkv")
    _, stream = runtime.launch_config(r)
    lib.check(lib.launch(*(a.data_ptr() for a in rkvw), u.data_ptr(),
                         s0.data_ptr(), out.data_ptr(), s_t.data_ptr(), b,
                         t, h, hd, *strides, stream))
    wkv.launches += 1
    return out, s_t


wkv.launches = 0
