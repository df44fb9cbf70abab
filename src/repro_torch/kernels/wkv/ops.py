"""Public wrapper of the WKV-6 recurrence kernel (``csrc/wkv.cu``), in the
(B, T, H, hd) layout of the reference's ``kernels/wkv/ops.py:wkv``.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py`` (heads folded h-major, as the reference's ``fold``).
There is no fallback between the two. The kernel reads r/k/v/w through
their strides, so it needs none of the fold transposes.

``state_out`` receives ``S_T`` in place; it may be ``s0`` itself (each
kernel block reads the state entries it writes before it writes them),
which is how the port's time mix updates its cache. That serving path
carries no gradient: asking for one through it raises ``ValueError``.

With a gradient wanted, :class:`_WKV` (a ``torch.autograd.Function``)
runs the recurrence on every device: its forward keeps the state before
every ``chunk`` steps (``chunk`` is the config's ``rwkv_chunk``, 256, as
the reference's checkpointed chunked scan keeps it), its backward restores
each chunk's states from there and walks time in reverse: the CUDA kernel
``csrc/wkv_bwd.cu`` for a CUDA tensor (counted by ``wkv_bwd.launches``),
``ref.py: wkv_bwd_ref`` for a CPU tensor, and a shape rule
(``count_work("wkv_bwd", ...)``) for a ``meta`` one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import runtime
from .ref import n_chunks, wkv_bwd_ref, wkv_ref

HEAD_DIMS = (16, 64)      # the kernel's instantiations: rwkv6-3b's and
                          # its reduced config's
CHUNK = 256               # the reference's rwkv_chunk


def _fold(a: torch.Tensor) -> torch.Tensor:
    b, t, h, hd = a.shape
    return a.to(torch.float32).transpose(1, 2).reshape(b * h, t, hd)


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """``a`` as float32, contiguous and 16-byte aligned (the kernels stage
    their operands with 16-byte copies)."""
    a = a.to(torch.float32).contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


def _check(r, k, v, w, u, s0, state_out):
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


def wkv_work(r, k, v, w, u, s0, chunk: Optional[int]) -> tuple[int, int]:
    """(bytes, FLOPs) of the forward on these operands, for the ``meta``
    rule and the bounds measured on the card: ``r``/``k``/``v``/``w``,
    ``u`` and ``s0`` read once, ``out``, ``S_T`` and the chunk-boundary
    states (with ``chunk``) written once as float32; per token and head
    k v^T, u * kv, S + u kv, r (S + u kv) and w S + kv, hd^2 each, as
    multiplies and adds (an FMA two FLOPs): 7 hd^2."""
    b, t, h, hd = r.shape
    nc = n_chunks(t, chunk) if chunk is not None else 0
    bytes_ = runtime.nbytes(r, k, v, w, u, s0) + (
        b * t * h * hd + b * h * hd * hd + nc * b * h * hd * hd) * 4
    return bytes_, 7 * b * t * h * hd * hd


def wkv_bwd_work(r, k, v, w, u, bounds, dout, ds_t) -> tuple[int, int]:
    """(bytes, FLOPs) of the backward on these operands, for the ``meta``
    rule and the bounds measured on the card. Bytes: the operands, the
    chunk-boundary states, ``dout`` and ``ds_t`` read once, the four
    (B, T, H, hd) gradients, ``du`` and ``ds0`` written once as float32
    (the restored states stay on chip). FLOPs, the function's least (an
    FMA two): 3 hd^2 a token and head to restore the state from the chunk
    boundaries (w*S, k*v, +), and 11 hd^2 for the reverse pass, r dout^T
    (1), dS_{t-1} = w dS + r dout^T (2) and four sums over an entry, S dout
    (dr), S dS (dw), dS v (dk) and k dS (dv) (2 each); a = S + u kv is
    never formed, since dr, dk, dv and du take its u kv part as O(hd)
    terms: u k (v.dout), u r (v.dout), dout (sum u k r) and k r (v.dout).
    So 14 hd^2: the function's work, not the kernel's instructions
    (``csrc/wkv_bwd.cu`` restores each state twice and carries dS twice)."""
    b, t, h, hd = r.shape
    bytes_ = runtime.nbytes(r, k, v, w, u, bounds, dout, ds_t) + (
        4 * b * t * h * hd + h * hd + b * h * hd * hd) * 4
    return bytes_, (3 + 11) * b * t * h * hd * hd


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, s0: torch.Tensor,
        state_out: Optional[torch.Tensor] = None, *, chunk: int = CHUNK
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``r``/``k``/``v``/``w``: (B, T, H, hd); ``u``: (H, hd); ``s0``:
    (B, H, hd, hd). Returns ``(out (B, T, H, hd), S_T (B, H, hd, hd))``,
    float32; ``S_T`` is ``state_out`` when given. When grad mode is on and
    an input requires a gradient, the result carries the recurrence's
    backward (chunks of ``chunk`` steps)."""
    _check(r, k, v, w, u, s0, state_out)
    wants_grad = torch.is_grad_enabled() and any(
        a.requires_grad for a in (r, k, v, w, u, s0))
    if wants_grad:
        if state_out is not None:
            raise ValueError("wkv with state_out= updates a serving cache in "
                             "place and carries no gradient; call it without "
                             "state_out (or under torch.no_grad())")
        return _WKV.apply(r, k, v, w, u, s0, chunk)
    out, s_t, _ = _forward(r, k, v, w, u, s0, state_out, None)
    return out, s_t


def _forward(r, k, v, w, u, s0, state_out, chunk):
    """The forward on ``r``'s device; with ``chunk``, also the
    chunk-boundary states (n_chunks, B*H, hd, hd) (else None)."""
    b, t, h, hd = r.shape
    nc = n_chunks(t, chunk) if chunk is not None else 0
    if r.device.type == "meta":
        bytes_, flops = wkv_work(r, k, v, w, u, s0, chunk)
        runtime.count_work("wkv", flops=flops, bytes_=bytes_)
        s_t = runtime.meta_empty(b, h, hd, hd, dtype=torch.float32) \
            if state_out is None else state_out
        bounds = runtime.meta_empty(nc, b * h, hd, hd, dtype=torch.float32) \
            if chunk is not None else None
        return runtime.meta_empty(b, t, h, hd, dtype=torch.float32), s_t, \
            bounds
    if r.device.type == "cpu":
        res = wkv_ref(_fold(r), _fold(k), _fold(v), _fold(w), u,
                      s0.reshape(b * h, hd, hd), chunk=chunk)
        out, s_t = res[0], res[1]
        bounds = res[2] if chunk is not None else None
        out = out.reshape(b, h, t, hd).transpose(1, 2).contiguous()
        s_t = s_t.reshape(b, h, hd, hd)
        if state_out is not None:
            s_t = state_out.copy_(s_t)
        return out, s_t, bounds
    if hd not in HEAD_DIMS:
        raise ValueError(f"the wkv kernel takes head dims {HEAD_DIMS}, got "
                         f"{hd}")
    rkvw = [a.to(torch.float32) for a in (r, k, v, w)]
    for a, name in zip(rkvw, "rkvw"):
        if a.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along hd")
    if t > 1:   # the sequence kernel stages whole rows with 16-byte copies
        rkvw = [a if a.data_ptr() % 16 == 0
                and all(st % 4 == 0 for st in a.stride()[:3])
                else _aligned(a) for a in rkvw]
    u = u.to(torch.float32).contiguous()
    s0 = s0.to(torch.float32).contiguous()
    s_t = torch.empty_like(s0) if state_out is None else state_out
    for a, name in ((u, "u"), (s0, "s0"), (s_t, "state_out")):
        runtime.check_cuda_operand(a, name, torch.float32, r.device)
    for a, name in zip(rkvw, "rkvw"):
        if a.device != r.device:
            raise ValueError(f"{name} is on {a.device}, expected {r.device}")
    out = torch.empty((b, t, h, hd), dtype=torch.float32, device=r.device)
    bounds = None
    if chunk is not None:
        bounds = torch.empty((nc, b * h, hd, hd), dtype=torch.float32,
                             device=r.device)
        if t == 0:
            bounds[0].copy_(s0.reshape(b * h, hd, hd))
    if b * h == 0:
        return out, s_t, bounds
    strides = [st for a in rkvw for st in a.stride()[:3]]
    lib = runtime.kernel_library("wkv")
    _, stream = runtime.launch_config(r)
    lib.check(lib.launch(*(a.data_ptr() for a in rkvw), u.data_ptr(),
                         s0.data_ptr(), out.data_ptr(), s_t.data_ptr(),
                         None if bounds is None else bounds.data_ptr(),
                         chunk or 0, b, t, h, hd, *strides, stream))
    wkv.launches += 1
    return out, s_t, bounds


def wkv_bwd(r, k, v, w, u, bounds, dout, ds_t, chunk: int = CHUNK, *,
            states_out: Optional[torch.Tensor] = None):
    """The recurrence's backward in the (B, T, H, hd) layout: ``bounds``
    from the forward, ``dout`` (B, T, H, hd), ``ds_t`` (B, H, hd, hd) or
    None. Returns ``(dr, dk, dv, dw, du (H, hd), ds0 (B, H, hd, hd))``,
    float32: the CUDA kernel on a CUDA tensor, ``wkv_bwd_ref`` on a CPU
    one, the shape rule on ``meta``. ``states_out`` (B*H, T, hd, hd),
    CUDA only, receives every state the kernel restores (``S_{t-1}`` at
    ``[:, t]``), for a check against the forward's."""
    b, t, h, hd = r.shape
    if r.device.type == "meta":
        bytes_, flops = wkv_bwd_work(r, k, v, w, u, bounds, dout, ds_t)
        runtime.count_work("wkv_bwd", flops=flops, bytes_=bytes_)
        grads = [runtime.meta_empty(b, t, h, hd, dtype=torch.float32)
                 for _ in range(4)]
        return (*grads, runtime.meta_empty(h, hd, dtype=torch.float32),
                runtime.meta_empty(b, h, hd, hd, dtype=torch.float32))
    if r.device.type == "cpu":
        if states_out is not None:
            raise ValueError("states_out is the CUDA kernel's; on the CPU, "
                             "ref.py: wkv_bwd_tiled_ref keeps the states")
        dr, dk, dv, dw, du, ds0 = wkv_bwd_ref(
            _fold(r), _fold(k), _fold(v), _fold(w), u, bounds, _fold(dout),
            None if ds_t is None else ds_t.reshape(b * h, hd, hd), chunk)
        unfold = lambda a: a.reshape(b, h, t, hd).transpose(1, 2).contiguous()
        return (unfold(dr), unfold(dk), unfold(dv), unfold(dw), du,
                ds0.reshape(b, h, hd, hd))
    if hd not in HEAD_DIMS:
        raise ValueError(f"the wkv kernel takes head dims {HEAD_DIMS}, got "
                         f"{hd}")
    ins = [_aligned(a) for a in (r, k, v, w, dout)]
    u = u.to(torch.float32).contiguous()
    ds_t = None if ds_t is None else ds_t.to(torch.float32).contiguous()
    for a, name in zip(ins + [u, bounds] + ([ds_t] if ds_t is not None
                                            else []),
                       ("r", "k", "v", "w", "dout", "u", "bounds", "ds_t")):
        runtime.check_cuda_operand(a, name, torch.float32, r.device)
    if states_out is not None:
        runtime.check_cuda_operand(states_out, "states_out", torch.float32,
                                   r.device)
        if tuple(states_out.shape) != (b * h, t, hd, hd):
            raise ValueError(f"states_out {tuple(states_out.shape)} is not "
                             f"{(b * h, t, hd, hd)}")
    grads = [torch.empty((b, t, h, hd), dtype=torch.float32, device=r.device)
             for _ in range(4)]
    ds0 = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    du = torch.empty((h, hd), dtype=torch.float32, device=r.device)
    if t == 0:
        ds0.copy_(ds_t if ds_t is not None else torch.zeros_like(ds0))
        du.zero_()
        return (*grads, du, ds0)
    du_part = torch.empty((b * h, hd), dtype=torch.float32, device=r.device)
    rr, kk, vv, ww, gg = ins
    lib = runtime.kernel_library("wkv_bwd")
    _, stream = runtime.launch_config(r)
    lib.check(lib.launch(
        rr.data_ptr(), kk.data_ptr(), vv.data_ptr(), ww.data_ptr(),
        u.data_ptr(), bounds.data_ptr(), gg.data_ptr(),
        None if ds_t is None else ds_t.data_ptr(),
        *(g.data_ptr() for g in grads), ds0.data_ptr(), du_part.data_ptr(),
        du.data_ptr(), None if states_out is None else states_out.data_ptr(),
        b, t, h, hd, chunk, stream))
    wkv_bwd.launches += 1
    return (*grads, du, ds0)


class _WKV(torch.autograd.Function):
    """The recurrence with its backward: the forward keeps the
    chunk-boundary states, the backward (:func:`wkv_bwd`) restores each
    chunk's states from them."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk):
        out, s_t, bounds = _forward(r, k, v, w, u, s0, None, chunk)
        ctx.save_for_backward(r, k, v, w, u, bounds)
        ctx.chunk = chunk
        ctx.dtypes = [a.dtype for a in (r, k, v, w, u, s0)]
        return out, s_t

    @staticmethod
    def backward(ctx, dout, ds_t):
        r, k, v, w, u, bounds = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        grads = wkv_bwd(r, k, v, w, u, bounds, dout, ds_t, ctx.chunk)
        return (*(g.to(dt) for g, dt in zip(grads, ctx.dtypes)), None)


wkv.launches = 0
wkv_bwd.launches = 0
