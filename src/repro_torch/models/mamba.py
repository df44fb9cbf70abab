"""Mamba (S6 selective state space) block, the SSM layer of the Jamba hybrid
(port of ``repro.models.mamba``).

The four projections (``in_proj``, ``x_proj``, ``dt_proj``, ``out_proj``)
go through :func:`approx_dense`; the causal depthwise conv, the softplus,
the ``exp`` of the discretisation and the selective scan stay exact, as in
the reference (the recurrence is elementwise multiply-add work, not a
multiplier array). Every elementwise op follows the reference's op chain,
each rounded in the model's dtype: ``softplus`` is ``jax.nn.softplus``'s
``logaddexp(x, 0)``, not ``F.softplus``; ``silu`` is ``layers.silu``.

A prefill runs :func:`_ssm_scan`, the reference's
``jax.lax.associative_scan`` recursion reproduced op by op (so its float32
rounding is the reference's, step for step); a decode step (``decode`` and
T = 1) is one ``dA * h + dBx``.

State per layer: the causal conv's tail (B, d_conv - 1, d_inner) in the
model's dtype and the SSM state (B, d_inner, d_state) float32. Given a
state (views of the cache), the block writes the new one into it in place
and returns those views; without one it returns fresh tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.approx_ops import ApproxConfig, approx_dense, exact_f32
from repro_torch.models.layers import silu


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv - 1, d_inner): causal conv tail
    ssm: torch.Tensor    # (B, d_inner, d_state) float32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = ``max(x, 0) +
    log1p(exp(-|x|))`` (NaN passed through), each op rounded in ``x``'s
    dtype. ``F.softplus`` switches to ``x`` above a threshold of 20 and
    rounds once."""
    out = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, out)


def _combine(a1, b1, a2, b2):
    """Composes the affine maps (a1, b1) then (a2, b2): ``(a2 * a1, a2 * b1
    + b2)``, the multiply and the add rounded apart (no FMA), as the
    reference's ``combine``."""
    return a2 * a1, a2 * b1 + b2


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """``jax.lax.associative_scan(combine, (a, b), axis=1)`` op by op: pairs
    combined, the half-length scan by recursion, the even elements from
    the odd results, interleaved."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2],
                      b[:, 1::2])
    oa, ob = _assoc_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    out = []
    for first, even, odd in ((a, ea, oa), (b, eb, ob)):
        t = torch.empty_like(first)
        t[:, 0] = first[:, 0]
        t[:, 2::2] = even
        t[:, 1::2] = odd
        out.append(t)
    return out[0], out[1]


def _ssm_scan(dA: torch.Tensor, dBx: torch.Tensor,
              h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h_t = dA_t * h_{t-1} + dBx_t`` along axis 1 (time), as the
    reference's associative scan computes it. dA, dBx: (B, S, d_inner,
    d_state) float32; ``h0`` (B, d_inner, d_state) is folded into the
    first step (``dBx[:, 0] + dA[:, 0] * h0``) whatever its value."""
    if h0 is not None:
        dBx = dBx.clone()
        dBx[:, 0] = dBx[:, 0] + dA[:, 0] * h0
    return _assoc_scan(dA, dBx)[1]


def mamba_block(x: torch.Tensor, p: dict, cfg,
                acfg: Optional[ApproxConfig], *,
                state: Optional[MambaState] = None, decode: bool = False):
    """x: (B, S, D). Returns ``(y, state)``.

    p: in_proj (D, 2 d_inner), conv_w (d_conv, d_inner), conv_b (d_inner,),
    x_proj (d_inner, dt_rank + 2 d_state), dt_proj (dt_rank, d_inner),
    dt_bias (d_inner,), A_log (d_inner, d_state), Dskip (d_inner,),
    out_proj (d_inner, D)."""
    b, s, _ = x.shape
    d_inner, d_state = cfg.mamba_d_inner, cfg.mamba_d_state
    d_conv, dt_rank = cfg.mamba_d_conv, cfg.mamba_dt_rank

    xz = approx_dense(x, p["in_proj"], None, acfg)
    xs, z = xz[..., :d_inner], xz[..., d_inner:]

    # causal depthwise conv over time, seeded by the state's tail
    pad = (torch.zeros((b, d_conv - 1, d_inner), dtype=xs.dtype,
                       device=xs.device) if state is None
           else state.conv.to(xs.dtype))
    conv_in = torch.cat([pad, xs], dim=1)        # (B, d_conv - 1 + S, di)
    new_conv = conv_in[:, -(d_conv - 1):]
    xc = sum(conv_in[:, w:w + s] * p["conv_w"][w][None, None, :]
             for w in range(d_conv))
    xc = silu(xc + p["conv_b"][None, None, :])

    # input-dependent SSM parameters
    xdbc = approx_dense(xc, p["x_proj"], None, acfg)
    dt_r = xdbc[..., :dt_rank]
    bmat = xdbc[..., dt_rank:dt_rank + d_state]
    cmat = xdbc[..., dt_rank + d_state:]
    dt = softplus(approx_dense(dt_r, p["dt_proj"], p["dt_bias"], acfg))
    A = -torch.exp(p["A_log"].to(torch.float32))                 # (di, ds)
    dA = torch.exp(dt[..., None].to(torch.float32) * A[None, None])
    dBx = ((dt * xc)[..., None].to(torch.float32)
           * bmat[:, :, None, :].to(torch.float32))        # (B, S, di, ds)

    h0 = state.ssm if state is not None else None
    if decode and s == 1:
        h_prev = h0 if h0 is not None else torch.zeros_like(dA[:, 0])
        h_last = dA[:, 0] * h_prev + dBx[:, 0]
        h = h_last[:, None]
    else:
        h = _ssm_scan(dA, dBx, h0)
        h_last = h[:, -1]

    with exact_f32():
        y = torch.einsum("btdn,btn->btd", h, cmat.to(torch.float32))
    y = y.to(x.dtype) + xc * p["Dskip"][None, None, :]
    y = y * silu(z)
    out = approx_dense(y, p["out_proj"], None, acfg)
    if state is None:
        return out, MambaState(conv=new_conv, ssm=h_last)
    state.conv.copy_(new_conv)
    state.ssm.copy_(h_last)
    return out, state
