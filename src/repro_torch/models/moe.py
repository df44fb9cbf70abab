"""Mixture-of-Experts layer (port of ``repro.models.moe``): top-k router and
block-local capacity dispatch, single device.

Tokens are grouped into ``nb`` dispatch blocks (the active mesh
context's ``pod`` x ``data`` ways, 16 when no mesh is active, halved until
it divides the token count); each block routes into its own
``(E, cap)`` capacity buffers, slots taken first come first served in
token-major, k-minor order, assignments past ``cap`` dropped. Under an
:class:`ApproxConfig` the three expert projections run as one grouped
ragged GEMM each (:func:`~repro_torch.core.approx_ops.approx_grouped_dense`,
kernel 10 on the card) over all ``nb * E`` buffers; the exact path is a
float einsum, and QAT (``fake_quant_only``) keeps the per-expert
:func:`~repro_torch.core.approx_ops.approx_dense` composition. The
reference's sharding annotations have no counterpart.

Dispatch (:func:`dispatch`) and combine (:func:`combine`) are separate
functions, so a test can feed the reference's routing into them. MoE
outputs depend on the batch: capacity is per dispatch block, and padding
rows are routed like any other.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.approx_ops import (ApproxConfig, approx_dense,
                                         approx_grouped_dense, exact_f32)
from repro_torch.core.quantization import device_scalar
from repro_torch.models.layers import silu
from repro_torch.parallel.sharding import current_mesh_context


def _route(xf: torch.Tensor, router: torch.Tensor, k: int):
    """Router products: full softmax probabilities (T, E) and the
    renormalized top-k weights and expert indices (T, k). Ties go to the
    lower expert index, as ``jax.lax.top_k`` breaks them (a stable
    descending sort)."""
    with exact_f32():
        gate_logits = xf.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(gate_logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, top_e


def _mean0(t: torch.Tensor) -> torch.Tensor:
    """Float32 mean over dim 0 as the reference's compiled ``mean`` takes
    it: the sum times the float32 reciprocal of the count."""
    inv = np.float32(1.0) / np.float32(t.shape[0])
    return t.to(torch.float32).sum(0) * device_scalar(inv, t.device)


def _aux_loss(probs: torch.Tensor, top_e: torch.Tensor,
              n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss from the routing in hand: ``E *
    sum(frac_tokens_per_expert * mean_router_prob_per_expert)``."""
    onehot = torch.nn.functional.one_hot(top_e, n_experts)
    frac_tokens = _mean0(onehot.reshape(-1, n_experts))
    frac_probs = _mean0(probs.reshape(-1, n_experts))
    return n_experts * torch.sum(frac_tokens * frac_probs)


def _expert_ffn(xe: torch.Tensor, p: dict, acfg: Optional[ApproxConfig],
                counts: torch.Tensor) -> torch.Tensor:
    """(nb, E, C, D) -> (nb, E, C, D) through the gated expert FFN.
    ``counts`` (nb, E): live rows of each capacity buffer. With an
    approximate config the three projections are grouped ragged GEMMs whose
    dead rows come back exactly 0.0."""
    if acfg is None:
        with exact_f32():
            gate = torch.einsum("becd,edf->becf", xe, p["w_gate"])
            up = torch.einsum("becd,edf->becf", xe, p["w_up"])
            return torch.einsum("becf,efd->becd", silu(gate) * up,
                                p["w_down"])
    nb, e, cap, d = xe.shape
    if not acfg.fake_quant_only:
        xg = xe.reshape(nb * e, cap, d)
        cnt = counts.reshape(nb * e)
        gate = approx_grouped_dense(xg, p["w_gate"], acfg, cnt)
        up = approx_grouped_dense(xg, p["w_up"], acfg, cnt)
        y = approx_grouped_dense(silu(gate) * up, p["w_down"], acfg, cnt)
        return y.reshape(nb, e, cap, d)

    def one(xb, i):      # each (block, expert) slice calibrates its own
        h = silu(approx_dense(xb, p["w_gate"][i], None, acfg)) * \
            approx_dense(xb, p["w_up"][i], None, acfg)
        return approx_dense(h, p["w_down"][i], None, acfg)

    return torch.stack([torch.stack([one(xe[b, i], i) for i in range(e)])
                        for b in range(nb)])


def _dispatch_blocks(cfg, t: int) -> int:
    """Number of data-aligned dispatch blocks (1 disables block locality):
    the product of the active mesh context's ``pod`` and ``data`` axes, 16
    without a context, halved until it divides ``t``."""
    if not cfg.moe_shard_dispatch:
        return 1
    ctx = current_mesh_context()
    nb = 16 if ctx is None else math.prod(
        ctx.mesh.shape[a] for a in ("pod", "data") if a in ctx.mesh.axis_names)
    while t % nb != 0 or nb > t:
        nb //= 2
    return max(nb, 1)


def dispatch_geometry(cfg, t: int) -> dict:
    """Static dispatch geometry for ``t`` tokens: the resolved block count,
    tokens per block and per-block capacity (Python's half-to-even
    ``round``, as the reference)."""
    e, k = cfg.n_experts, cfg.moe_top_k
    nb = _dispatch_blocks(cfg, t)
    tb = t // nb
    cap = int(max(1, round(tb * k / e * cfg.moe_capacity)))
    return {"n_blocks": nb, "tokens_per_block": tb, "capacity": cap,
            "n_experts": e, "top_k": k,
            "capacity_factor": cfg.moe_capacity}


def dispatch(xf: torch.Tensor, top_e: torch.Tensor, geo: dict):
    """Scatter (T, D) tokens into per-block capacity buffers.

    Returns ``xe`` (nb, E, cap, D) (empty slots 0, by a multiply in
    ``xf``'s dtype), ``counts`` (nb, E) int32 live rows, ``keep`` (nb,
    T/nb * k) whether each assignment found a slot, and ``src`` (nb, T/nb *
    k) its slot in the flattened ``(E * cap)`` buffers of its block."""
    nb, tb, cap = geo["n_blocks"], geo["tokens_per_block"], geo["capacity"]
    e, k = geo["n_experts"], geo["top_k"]
    d = xf.shape[-1]
    dev = xf.device
    flat_e = top_e.reshape(nb, tb * k)
    onehot = torch.nn.functional.one_hot(flat_e, e).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    slot = torch.gather(pos_in_e, 2, flat_e[..., None])[..., 0]
    keep = slot < cap
    dest = torch.where(keep, flat_e * cap + slot, e * cap)
    counts = torch.clamp_max(onehot.sum(1, dtype=torch.int32), cap)
    tok = torch.arange(tb * k, device=dev, dtype=torch.int32) // k
    idx_buf = torch.zeros((nb, e * cap + 1), dtype=torch.int32, device=dev)
    idx_buf.scatter_(1, dest.long(), (tok + 1)[None].expand(nb, -1)
                     .contiguous())
    idx_buf = idx_buf[:, :-1]                              # (nb, E*cap)
    xfb = xf.reshape(nb, tb, d)
    xe = torch.gather(xfb, 1, torch.clamp_min(idx_buf.long() - 1, 0)[..., None]
                      .expand(nb, e * cap, d))
    xe = xe * (idx_buf > 0)[..., None].to(xf.dtype)
    return (xe.reshape(nb, e, cap, d), counts, keep,
            torch.where(keep, flat_e * cap + slot, 0))


def combine(ye: torch.Tensor, keep: torch.Tensor, src: torch.Tensor,
            top_p: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """Gather each kept assignment's expert output (dropped ones give 0)
    and sum the top-k weighted outputs of every token. The product rounds
    in ``ye``'s dtype; the k-sum runs in float32, in order, from 0, and
    rounds once at the end (what ``jnp.sum`` does with bfloat16)."""
    nb, e, cap, d = ye.shape
    yk = torch.gather(ye.reshape(nb, e * cap, d), 1,
                      src.long()[..., None].expand(nb, src.shape[1], d))
    yk = torch.where(keep[..., None], yk, 0.0).reshape(t, k, d)
    prod = (yk * top_p[:, :, None].to(yk.dtype)).to(torch.float32)
    out = torch.zeros((t, d), dtype=torch.float32, device=ye.device)
    for j in range(k):
        out = out + prod[:, j]
    return out.to(ye.dtype)


def moe_block(x: torch.Tensor, p: dict, cfg,
              acfg: Optional[ApproxConfig], *, return_stats: bool = False):
    """x: (B, S, D) -> (B, S, D), or ``(out, stats)`` with
    ``return_stats=True``.

    p: ``router`` (D, E) float32; ``w_gate``/``w_up`` (E, D, F); ``w_down``
    (E, F, D). stats: ``aux_loss``, the Switch load-balancing loss from the
    routing softmax already in hand (equal to :func:`router_aux_loss`), and
    ``dropped_frac``, the fraction of the T*k assignments dropped by the
    capacity limit (float32)."""
    b, s, d = x.shape
    k = cfg.moe_top_k
    t = b * s
    xf = x.reshape(t, d)
    probs, top_p, top_e = _route(xf, p["router"], k)
    geo = dispatch_geometry(cfg, t)
    xe, counts, keep, src = dispatch(xf, top_e, geo)
    ye = _expert_ffn(xe, p, acfg, counts)
    out = combine(ye, keep, src, top_p, t, k).reshape(b, s, d)
    if not return_stats:
        return out
    stats = {"aux_loss": _aux_loss(probs, top_e, cfg.n_experts),
             "dropped_frac": 1.0 - _mean0(keep.reshape(-1))}
    return out, stats


def router_aux_loss(x: torch.Tensor, router: torch.Tensor, n_experts: int,
                    top_k: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (shares
    :func:`_route`/:func:`_aux_loss` with :func:`moe_block`'s stats)."""
    xf = x.reshape(x.shape[0] * x.shape[1], -1)
    probs, _, top_e = _route(xf, router, top_k)
    return _aux_loss(probs, top_e, n_experts)
