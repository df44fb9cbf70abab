"""RWKV-6 "Finch" block (arXiv:2404.05892; port of ``repro.models.rwkv``):
attention-free time mix with data-dependent decay, and channel mix.

The eight projections (``Wr``, ``Wk``, ``Wv``, ``Wg``, ``Wo``, ``Wk_cm``,
``Wv_cm``, ``Wr_cm``) go through :func:`approx_dense`; the LoRA and decay
products stay plain ``@``, as the reference computes them outside any
kernel. The WKV recurrence runs kernel 12 (``kernels/wkv``) for a prefill
(T = S) and a decode step (T = 1) alike: the reference's one-step decode
and its chunked scan compute the same steps, and its chunking only bounds
what a backward pass saves. Without a cache and with a gradient wanted,
kernel 12 keeps the state before every ``rwkv_chunk`` steps and its
backward (``csrc/wkv_bwd.cu`` on the card) restores each chunk from there,
as the reference's checkpointed chunk scan does.

State per layer: time-mix shift (B, 1, D), wkv state (B, H, hd, hd)
float32, channel-mix shift (B, 1, D). Given a state (views of the cache),
the block writes the new one into it in place and returns those views;
without one it returns fresh tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.approx_ops import ApproxConfig, approx_dense
from repro_torch.kernels.wkv.ops import wkv
from repro_torch.models.layers import layer_norm, silu


class RwkvState(NamedTuple):
    tm_shift: torch.Tensor   # (B, 1, D)
    wkv: torch.Tensor        # (B, H, hd, hd) float32
    cm_shift: torch.Tensor   # (B, 1, D)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``, each op rounded in ``x``'s dtype, as the
    reference's ``jax.nn.sigmoid`` lowers (see ``layers.silu``)."""
    return 1 / (1 + torch.exp(-x))


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """The x_{t-1} stream: ``x`` shifted right by one along time, seeded by
    the state's last row (zeros without one)."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev.to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _lora_mix(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor,
              a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Finch's data-dependent token shift: lerp(x, x_prev, mu +
    lora(x_mix))."""
    mu = mu.to(x.dtype)[None, None, :]
    xmix = x + (xs - x) * mu
    lora = torch.tanh(xmix @ a) @ b
    m = mu + lora.to(x.dtype)
    return x + (xs - x) * m


def time_mix(x: torch.Tensor, p: dict, cfg, acfg: Optional[ApproxConfig],
             *, state: Optional[RwkvState]):
    """Returns ``(out, new_shift, S_T)``; with a state, ``S_T`` is written
    into ``state.wkv`` in place."""
    b, s, d = x.shape
    h = cfg.rwkv_n_heads
    hd = d // h
    xs = _shift(x, state.tm_shift if state is not None else None)
    new_shift = x[:, -1:]

    def mix(name):
        return _lora_mix(x, xs, p[f"mu_{name}"], p["lora_A"],
                         p[f"lora_B_{name}"])

    r_in, k_in, v_in, g_in, w_in = (mix(n) for n in "rkvgw")
    r = approx_dense(r_in, p["Wr"], None, acfg).reshape(b, s, h, hd)
    k = approx_dense(k_in, p["Wk"], None, acfg).reshape(b, s, h, hd)
    v = approx_dense(v_in, p["Wv"], None, acfg).reshape(b, s, h, hd)
    g = silu(approx_dense(g_in, p["Wg"], None, acfg))
    # data-dependent per-channel decay in (0, 1)
    dw = (w_in @ p["Wdecay_A"]) @ p["Wdecay_B"]
    w = torch.exp(-torch.exp((p["decay_base"][None, None] + dw)
                             .to(torch.float32))).reshape(b, s, h, hd)
    u = p["bonus"].reshape(h, hd)
    if state is not None:
        s0, s_out = state.wkv, state.wkv
    else:
        s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=x.device)
        s_out = None
    y, s_new = wkv(r.to(torch.float32), k.to(torch.float32),
                   v.to(torch.float32), w, u, s0, state_out=s_out,
                   chunk=cfg.rwkv_chunk)

    # per-head group norm, then the gate
    c = y - y.mean(-1, keepdim=True)
    y = c * torch.rsqrt((c * c).mean(-1, keepdim=True) + 1e-5)
    y = (y * p["ln_w"].reshape(h, hd)[None, None]
         + p["ln_b"].reshape(h, hd)[None, None])
    y = y.reshape(b, s, d).to(x.dtype) * g
    return approx_dense(y, p["Wo"], None, acfg), new_shift, s_new


def channel_mix(x: torch.Tensor, p: dict, cfg,
                acfg: Optional[ApproxConfig], *,
                state: Optional[RwkvState]):
    xs = _shift(x, state.cm_shift if state is not None else None)
    new_shift = x[:, -1:]
    xk = x + (xs - x) * p["cm_mu_k"].to(x.dtype)[None, None, :]
    xr = x + (xs - x) * p["cm_mu_r"].to(x.dtype)[None, None, :]
    k = torch.square(torch.relu(approx_dense(xk, p["Wk_cm"], None, acfg)))
    kv = approx_dense(k, p["Wv_cm"], None, acfg)
    return sigmoid(approx_dense(xr, p["Wr_cm"], None, acfg)) * kv, new_shift


def rwkv_block(x: torch.Tensor, p: dict, cfg,
               acfg: Optional[ApproxConfig], *,
               state: Optional[RwkvState] = None):
    """Pre-norm time mix + channel mix; returns ``(y, new_state)``. A
    decode step is a call with T = 1 (the reference's ``decode`` flag
    selects the same arithmetic)."""
    h1 = layer_norm(x, p["ln1_w"], p["ln1_b"])
    att, tm_shift, s_new = time_mix(h1, p, cfg, acfg, state=state)
    x = x + att
    h2 = layer_norm(x, p["ln2_w"], p["ln2_b"])
    ffn, cm_shift = channel_mix(h2, p, cfg, acfg, state=state)
    x = x + ffn
    if state is None:
        return x, RwkvState(tm_shift=tm_shift, wkv=s_new, cm_shift=cm_shift)
    state.tm_shift.copy_(tm_shift)
    state.cm_shift.copy_(cm_shift)
    return x, state
