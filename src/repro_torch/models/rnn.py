"""RNN / LSTM / GRU cells on the approximate Linear layer (port of
``repro.models.rnn``, paper §3.3.4): every gate GEMM goes through
:func:`~repro_torch.core.approx_ops.approx_dense`.

Parameters are plain dicts with the reference's names and layouts (``wx``
(D, G*H), ``wh`` (H, G*H), ``b`` (G*H,)); :func:`load_jax_params` carries
the reference's over. :func:`lstm` walks the sequence in a Python loop where
the reference scans.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.approx_ops import ApproxConfig, approx_dense
from repro_torch.models.vision import _generator, _to, load_jax_params

__all__ = ["gru_cell", "init_gru", "init_lstm", "init_rnn",
           "load_jax_params", "lstm", "lstm_cell", "rnn_cell"]


def _init_cell(seed: int, d_in: int, d_hidden: int, gates: int,
               device) -> dict:
    """Random cell parameters from ``seed`` (a ``torch.Generator``; the
    numbers differ from the reference's ``jax.random`` init): normal
    weights scaled by ``(d_in + d_hidden) ** -0.5``, zero bias."""
    g = _generator(seed)
    s = (d_in + d_hidden) ** -0.5
    return _to({
        "wx": torch.randn((d_in, gates * d_hidden), generator=g) * s,
        "wh": torch.randn((d_hidden, gates * d_hidden), generator=g) * s,
        "b": torch.zeros(gates * d_hidden),
    }, device)


def init_lstm(seed: int, d_in: int, d_hidden: int, device=None) -> dict:
    return _init_cell(seed, d_in, d_hidden, 4, device)


def init_gru(seed: int, d_in: int, d_hidden: int, device=None) -> dict:
    return _init_cell(seed, d_in, d_hidden, 3, device)


def init_rnn(seed: int, d_in: int, d_hidden: int, device=None) -> dict:
    return _init_cell(seed, d_in, d_hidden, 1, device)


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, p: dict,
              acfg: Optional[ApproxConfig]
              ) -> tuple[torch.Tensor, torch.Tensor]:
    gates = approx_dense(x, p["wx"], None, acfg) + \
        approx_dense(h, p["wh"], p["b"], acfg)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm(xs: torch.Tensor, p: dict,
         acfg: Optional[ApproxConfig] = None) -> torch.Tensor:
    """xs: (B, S, D) -> final hidden state (B, H)."""
    b = xs.shape[0]
    dh = p["wh"].shape[0]
    h = torch.zeros((b, dh), dtype=xs.dtype, device=xs.device)
    c = torch.zeros((b, dh), dtype=xs.dtype, device=xs.device)
    for t in range(xs.shape[1]):
        h, c = lstm_cell(xs[:, t], h, c, p, acfg)
    return h


def gru_cell(x: torch.Tensor, h: torch.Tensor, p: dict,
             acfg: Optional[ApproxConfig]) -> torch.Tensor:
    gx = approx_dense(x, p["wx"], p["b"], acfg)
    gh = approx_dense(h, p["wh"], None, acfg)
    xr, xz, xn = torch.chunk(gx, 3, dim=-1)
    hr, hz, hn = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1 - z) * n + z * h


def rnn_cell(x: torch.Tensor, h: torch.Tensor, p: dict,
             acfg: Optional[ApproxConfig]) -> torch.Tensor:
    return torch.tanh(approx_dense(x, p["wx"], p["b"], acfg) +
                      approx_dense(h, p["wh"], None, acfg))
