"""Plain PyTorch version of the RWKV-6 WKV recurrence (oracle of the
kernel), in the reference ``wkv_kernel``'s contract:

    kv_t  = k_t^T v_t                       (hd, hd)
    out_t = r_t (S + u * kv_t)              (hd,)
    S     = diag(w_t) S + kv_t

``r``/``k``/``v``/``w``: (B*H, T, hd) float32, heads folded h-major (row
``b*H + h``); ``u``: (H, hd), row ``i`` takes ``u[i % H]``; ``s0``:
(B*H, hd, hd). A loop over t that rounds as the reference's ``time_mix``
step writes it: ``k*v``, then ``u*kv``, then ``S + u*kv``; ``w*S``, then
``+ kv``, each rounded on its own. The state is elementwise, so any
implementation that rounds the same way gives it bit for bit; ``out`` is a
k-sum, whose order is the only freedom (:func:`out_bound`).
"""
from __future__ import annotations

import torch


def _bonus(u: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, hd, 1): row ``i`` takes ``u[i % H]``."""
    h = u.shape[0]
    if rows % h:
        raise ValueError(f"{rows} rows are not a multiple of {h} heads")
    return u.to(torch.float32).repeat(rows // h, 1)[:, :, None]


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(out (B*H, T, hd), S_T (B*H, hd, hd))``, float32."""
    bh, t_len, hd = r.shape
    uu = _bonus(u, bh)
    s = s0.to(torch.float32)
    outs = []
    for t in range(t_len):
        kv = k[:, t, :, None] * v[:, t, None, :]
        a = s + uu * kv
        outs.append(torch.einsum("bk,bkv->bv", r[:, t], a))
        s = w[:, t, :, None] * s + kv
    return torch.stack(outs, 1), s


def out_bound(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
              ) -> torch.Tensor:
    """Per element of ``out``, how far two summation orders of the k-sum
    may land apart: ``hd * eps * sum_k |r_k * a[k, v]|`` (each order is
    within ``hd/2 * eps`` of the exact sum of the rounded terms; the states
    ``a`` are the same in both, bit for bit). (B*H, T, hd), float32."""
    bh, t_len, hd = r.shape
    eps = torch.finfo(torch.float32).eps
    uu = _bonus(u, bh)
    s = s0.to(torch.float32)
    sums = []
    for t in range(t_len):
        kv = k[:, t, :, None] * v[:, t, None, :]
        a = s + uu * kv
        sums.append((r[:, t, :, None] * a).abs().sum(1))
        s = w[:, t, :, None] * s + kv
    return hd * eps * torch.stack(sums, 1)
