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

from typing import Optional

import torch


def _bonus(u: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, hd, 1): row ``i`` takes ``u[i % H]``."""
    h = u.shape[0]
    if rows % h:
        raise ValueError(f"{rows} rows are not a multiple of {h} heads")
    return u.to(torch.float32).repeat(rows // h, 1)[:, :, None]


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
            chunk: Optional[int] = None):
    """Returns ``(out (B*H, T, hd), S_T (B*H, hd, hd))``, float32; with
    ``chunk``, also the chunk-boundary states ``(n_chunks, B*H, hd, hd)``,
    entry ``c`` the state before step ``c * chunk`` (entry 0 is ``s0``),
    which is what :func:`wkv_bwd_ref` restarts from."""
    bh, t_len, hd = r.shape
    uu = _bonus(u, bh)
    s = s0.to(torch.float32)
    outs, bounds = [], []
    for t in range(t_len):
        if chunk is not None and t % chunk == 0:
            bounds.append(s)
        kv = k[:, t, :, None] * v[:, t, None, :]
        a = s + uu * kv
        outs.append(torch.einsum("bk,bkv->bv", r[:, t], a))
        s = w[:, t, :, None] * s + kv
    out = torch.stack(outs, 1) if outs else r.new_zeros(bh, 0, hd)
    if chunk is None:
        return out, s
    if not bounds:
        bounds.append(s)
    return out, s, torch.stack(bounds)


def n_chunks(t_len: int, chunk: int) -> int:
    """Chunk-boundary states the forward keeps for ``t_len`` steps (at
    least one, ``s0``)."""
    return max(1, -(-t_len // chunk))


def wkv_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, bounds: torch.Tensor,
                dout: torch.Tensor, ds_t: Optional[torch.Tensor],
                chunk: int):
    """The recurrence's backward, as the reference's checkpointed chunked
    scan differentiates it (``models/rwkv.py``, ``rwkv_chunk``): time is
    walked in reverse, chunk by chunk; each chunk's states are restored
    from its saved boundary state (``bounds``, from
    ``wkv_ref(..., chunk=)``) by running the forward again, and dS is
    carried back through ``S_t = w_t * S_{t-1} + k_t v_t^T``:

        da     = r_t^T dout_t                 dr_t = a_t dout_t
        dkv    = dS_t + u * da                du  += sum_v kv_t * da
        dk_t   = dkv v_t                      dv_t = k_t dkv
        dw_t   = sum_v S_{t-1} * dS_t         dS_{t-1} = w_t * dS_t + da

    ``dout``: (B*H, T, hd); ``ds_t``: (B*H, hd, hd) or None (zero).
    Returns ``(dr, dk, dv, dw, du (H, hd), ds0)``, float32; ``du`` sums
    the per-row terms over batch rows in order."""
    bh, t_len, hd = r.shape
    h = u.shape[0]
    uu = _bonus(u, bh)
    ds = (torch.zeros_like(bounds[0]) if ds_t is None
          else ds_t.to(torch.float32).clone())
    grads = [torch.zeros_like(r, dtype=torch.float32) for _ in range(4)]
    dr, dk, dv, dw = grads
    du_rows = torch.zeros(bh, hd, dtype=torch.float32, device=r.device)
    for c in range(n_chunks(t_len, chunk) - 1, -1, -1):
        t0, t1 = c * chunk, min(t_len, (c + 1) * chunk)
        states, s = [], bounds[c]
        for t in range(t0, t1):          # restore the chunk's states
            states.append(s)
            s = w[:, t, :, None] * s + k[:, t, :, None] * v[:, t, None, :]
        for t in range(t1 - 1, t0 - 1, -1):
            s_prev = states[t - t0]
            kv = k[:, t, :, None] * v[:, t, None, :]
            a = s_prev + uu * kv
            da = r[:, t, :, None] * dout[:, t, None, :]
            dr[:, t] = (a * dout[:, t, None, :]).sum(-1)
            dkv = ds + uu * da
            du_rows += (kv * da).sum(-1)
            dk[:, t] = (dkv * v[:, t, None, :]).sum(-1)
            dv[:, t] = (dkv * k[:, t, :, None]).sum(-2)
            dw[:, t] = (s_prev * ds).sum(-1)
            ds = w[:, t, :, None] * ds + da
    du = du_rows.reshape(bh // h, h, hd).sum(0)
    return dr, dk, dv, dw, du, ds


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
