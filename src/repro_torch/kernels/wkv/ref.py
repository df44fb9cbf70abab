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


# the CUDA kernels' loops (csrc/wkv.cu's sequence kernel, csrc/wkv_bwd.cu),
# mirrored by wkv_tiled_ref and wkv_bwd_tiled_ref
SUB = 16          # steps of a sub-chunk, whose states the backward restores
LANES = 16        # lanes sharing a row of S (dr, dw, dk) or a column (dv,
                  # out), each over a run of hd / 16 entries


def _in_order(x: torch.Tensor) -> torch.Tensor:
    """Sums the last axis in order, as one register accumulator does."""
    acc = torch.zeros_like(x[..., 0])
    for e in range(x.shape[-1]):
        acc = acc + x[..., e]
    return acc


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """The kernels' sum over the last axis (hd): each of ``LANES`` lanes
    over its run of hd / 16 in order, then the lanes as the shuffle levels
    8, 4, 2, 1 of ``wkv_reduce16`` add them (halves first)."""
    p = _in_order(x.reshape(*x.shape[:-1], LANES, -1))
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p[..., 0]


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """The backward's row sum over the last axis (hd): each of ``LANES``
    lanes over its run of hd / 16 in order, lane l and l + 8 added (the
    one shuffle level), then those 8 sums in order from 0."""
    p = _in_order(x.reshape(*x.shape[:-1], LANES, -1))
    return _in_order(p[..., :LANES // 2] + p[..., LANES // 2:])


def wkv_tiled_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                  chunk: Optional[int] = None):
    """:func:`wkv_ref` in the CUDA sequence kernel's order (every call with
    T > 1), for the tests: the same arguments and results. The state and
    the chunk-boundary states round as :func:`wkv_ref`'s, bit for bit;
    ``out_v`` sums ``r_k a[k, v]`` over each lane's hd/16 rows in order,
    then over the column's 16 lanes (:func:`_lane_sum`)."""
    bh, t_len, hd = r.shape
    uu = _bonus(u, bh)
    s = s0.to(torch.float32)
    outs, bounds = [], []
    for t in range(t_len):
        if chunk is not None and t % chunk == 0:
            bounds.append(s)
        kv = k[:, t, :, None] * v[:, t, None, :]
        a = s + uu * kv
        outs.append(_lane_sum((r[:, t, :, None] * a).transpose(1, 2)))
        s = w[:, t, :, None] * s + kv
    out = torch.stack(outs, 1) if outs else r.new_zeros(bh, 0, hd)
    if chunk is None:
        return out, s
    if not bounds:
        bounds.append(s)
    return out, s, torch.stack(bounds)


def wkv_bwd_tiled_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, bounds: torch.Tensor,
                      dout: torch.Tensor, ds_t: Optional[torch.Tensor],
                      chunk: int, *, keep_states: bool = False):
    """:func:`wkv_bwd_ref` in the CUDA backward's loop, for the tests: the
    same arguments and results (and, with ``keep_states``, every restored
    state ``S_{t-1}`` as (B*H, T, hd, hd) last).

    Chunks in reverse; in each, pass 1 runs the chunk forward from its
    boundary and keeps the state before every ``SUB``-step sub-chunk; pass 2
    takes the sub-chunks in reverse, restores each one's states from its
    slot and walks them back. Row sums (dr, dw, dk and v.dout) run as
    :func:`_row_sum`, dv's column sum of ``k dkv`` as :func:`_lane_sum`;
    dr adds ``u k (v.dout)``, du ``k r (v.dout)``, summed by step of the
    sub-chunk and then over those 16 slots.
    The states round as the forward's, so they are its own bit for bit;
    the kernel's FMAs round the gradients' terms once where this rounds
    twice."""
    bh, t_len, hd = r.shape
    h = u.shape[0]
    uu = _bonus(u, bh)[..., 0]                            # (bh, hd)
    ds = (torch.zeros_like(bounds[0]) if ds_t is None
          else ds_t.to(torch.float32).clone())
    dr, dk, dv, dw = (torch.zeros_like(r, dtype=torch.float32)
                      for _ in range(4))
    # du's terms by step of the sub-chunk, each slot over the sub-chunks in
    # the walk's order; the slots summed in order at the end
    du_slots = torch.zeros(SUB, bh, hd, dtype=torch.float32,
                           device=r.device)
    states = (torch.empty(bh, t_len, hd, hd, dtype=torch.float32,
                          device=r.device) if keep_states else None)

    def advance(s, t):
        return w[:, t, :, None] * s + k[:, t, :, None] * v[:, t, None, :]

    for c in range(n_chunks(t_len, chunk) - 1, -1, -1):
        t0, t1 = c * chunk, min(t_len, (c + 1) * chunk)
        nq = -(-(t1 - t0) // SUB)
        slots, s = [bounds[c]], bounds[c]               # pass 1
        for q in range(nq - 1):
            for t in range(t0 + q * SUB, t0 + (q + 1) * SUB):
                s = advance(s, t)
            slots.append(s)
        for q in range(nq - 1, -1, -1):                 # pass 2
            ta = t0 + q * SUB
            n = min(SUB, t1 - ta)
            st = [slots[q]]
            for t in range(ta, ta + n - 1):
                st.append(advance(st[-1], t))
            for t in range(ta + n - 1, ta - 1, -1):
                s_prev = st[t - ta]
                if states is not None:
                    states[:, t] = s_prev
                g, vt = dout[:, t], v[:, t]
                rt, kt, wt = r[:, t], k[:, t], w[:, t]
                rg = rt[:, :, None] * g[:, None, :]
                dkv = ds + uu[:, :, None] * rg
                vg = _row_sum(vt * g)[:, None]
                dr[:, t] = _row_sum(s_prev * g[:, None, :]) + uu * kt * vg
                dw[:, t] = _row_sum(s_prev * ds)
                dk[:, t] = _row_sum(dkv * vt[:, None, :])
                du_slots[t - ta] += kt * rt * vg
                dv[:, t] = _lane_sum((kt[:, :, None] * dkv).transpose(1, 2))
                ds = wt[:, :, None] * ds + rg
    du = _in_order(du_slots.permute(1, 2, 0)).reshape(bh // h, h, hd).sum(0)
    res = (dr, dk, dv, dw, du, ds)
    return res + (states,) if keep_states else res


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
