"""Shared model building blocks (port of ``repro.models.layers``).

Every GEMM goes through :func:`repro_torch.core.approx_ops.approx_dense`
(``acfg=None`` is the exact float path), and attention over a KV cache goes
through :func:`~repro_torch.core.approx_ops.approx_attention` /
``approx_attention_paged`` when the ACU plan resolves to a kernel. Exact
attention with ``impl="flash"`` runs the exact flash attention kernel
(kernel 11) where its semantics hold (:func:`gqa_attention`). Norms, RoPE
(and Qwen2-VL's M-RoPE) and the softmax keep the reference's float32
upcasts.

Unlike the reference's pure functions, the attention block writes new K/V
into the cache tensors it is given, in place, and returns the same
tensors: a cache of 30 layers is never copied to append one token.
Cross-attention (``kv=``, the enc-dec decoder's) projects K and V from the
encoder output on every call, as the reference does, and takes the exact
:func:`gqa_attention`, non-causal, with or without an ACU: the
reference's approximate attention route is for cached self-attention
only.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.approx_ops import (ApproxConfig, approx_attention,
                                         approx_attention_paged,
                                         approx_dense, conv2d, exact_f32)
from repro_torch.kernels.flash_attention.ops import flash_attention

NEG_INF = -1e30


def conv2d_block(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None, *, stride=(1, 1),
                 padding="SAME", dilation=(1, 1), groups: int = 1,
                 acfg: Optional[ApproxConfig] = None,
                 activation=None) -> torch.Tensor:
    """Conv2d + optional bias + optional activation, the shared conv call
    site of every vision model. The route is resolved per layer by
    :func:`repro_torch.core.acu.conv_plan`; ``acfg=None`` is the exact
    float conv."""
    y = conv2d(x, w, b, stride=stride, padding=padding, dilation=dilation,
               groups=groups, cfg=acfg)
    return y if activation is None else activation(y)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in float32; ``plus_one`` = gemma-style (1 + w)."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = scale.to(torch.float32)
    if plus_one:
        w = 1.0 + w
    return (y * w).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int. Rotates the two halves of
    the head dim, in float32."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotates the two halves of x's head dim by (B, S, D/2) ``angles``,
    in float32."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections=(16, 24, 24), theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (B, S, H, D); positions: (3, B, S),
    the (temporal, height, width) ids. The D/2 rotary channels are split
    into ``sections``, each rotated by its own position stream; for text
    all three streams are equal and M-RoPE is RoPE."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    sec = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                     for i, n in enumerate(sections)])            # (D/2,)
    pos = positions.to(torch.float32).permute(1, 2, 0)[..., sec]  # (B, S, D/2)
    return _rotate(x, pos * freqs)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _mask_scores(s: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
                 causal: bool, window: Optional[int],
                 pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mask (B, Hkv, rep, cq, Tk) scores to ``NEG_INF``. ``q_pos`` is (cq,)
    or, with a query position per batch row, (B, cq); ``pad_mask`` (B, Tk)
    marks valid keys."""
    if q_pos.dim() == 2:
        mask = torch.ones((q_pos.shape[0], *s.shape[-2:]), dtype=torch.bool,
                          device=s.device)
        if causal:
            mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
        if window is not None:
            mask = mask & (k_pos[None, None, :] > q_pos[:, :, None] - window)
        if pad_mask is not None:
            mask = mask & pad_mask[:, None, :]
        return torch.where(mask[:, None, None], s, NEG_INF)
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    if pad_mask is not None:
        return torch.where(mask[None, None, None]
                           & pad_mask[:, None, None, None, :], s, NEG_INF)
    return torch.where(mask, s, NEG_INF)


def _flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset,
                pad_mask: Optional[torch.Tensor]) -> bool:
    """Whether an ``impl="flash"`` call has kernel 11's semantics: queries
    at key 0 (``q_offset`` the int 0), no padded keys, and no gradient
    wanted (the reference's kernel has no backward). Decided from the
    arguments alone."""
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return (isinstance(q_offset, int) and q_offset == 0 and pad_mask is None
            and not wants_grad)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None, q_offset=0,
                  chunk: int = 512, impl: str = "chunked",
                  causal_blocking: bool = False,
                  pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact grouped-query attention in float32.

    q: (B, S, Hq, D); k/v: (B, T, Hkv, D); returns (B, S, Hq, D).
    ``q_offset``: absolute position of q[0] (an int, or a (B,) tensor when
    every row sits at its own cache position). ``chunked`` processes q in
    blocks of ``chunk``; ``pad_mask`` (B, T) bool marks valid keys.
    ``flash`` runs the exact flash attention kernel (kernel 11) on the
    (B, S, H, D) tensors as they lie where :func:`_flash_route` allows, and
    is ``chunked`` otherwise, as the reference's ``flash`` is."""
    if impl == "flash" and _flash_route(q, k, v, q_offset, pad_mask):
        return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window,
                               softcap=softcap).transpose(1, 2)
    b, s_len, hq, d = q.shape
    t_len, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, s_len, hkv, rep, d)
    per_row = isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1
    dev = q.device

    def q_positions(start: int, length: int) -> torch.Tensor:
        pos = torch.arange(length, device=dev) + start
        if per_row:
            return pos[None, :] + q_offset.to(dev)[:, None]
        return pos + q_offset

    def block(q_blk, q_pos, k_blk, v_blk, k_pos, pm):
        with exact_f32():
            sc = torch.einsum("bqhrd,bthd->bhrqt", q_blk.to(torch.float32),
                              k_blk.to(torch.float32)) * scale
            if softcap is not None:
                sc = softcap * torch.tanh(sc / softcap)
            sc = _mask_scores(sc, q_pos, k_pos, causal, window, pm)
            p = torch.softmax(sc, dim=-1)
            return torch.einsum("bhrqt,bthd->bqhrd", p,
                                v_blk.to(torch.float32))

    k_all = torch.arange(t_len, device=dev)
    if impl == "naive" or s_len <= chunk or s_len % chunk != 0:
        out = block(qg, q_positions(0, s_len), k, v, k_all, pad_mask)
    else:
        outs = []
        for i in range(s_len // chunk):
            q_blk = qg[:, i * chunk:(i + 1) * chunk]
            pos = q_positions(i * chunk, chunk)
            if causal_blocking and causal and isinstance(q_offset, int) \
                    and q_offset == 0 and s_len == t_len:
                hi = (i + 1) * chunk
                lo = max(0, i * chunk - window) if window is not None else 0
                outs.append(block(q_blk, pos, k[:, lo:hi], v[:, lo:hi],
                                  k_all[lo:hi],
                                  None if pad_mask is None
                                  else pad_mask[:, lo:hi]))
            else:
                outs.append(block(q_blk, pos, k, v, k_all, pad_mask))
        out = torch.cat(outs, dim=1)
    return out.reshape(b, s_len, hq, d).to(q.dtype)


def _row_positions(cache_pos, b: int, device) -> torch.Tensor:
    """``cache_pos`` (an int, a 0-d or a (B,) tensor) as a (B,) int64
    tensor (an int is filled on the device: no host-to-device copy)."""
    if isinstance(cache_pos, int):
        return torch.full((b,), cache_pos, dtype=torch.int64, device=device)
    return torch.as_tensor(cache_pos, dtype=torch.int64,
                           device=device).reshape(-1).expand(b)


def attention_block(x: torch.Tensor, p: dict, cfg,
                    acfg: Optional[ApproxConfig], positions: torch.Tensor, *,
                    kv: Optional[torch.Tensor] = None, cache=None,
                    cache_pos=None, window: Optional[int] = None,
                    causal: bool = True,
                    pad_mask: Optional[torch.Tensor] = None,
                    page_table: Optional[torch.Tensor] = None):
    """Full attention sub-layer: qkv proj -> rope -> attention -> out proj.

    ``cache``: optional (k_cache, v_cache) of shape (B, Smax, Hkv, D),
    written in place at ``cache_pos`` (an int, or a (B,) tensor: every row
    at its own position); returns (out, cache). ``pad_mask``: (B, Smax)
    bool, False keys never attended. ``kv`` (B, T, D): cross-attention
    to it (K and V projected from it, no RoPE, no cache, exact and
    non-causal whatever ``causal`` and ``acfg`` say); returns (out, None).

    ``page_table`` (B, n_logical) switches to the block-paged layout:
    ``cache`` is then (k_pool, v_pool) of shape (Hkv, P, block, D), decode
    writes each row's new K/V into its own tail block, prefill writes one
    block-aligned chunk of at most one block (batch 1), and attention reads
    through the table (kernel 9, or an exact gather when the plan is
    dense). ``pad_mask`` is ignored there.
    """
    b, s_len, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = approx_dense(x, p["wq"], p.get("bq"), acfg).reshape(b, s_len, h, hd)
    src = x if kv is None else kv
    t0 = src.shape[1]
    k = approx_dense(src, p["wk"], p.get("bk"), acfg).reshape(b, t0, hkv, hd)
    v = approx_dense(src, p["wv"], p.get("bv"), acfg).reshape(b, t0, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if kv is not None:
        # cross-attention: no RoPE, no cache, the exact non-causal path
        if cache is not None or page_table is not None:
            raise ValueError("cross-attention takes no cache")
    elif cfg.rope == "mrope":
        mpos = positions[None].expand(3, *positions.shape)
        q = apply_mrope(q, mpos, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, mpos, cfg.mrope_sections, cfg.rope_theta)
    elif cfg.rope != "none":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    use_acu = acfg is not None and not acfg.fake_quant_only

    if page_table is not None:
        if cache is None:
            raise ValueError("paged KV needs a (k_pool, v_pool) cache")
        kc, vc = cache
        blk = kc.shape[2]
        pt = torch.as_tensor(page_table, dtype=torch.int64, device=x.device)
        pos = _row_positions(cache_pos, b, x.device)
        if s_len == 1:
            # decode: each row writes its new K/V into its own tail block
            # (copy-on-write in the engine keeps tail blocks private)
            phys = torch.gather(pt, 1, (pos // blk)[:, None])[:, 0]
            off = pos % blk
            kc[:, phys, off] = k[:, 0].transpose(0, 1).to(kc.dtype)
            vc[:, phys, off] = v[:, 0].transpose(0, 1).to(vc.dtype)
        else:
            # block-aligned chunked prefill: one request, one chunk that
            # starts on a block boundary and fits inside one block
            if b != 1 or s_len > blk:
                raise ValueError(f"paged prefill takes one row and at most "
                                 f"one block ({b} rows, {s_len} > {blk})")
            phys = pt[0, pos[0] // blk]
            at = pos[0] % blk + torch.arange(s_len, device=x.device)
            kc[:, phys, at] = k[0].transpose(0, 1).to(kc.dtype)
            vc[:, phys, at] = v[0].transpose(0, 1).to(vc.dtype)
        rowinfo = torch.stack([pos, torch.zeros_like(pos), pos + s_len],
                              dim=1).to(torch.int32)
        fused = None
        if use_acu:
            fused = approx_attention_paged(
                q.transpose(1, 2), kc, vc, acfg, page_table=pt.to(torch.int32),
                rowinfo=rowinfo, causal=causal, window=window,
                softcap=cfg.softcap_attn)
        if fused is not None:
            out = fused.transpose(1, 2).to(q.dtype)
        else:
            # exact route: gather the referenced blocks back into a
            # contiguous (B, n_logical*block, Hkv, D) view, mask by length
            n_log = pt.shape[1]
            kg = kc[:, pt].reshape(hkv, b, n_log * blk, hd).movedim(0, 2)
            vg = vc[:, pt].reshape(hkv, b, n_log * blk, hd).movedim(0, 2)
            pm = (torch.arange(n_log * blk, device=x.device)[None, :]
                  < (pos + s_len)[:, None])
            out = gqa_attention(q, kg, vg, causal=causal,
                                softcap=cfg.softcap_attn, window=window,
                                q_offset=pos, chunk=cfg.attn_chunk,
                                impl=cfg.attn_impl, pad_mask=pm)
        out = out.reshape(b, s_len, h * hd)
        return approx_dense(out, p["wo"], p.get("bo"), acfg), cache

    q_offset = 0
    if cache is not None:
        kc, vc = cache
        if isinstance(cache_pos, int):
            kc[:, cache_pos:cache_pos + s_len] = k.to(kc.dtype)
            vc[:, cache_pos:cache_pos + s_len] = v.to(vc.dtype)
            q_offset = cache_pos
        else:
            # every row writes at its own offset (continuous batching),
            # start clamped so the update fits, as dynamic_update_slice
            pos = _row_positions(cache_pos, b, x.device).clamp(
                0, kc.shape[1] - s_len)
            rows = torch.arange(b, device=x.device)[:, None]
            at = pos[:, None] + torch.arange(s_len, device=x.device)
            kc[rows, at] = k.to(kc.dtype)
            vc[rows, at] = v.to(vc.dtype)
            q_offset = torch.as_tensor(cache_pos, device=x.device)
        k, v = kc, vc

    if use_acu and cache is not None:
        rows_pos = _row_positions(cache_pos, b, x.device)
        if pad_mask is not None:
            # serving pads on the left: the first True marks the kv start
            kv_start = torch.argmax(pad_mask.to(torch.uint8), dim=1)
        else:
            kv_start = torch.zeros_like(rows_pos)
        rowinfo = torch.stack([rows_pos, kv_start, rows_pos + s_len],
                              dim=1).to(torch.int32)
        fused = approx_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), acfg,
            causal=causal, window=window, softcap=cfg.softcap_attn,
            rowinfo=rowinfo)
        if fused is not None:
            out = fused.transpose(1, 2).to(q.dtype).reshape(b, s_len, h * hd)
            return approx_dense(out, p["wo"], p.get("bo"), acfg), cache

    out = gqa_attention(q, k, v, causal=causal and kv is None, window=window,
                        softcap=cfg.softcap_attn, q_offset=q_offset,
                        chunk=cfg.attn_chunk, impl=cfg.attn_impl,
                        causal_blocking=cfg.attn_causal_blocking,
                        pad_mask=pad_mask)
    out = out.reshape(b, s_len, h * hd)
    return approx_dense(out, p["wo"], p.get("bo"), acfg), cache


# ---------------------------------------------------------------------------
# MLP, embedding, head
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh form) op by op: ``x * (0.5 * (1 + tanh(c * (x
    + 0.044715 * (x * x * x)))))`` with ``c = sqrt(2 / pi)``, each op
    rounded in ``x``'s dtype and both constants rounded to it first, as
    the reference's weakly typed scalars are (``F.gelu`` rounds a bfloat16
    activation once, and PyTorch keeps a Python scalar in float32)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    cube = (x * x) * x
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * cube))))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))``, each op rounded in ``x``'s dtype: the
    reference's ``jax.nn.silu`` lowers to exactly these steps, so a
    bfloat16 activation rounds four times, not once as ``F.silu``'s."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp_block(x: torch.Tensor, p: dict, cfg,
              acfg: Optional[ApproxConfig]) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or plain-GELU MLP."""
    if cfg.mlp_type in ("swiglu", "geglu"):
        gate = approx_dense(x, p["w_gate"], None, acfg)
        up = approx_dense(x, p["w_up"], None, acfg)
        act = silu(gate) if cfg.mlp_type == "swiglu" else gelu(gate)
        hidden = act * up
    else:
        hidden = gelu(approx_dense(x, p["w_up"], p.get("b_up"), acfg))
    return approx_dense(hidden, p["w_down"], p.get("b_down"), acfg)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def lm_head(x: torch.Tensor, w: torch.Tensor, acfg: Optional[ApproxConfig],
            softcap: Optional[float] = None) -> torch.Tensor:
    logits = approx_dense(x, w, None, acfg)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  n_valid_vocab: int) -> torch.Tensor:
    """Mean next-token cross entropy, ``logsumexp - gold`` in float32; the
    padded vocab columns get ``NEG_INF`` in the logits' dtype first, as in
    the reference."""
    v = logits.shape[-1]
    if n_valid_vocab < v:
        pad = torch.arange(v, device=logits.device) >= n_valid_vocab
        logits = logits.masked_fill(pad, NEG_INF)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
