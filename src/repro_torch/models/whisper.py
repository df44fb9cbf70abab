"""Whisper-style encoder-decoder backbone (port of ``repro.models.whisper``;
the audio frontend is stubbed as in the reference: the encoder takes
post-conv frame embeddings (B, enc_ctx, D)).

Encoder: non-causal self-attention over the frames with sinusoidal
positions. Decoder: causal self-attention over a KV cache written in
place, then cross-attention to the encoder output, with learned positions.
Both stacks are Python loops over their layers where the reference scans.
Every GEMM goes through :func:`approx_dense`. The decoder's cached
self-attention takes the ACU's approximate attention (kernel 8) when the
plan resolves to it; the encoder's self-attention and the cross-attention
are always the exact ``gqa_attention``, as in the reference. Cross K and V
are projected from ``enc_out`` on every ``decode`` call: the reference
keeps no cross-KV cache, and neither does the port.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.approx_ops import ApproxConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_at, _norm, init_attn,
                                            init_mlp, param_makers)


def _sinusoid(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) float32 positions: ``sin`` then ``cos`` of ``pos * exp(-i *
    log(10000) / (d/2 - 1))``, ``log(10000)`` and the divide in float32 as
    the reference computes them."""
    dev = resolve_device(device)
    pos = torch.arange(n, device=dev, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, device=dev, dtype=torch.float32)[None, :]
    f32 = dict(dtype=torch.float32, device=dev)
    step = torch.log(torch.tensor(10000.0, **f32)) / torch.tensor(
        float(d // 2 - 1), **f32)
    ang = pos * torch.exp(-dim * step)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_params(seed: int, cfg: ModelConfig, device=None) -> dict:
    """Parameters from a seed, in the reference's tree, layout and scales:
    the encoder's ``attn``/``mlp``/``norm1``/``norm2`` stacked over
    ``n_enc_layers``, the decoder's ``self_attn``/``cross_attn`` (no QKV
    bias)/``mlp``/``norm1``/``norm_x``/``norm2`` over ``n_layers``;
    ``embed`` and ``lm_head`` at ``d**-0.5``, ``dec_pos`` at 0.01. Load the
    reference's own numbers with ``transformer.load_jax_params``."""
    dense, norm, dev = param_makers(seed, cfg, device)
    g_enc, g_dec = cfg.n_enc_layers, cfg.n_layers
    d, v = cfg.d_model, cfg.vocab_padded
    enc = {"attn": init_attn(dense, cfg, g_enc, dev),
           "mlp": init_mlp(dense, cfg, g_enc, dev),
           "norm1": norm(d, g_enc), "norm2": norm(d, g_enc)}
    dec = {"self_attn": init_attn(dense, cfg, g_dec, dev),
           "cross_attn": init_attn(dense, cfg, g_dec, dev, cross=True),
           "mlp": init_mlp(dense, cfg, g_dec, dev),
           "norm1": norm(d, g_dec), "norm_x": norm(d, g_dec),
           "norm2": norm(d, g_dec)}
    return {"embed": dense(v, d, scale=d ** -0.5),
            "dec_pos": dense(cfg.max_dec_pos, d, scale=0.01),
            "enc": enc, "dec": dec,
            "enc_norm": norm(d, 1), "final_norm": norm(d, 1),
            "lm_head": dense(d, v, scale=d ** -0.5)}


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig,
           acfg: Optional[ApproxConfig] = None) -> torch.Tensor:
    """frames: (B, enc_ctx, D) stub embeddings -> (B, enc_ctx, D)."""
    b, t, d = frames.shape
    x = frames + _sinusoid(t, d, frames.device).to(frames.dtype)[None]
    dummy_pos = torch.zeros((b, t), dtype=torch.int64, device=frames.device)
    for li in range(cfg.n_enc_layers):
        gp = _at(params["enc"], li)
        h = _norm(x, gp["norm1"], cfg)
        a, _ = L.attention_block(h, gp["attn"], cfg, acfg, dummy_pos,
                                 causal=False)
        x = x + a
        x = x + L.mlp_block(_norm(x, gp["norm2"], cfg), gp["mlp"], cfg,
                            acfg)
    return _norm(x, _at(params["enc_norm"], 0), cfg)


def _dec_positions(table: torch.Tensor, cache_pos, s: int) -> torch.Tensor:
    """Rows ``cache_pos .. cache_pos + s - 1`` of the learned positions,
    the start clamped to ``[0, len - s]`` as ``dynamic_slice`` clamps it (a
    tensor ``cache_pos`` is clamped on the device)."""
    n = table.shape[0]
    if isinstance(cache_pos, int):
        start = min(max(cache_pos, 0), n - s)
        return table[start:start + s]
    start = torch.as_tensor(cache_pos, device=table.device).reshape(())
    idx = start.clamp(0, n - s) + torch.arange(s, device=table.device)
    return table.index_select(0, idx)


def decode(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor,
           cfg: ModelConfig, *, acfg: Optional[ApproxConfig] = None,
           cache: Optional[dict] = None, cache_pos=0,
           last_only: bool = False):
    """tokens: (B, S) -> (logits (B, S, V) or (B, 1, V) with ``last_only``,
    cache); cross-attends to ``enc_out`` (B, T, D). ``cache`` (from
    :func:`init_cache`) is written in place at ``cache_pos`` (an int or a
    0-d tensor: every row at the same position)."""
    b, s = tokens.shape
    x = L.embed(tokens, params["embed"])
    x = x + _dec_positions(params["dec_pos"], cache_pos, s)[None]
    ar = torch.arange(s, device=tokens.device)[None, :]
    positions = (ar + cache_pos if isinstance(cache_pos, int) else
                 ar + torch.as_tensor(cache_pos, device=tokens.device))
    positions = positions.expand(b, s)
    kv = cache["groups"]["self"] if cache is not None else None
    for li in range(cfg.n_layers):
        gp = _at(params["dec"], li)
        sc = None if kv is None else _at(kv, li)
        h = _norm(x, gp["norm1"], cfg)
        a, _ = L.attention_block(h, gp["self_attn"], cfg, acfg, positions,
                                 cache=sc, cache_pos=cache_pos)
        x = x + a
        hx = _norm(x, gp["norm_x"], cfg)
        cx, _ = L.attention_block(hx, gp["cross_attn"], cfg, acfg, positions,
                                  kv=enc_out, causal=False)
        x = x + cx
        x = x + L.mlp_block(_norm(x, gp["norm2"], cfg), gp["mlp"], cfg,
                            acfg)
    if last_only:
        x = x[:, -1:]
    x = _norm(x, _at(params["final_norm"], 0), cfg)
    return L.lm_head(x, params["lm_head"], acfg), cache


def loss_fn(params: dict, frames: torch.Tensor, tokens: torch.Tensor,
            labels: torch.Tensor, cfg: ModelConfig,
            acfg: Optional[ApproxConfig] = None) -> torch.Tensor:
    """Mean next-token cross entropy of the cache-less decoder over the
    encoded frames."""
    enc_out = encode(params, frames, cfg, acfg)
    logits, _ = decode(params, tokens, enc_out, cfg, acfg=acfg)
    return L.cross_entropy(logits, labels, cfg.vocab_size)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> dict:
    """The decoder's self-attention cache, zeros: ``{"groups": {"self": (K,
    V)}}``, each (n_layers, batch, max_seq, Hkv, D). K and V are two
    tensors (the reference's ``(kv, kv)`` is one array twice, which the
    port's in-place writes would make V overwrite K)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or cfg.param_dtype
    return {"groups": {"self": (torch.zeros(shape, dtype=dt, device=dev),
                                torch.zeros(shape, dtype=dt, device=dev))}}
