"""Decoder-only LM: init / forward / caches (port of
``repro.models.transformer``, every layer kind of the config zoo).

Parameters keep the reference's pytree: group-stacked leaves of shape
``(n_groups, ...)`` under ``params["groups"]["b<i>"]``, so the reference's
parameters carry over leaf for leaf (:func:`load_jax_params`). The forward
is a Python loop over groups where the reference scans. Caches are stacked
the same way and written in place (``models/layers.py``,
``models/rwkv.py``, ``models/mamba.py``). Attention and Mamba layers take
a dense MLP or, for ``attn_moe`` / ``mamba_moe``, an MoE block
(``models/moe.py``); ``rwkv`` layers are the RWKV-6 block. Recurrent state
(``rwkv``, ``mamba``) is O(1) per row, so the paged cache refuses those
kinds, as the reference's does. The enc-dec family (whisper) is
``models/whisper.py``, built from this module's parameter helpers.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.approx_ops import ApproxConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.mamba import MambaState, mamba_block
from repro_torch.models.moe import moe_block
from repro_torch.models.rwkv import RwkvState, rwkv_block
from repro_torch.tree import tree_map

KINDS = ("attn", "attn_local", "attn_global", "attn_moe", "mamba",
         "mamba_moe", "rwkv")


def _check_kinds(cfg: ModelConfig) -> None:
    for kind in cfg.pattern:
        if kind not in KINDS:
            raise ValueError(f"unknown layer kind {kind!r} ({cfg.name})")


def _entry(kind: str) -> str:
    """The cache entry of a layer kind: ``attn``, ``mamba`` or ``rwkv``."""
    return "rwkv" if kind == "rwkv" else kind.split("_")[0]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def param_makers(seed: int, cfg: ModelConfig, device):
    """``(dense, norm, dev)`` for building parameters from a seed (one
    ``torch.Generator`` on the device): ``dense(*shape, scale=None,
    dtype=cfg.param_dtype)`` draws ``N(0, 1) * scale`` (``scale`` defaults
    to ``shape[-2] ** -0.5``), ``norm(width, n)`` gives ``n`` stacked norm
    parameters of ``cfg.norm``'s kind. On ``device="meta"`` the leaves have
    shapes and dtypes only: no generator, nothing drawn or allocated."""
    dev = resolve_device(device)
    meta = dev.type == "meta"
    gen = None if meta else torch.Generator(device=dev)
    if gen is not None:
        gen.manual_seed(seed)

    def dense(*shape, scale=None, dtype=cfg.param_dtype):
        if meta:
            return torch.empty(shape, dtype=dtype, device=dev)
        scale = scale or shape[-2] ** -0.5
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)     # in place: one float32 copy

    def norm(width, n):
        if cfg.norm == "ln":
            return {"w": torch.ones((n, width), device=dev),
                    "b": torch.zeros((n, width), device=dev)}
        fill = torch.zeros if cfg.norm == "rms1p" else torch.ones
        return {"w": fill((n, width), device=dev)}

    return dense, norm, dev


def init_attn(dense, cfg: ModelConfig, g: int, dev,
              cross: bool = False) -> dict:
    """Attention leaves (g, ...): ``wq``/``wk``/``wv``/``wo`` at
    ``d_in**-0.5``; QKV biases at 0 when ``cfg.qkv_bias`` (never for a
    ``cross`` attention, as the reference's ``_init_attn``); q/k norms at
    1 when ``cfg.qk_norm``."""
    d, hd = cfg.d_model, cfg.head_dim
    h, hkv, pd = cfg.n_heads, cfg.n_kv_heads, cfg.param_dtype
    attn = {"wq": dense(g, d, h * hd), "wk": dense(g, d, hkv * hd),
            "wv": dense(g, d, hkv * hd), "wo": dense(g, h * hd, d)}
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", h * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            attn[name] = torch.zeros((g, width), dtype=pd, device=dev)
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones((g, hd), device=dev)
        attn["k_norm"] = torch.ones((g, hd), device=dev)
    return attn


def init_mlp(dense, cfg: ModelConfig, g: int, dev) -> dict:
    """Dense MLP leaves (g, ...): gated (``w_gate``, ``w_up``, ``w_down``)
    or plain GELU with zero biases (``b_up``, ``b_down``)."""
    d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"w_gate": dense(g, d, f), "w_up": dense(g, d, f),
                "w_down": dense(g, f, d)}
    return {"w_up": dense(g, d, f),
            "b_up": torch.zeros((g, f), dtype=pd, device=dev),
            "w_down": dense(g, f, d),
            "b_down": torch.zeros((g, d), dtype=pd, device=dev)}


def init_params(seed: int, cfg: ModelConfig, device=None) -> dict:
    """Parameters from a seed (``torch.Generator`` on ``device``), in the
    reference's layout and scales: dense weights ``N(0, 1) / sqrt(d_in)``
    in ``cfg.param_dtype``, norms at 1 (0 for ``rms1p``), biases 0. The
    numbers differ from the reference's ``jax.random`` ones; load those
    with :func:`load_jax_params`. On ``device="meta"``: shapes and dtypes
    only (the counterpart of ``jax.eval_shape``)."""
    _check_kinds(cfg)
    dense, norm, dev = param_makers(seed, cfg, device)
    g, d = cfg.n_groups, cfg.d_model

    groups: dict[str, Any] = {}
    for i, kind in enumerate(cfg.pattern):
        if kind == "rwkv":
            groups[f"b{i}"] = {"rwkv": _init_rwkv(dense, cfg, g, dev)}
            continue
        blk = {"norm1": norm(d, g)}
        if kind.startswith("mamba"):
            blk["mamba"] = _init_mamba(dense, cfg, g, dev)
        else:
            blk["attn"] = init_attn(dense, cfg, g, dev)
        blk["norm2"] = norm(d, g)
        blk["mlp"] = (_init_moe(dense, cfg, g) if kind.endswith("moe")
                      else init_mlp(dense, cfg, g, dev))
        if cfg.post_norm and kind.startswith("attn"):
            blk["post_norm1"] = norm(d, g)
            blk["post_norm2"] = norm(d, g)
        groups[f"b{i}"] = blk
    params = {"embed": dense(cfg.vocab_padded, d, scale=d ** -0.5),
              "groups": groups, "final_norm": norm(d, 1)}
    if not cfg.tie_embed:
        params["lm_head"] = dense(d, cfg.vocab_padded)
    return params


def _init_moe(dense, cfg: ModelConfig, g: int) -> dict:
    """MoE leaves in the reference's layout and scales: ``router`` (g, d,
    E) float32 at ``d**-0.5``; ``w_gate``/``w_up`` (g, E, d, f) at
    ``d**-0.5`` and ``w_down`` (g, E, f, d) at ``f**-0.5``, in
    ``cfg.param_dtype``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": dense(g, d, e, dtype=torch.float32),
            "w_gate": dense(g, e, d, f), "w_up": dense(g, e, d, f),
            "w_down": dense(g, e, f, d)}


def _init_mamba(dense, cfg: ModelConfig, g: int, dev) -> dict:
    """Mamba leaves in the reference's layout, dtypes and scales: the four
    projections at ``d_in**-0.5`` and ``conv_w`` at 0.1 in
    ``cfg.param_dtype``; ``conv_b`` 0, ``dt_bias`` -4.6 (softplus about
    0.01) and ``Dskip`` 1 in ``cfg.param_dtype``; ``A_log`` = log(1 ..
    d_state) on every channel, float32."""
    d, di, ds = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    dtr, dc, pd = cfg.mamba_dt_rank, cfg.mamba_d_conv, cfg.param_dtype
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=dev))
    return {"in_proj": dense(g, d, 2 * di),
            "conv_w": dense(g, dc, di, scale=0.1),
            "conv_b": torch.zeros((g, di), dtype=pd, device=dev),
            "x_proj": dense(g, di, dtr + 2 * ds),
            "dt_proj": dense(g, dtr, di),
            "dt_bias": torch.full((g, di), -4.6, dtype=pd, device=dev),
            "A_log": a_log.expand(g, di, ds).contiguous(),
            "Dskip": torch.ones((g, di), dtype=pd, device=dev),
            "out_proj": dense(g, di, d)}


def _init_rwkv(dense, cfg: ModelConfig, g: int, dev) -> dict:
    """RWKV-6 leaves in the reference's layout, dtypes and scales: the
    projections and ``lora_A`` / ``Wdecay_A`` at ``d_in**-0.5`` and
    ``Wdecay_B`` at 1e-2 in ``cfg.param_dtype``; norms at 1 and 0, the
    token-shift mixes ``mu_*`` at 0.5, ``decay_base`` at 0.5 and ``bonus``
    at 0, float32; the ``lora_B_*`` at 0 in ``cfg.param_dtype`` (so at
    init the LoRA mix and the bonus add nothing)."""
    d, f = cfg.d_model, cfg.d_ff
    lora_r, decay_r = max(32, d // 32), max(64, d // 16)
    pd = cfg.param_dtype

    def full(value, *shape, dtype=torch.float32):
        return torch.full((g, *shape), value, dtype=dtype, device=dev)

    p = {"ln1_w": full(1.0, d), "ln1_b": full(0.0, d),
         "ln2_w": full(1.0, d), "ln2_b": full(0.0, d),
         "lora_A": dense(g, d, lora_r), "Wdecay_A": dense(g, d, decay_r),
         "Wdecay_B": dense(g, decay_r, d, scale=1e-2),
         "decay_base": full(0.5, d), "bonus": full(0.0, d)}
    for name in ("Wr", "Wk", "Wv", "Wg", "Wo"):
        p[name] = dense(g, d, d)
    p.update(ln_w=full(1.0, d), ln_b=full(0.0, d), Wk_cm=dense(g, d, f),
             Wv_cm=dense(g, f, d), Wr_cm=dense(g, d, d))
    for mu in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "cm_mu_k", "cm_mu_r"):
        p[mu] = full(0.5, d)
    for name in ("lora_B_r", "lora_B_k", "lora_B_v", "lora_B_g", "lora_B_w"):
        p[name] = full(0.0, lora_r, d, dtype=pd)
    return p


def load_jax_params(tree, device=None, dtype=None) -> dict:
    """The reference's parameter pytree (numpy leaves, e.g. from
    ``jax.tree.map(np.asarray, params)``) as the port's parameters on
    ``device``; bfloat16 leaves arrive as numpy's ml_dtypes bfloat16 and
    are carried over bit for bit. ``dtype`` converts every leaf."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: load_jax_params(v, dev, dtype) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=dev, dtype=dtype or t.dtype)


def map_cache(fn, tree):
    """``fn`` applied to every tensor of a cache or parameter tree (dicts,
    tuples, ``RwkvState``s and ``MambaState``s), keeping its
    structure."""
    return tree_map(fn, tree)


def _at(tree, i: int):
    """Group ``i`` of a group-stacked pytree (views, no copies)."""
    return map_cache(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _norm(x, p, cfg: ModelConfig):
    if cfg.norm == "ln":
        return L.layer_norm(x, p["w"], p["b"])
    return L.rms_norm(x, p["w"], plus_one=(cfg.norm == "rms1p"))


def mlp_apply(h, p, kind: str, cfg: ModelConfig, acfg):
    """The layer's feed-forward: an MoE block for ``*moe`` kinds, else the
    dense MLP."""
    if kind.endswith("moe"):
        return moe_block(h, p, cfg, acfg)
    return L.mlp_block(h, p, cfg, acfg)


def _apply_block(x, blk, kind, cfg, acfg, positions, cache, cache_pos,
                 decode=False, pad_mask=None, page_table=None):
    """One layer; ``cache`` is its (K, V), its ``RwkvState``, its
    ``MambaState`` or None. Recurrent layers (``rwkv``, ``mamba``) ignore
    positions and masks: their recurrence ingests every token, left pads
    included, as the reference's does."""
    if kind == "rwkv":
        return rwkv_block(x, blk["rwkv"], cfg, acfg, state=cache)[0]
    h = _norm(x, blk["norm1"], cfg)
    if kind.startswith("mamba"):
        m, _ = mamba_block(h, blk["mamba"], cfg, acfg, state=cache,
                           decode=decode)
        x = x + m
        return x + mlp_apply(_norm(x, blk["norm2"], cfg), blk["mlp"], kind,
                             cfg, acfg)
    window = cfg.window_size if kind == "attn_local" else None
    a, _ = L.attention_block(h, blk["attn"], cfg, acfg, positions,
                             cache=cache, cache_pos=cache_pos, window=window,
                             pad_mask=pad_mask, page_table=page_table)
    if cfg.post_norm:
        a = _norm(a, blk["post_norm1"], cfg)
    if cfg.parallel_block:
        return x + a + mlp_apply(h, blk["mlp"], kind, cfg, acfg)
    x = x + a
    m = mlp_apply(_norm(x, blk["norm2"], cfg), blk["mlp"], kind, cfg, acfg)
    if cfg.post_norm:
        m = _norm(m, blk["post_norm2"], cfg)
    return x + m


def apply_model(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                acfg: Optional[ApproxConfig] = None,
                cache: Optional[dict] = None, cache_pos=0,
                decode: bool = False, last_only: bool = False,
                pos_offset: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None):
    """Token ids (B, S) -> logits (B, S, V) (or (B, 1, V) with
    ``last_only``), and the cache, written in place.

    ``cache_pos``: an int, or a (B,) tensor (continuous batching: every row
    at its own cache position). ``pos_offset`` (B,): each row's left-pad
    count, subtracted from the RoPE positions; ``pad_mask`` (B, T): the
    valid keys. ``page_table`` (B, n_logical) int32 switches the caches to
    the block-paged layout of :func:`init_paged_cache`. ``decode`` is
    the reference's flag: a Mamba layer then takes one recurrence step
    for T = 1 instead of the scan (an RWKV decode step is its recurrence
    with T = 1 either way)."""
    _check_kinds(cfg)
    b, s = tokens.shape
    x = L.embed(tokens, params["embed"])
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    ar = torch.arange(s, device=tokens.device)[None, :]
    if isinstance(cache_pos, int):
        positions = ar + cache_pos
    else:
        cp = torch.as_tensor(cache_pos, device=tokens.device)
        positions = ar + (cp[:, None] if cp.dim() == 1 else cp)
    if pos_offset is not None:
        positions = torch.clamp_min(positions - pos_offset[:, None], 0)
    positions = positions.expand(b, s)

    groups = cache["groups"] if cache is not None else None
    for gi in range(cfg.n_groups):
        gp = _at(params["groups"], gi)
        for i, kind in enumerate(cfg.pattern):
            layer_cache = None if groups is None else \
                _at(groups[f"b{i}"][_entry(kind)], gi)
            x = _apply_block(x, gp[f"b{i}"], kind, cfg, acfg, positions,
                             layer_cache, cache_pos, decode, pad_mask,
                             page_table)
    if last_only:
        x = x[:, -1:]
    x = _norm(x, _at(params["final_norm"], 0), cfg)
    head = params["embed"].t() if cfg.tie_embed else params["lm_head"]
    return L.lm_head(x, head, acfg, softcap=cfg.softcap_final), cache


def loss_fn(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig,
            acfg: Optional[ApproxConfig] = None) -> torch.Tensor:
    """Mean next-token cross entropy of the cache-less forward: with
    ``cfg.attn_impl == "flash"`` and no gradient wanted, every attention
    layer runs kernel 11."""
    logits, _ = apply_model(params, tokens, cfg, acfg=acfg)
    return L.cross_entropy(logits, labels, cfg.vocab_size)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> dict:
    """Decode cache, group-stacked like the parameters, zeros: per
    attention layer (K, V) of shape (n_groups, batch, max_seq, Hkv, D)
    (two tensors); per rwkv layer an ``RwkvState`` of shifts (n_groups,
    batch, 1, d) in ``dtype`` and the wkv state (n_groups, batch, H, hd,
    hd) in float32; per mamba layer a ``MambaState`` of the conv tail
    (n_groups, batch, d_conv - 1, d_inner) in ``dtype`` and the SSM state
    (n_groups, batch, d_inner, d_state) in float32."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    g = cfg.n_groups
    dt = dtype or cfg.param_dtype

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    groups = {}
    for i, kind in enumerate(cfg.pattern):
        if kind == "rwkv":
            hd = cfg.rwkv_head_dim
            groups[f"b{i}"] = {"rwkv": RwkvState(
                tm_shift=zeros(g, batch, 1, cfg.d_model),
                wkv=zeros(g, batch, cfg.rwkv_n_heads, hd, hd,
                          dtype=torch.float32),
                cm_shift=zeros(g, batch, 1, cfg.d_model))}
        elif kind.startswith("mamba"):
            groups[f"b{i}"] = {"mamba": MambaState(
                conv=zeros(g, batch, cfg.mamba_d_conv - 1,
                           cfg.mamba_d_inner),
                ssm=zeros(g, batch, cfg.mamba_d_inner, cfg.mamba_d_state,
                          dtype=torch.float32))}
        else:
            shape = (g, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
            groups[f"b{i}"] = {"attn": (zeros(*shape), zeros(*shape))}
    return {"groups": groups}


def check_paged_kinds(cfg: ModelConfig) -> None:
    """Only attention layers page: other kinds raise
    ``NotImplementedError``, as the reference's ``init_paged_cache``
    does."""
    _check_kinds(cfg)
    for kind in cfg.pattern:
        if not kind.startswith("attn"):
            raise NotImplementedError("paged cache covers attention-only "
                                      f"patterns; got {kind!r}")


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                     dtype=None, device=None) -> dict:
    """Block-paged decode cache: per attention layer one physical pool
    (n_groups, Hkv, n_blocks, block_size, D) of zeros shared by every
    sequence, addressed through the ``page_table`` of :func:`apply_model`.
    Physical block 0 is the engine's always-zero null block."""
    check_paged_kinds(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_groups, cfg.n_kv_heads, n_blocks, block_size,
             cfg.head_dim)
    dt = dtype or cfg.param_dtype
    return {"groups": {
        f"b{i}": {"attn": (torch.zeros(shape, dtype=dt, device=dev),
                           torch.zeros(shape, dtype=dt, device=dev))}
        for i, _ in enumerate(cfg.pattern)}}
