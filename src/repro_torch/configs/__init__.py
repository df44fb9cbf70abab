"""Architecture registry: the 10 assigned configs + reduced smoke variants
(port of ``repro.configs``)."""
from __future__ import annotations

import dataclasses
import importlib

from .base import ModelConfig
from .shapes import SHAPES, ShapeSpec, cells, eligible

_MODULES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "qwen2.5-14b": "qwen2_5_14b",
    "gemma2-27b": "gemma2_27b",
    "smollm-135m": "smollm_135m",
    "command-r-plus-104b": "command_r_plus_104b",
    "whisper-small": "whisper_small",
    "rwkv6-3b": "rwkv6_3b",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    mod = importlib.import_module(f"{__name__}.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


def reduced_config(name: str) -> ModelConfig:
    """Smoke-test variant: same family/pattern/features, tiny dims.

    Dims are shrunk so one forward/train step runs in seconds on CPU while
    every structural feature (pattern, GQA ratio, MoE, norms, softcaps,
    biases) is preserved.
    """
    cfg = get_config(name)
    g = len(cfg.pattern)
    heads = max(2, min(cfg.n_heads, 4))
    kv = max(1, heads * cfg.n_kv_heads // cfg.n_heads)
    # keep a valid GQA ratio
    while heads % kv != 0:
        kv -= 1
    head_dim = 16
    d_model = heads * head_dim if cfg.name != "gemma2-27b" else heads * head_dim + 16
    repl = dict(
        n_layers=2 * g if 2 * g <= 8 else g,
        d_model=d_model,
        n_heads=heads, n_kv_heads=kv, head_dim=head_dim,
        d_ff=4 * d_model if cfg.n_experts == 0 else 32,
        vocab_size=211,
        vocab_pad_mult=16,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        # ample capacity: smoke/parity tests must be drop-free so block-local
        # and global dispatch agree exactly
        moe_capacity=8.0,
        window_size=8 if cfg.window_size else None,
        enc_ctx=16 if cfg.enc_dec else cfg.enc_ctx,
        n_enc_layers=2 if cfg.enc_dec else 0,
        max_dec_pos=128 if cfg.max_dec_pos else 0,
        rwkv_head_dim=16,
        rwkv_chunk=8,
        mrope_sections=(4, 2, 2) if cfg.rope == "mrope" else cfg.mrope_sections,
        dtype="float32",
        remat=False,
        name=f"{cfg.name}-smoke",
    )
    return dataclasses.replace(cfg, **repl)


__all__ = ["ModelConfig", "SHAPES", "ShapeSpec", "cells", "eligible",
           "ARCH_NAMES", "get_config", "all_configs",
           "reduced_config"]
