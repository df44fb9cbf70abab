"""Model/architecture configuration schema shared by all assigned archs
(port of ``repro.configs.base``: plain data; ``param_dtype`` is a
``torch.dtype``)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


def pad_to(n: int, mult: int) -> int:
    return n + (-n) % mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None    # default d_model // n_heads
    vocab_pad_mult: int = 256         # pad vocab so TP always divides

    # layer pattern: kinds per repeating group; n_layers % len(pattern) == 0
    #   attn, attn_local, attn_global, attn_moe, mamba, mamba_moe, rwkv
    pattern: Tuple[str, ...] = ("attn",)

    # attention
    rope: str = "rope"                # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    qkv_bias: bool = False
    qk_norm: bool = False
    softcap_attn: Optional[float] = None
    softcap_final: Optional[float] = None
    window_size: Optional[int] = None  # for attn_local layers
    attn_impl: str = "chunked"         # chunked | naive | flash
    attn_chunk: int = 512
    attn_causal_blocking: bool = False  # §Perf: skip fully-masked KV blocks

    # blocks / norms
    mlp_type: str = "swiglu"           # swiglu | geglu | gelu
    norm: str = "rms"                  # rms | rms1p | ln
    post_norm: bool = False            # gemma2 sandwich norms
    parallel_block: bool = False       # command-r style
    tie_embed: bool = False
    embed_scale: bool = False          # gemma: x *= sqrt(d)

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_capacity: float = 1.25
    # §Perf hillclimb #1: shard the dispatch capacity dim over `data`
    # (token-parallel expert compute). False reproduces the replicated-
    # dispatch baseline recorded in EXPERIMENTS.md.
    moe_shard_dispatch: bool = True

    # Mamba (jamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # RWKV
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 256

    # whisper enc-dec
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_ctx: int = 1500
    max_dec_pos: int = 0               # learned decoder positions (0 = rope)

    # runtime
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"      # nothing | dots (save matmul outputs)
    scan_unroll: int = 1
    sub_quadratic: bool = False        # eligible for long_500k
    notes: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_layers % len(self.pattern) == 0, (self.name, self.n_layers,
                                                        self.pattern)

    # -- derived ----------------------------------------------------------

    @property
    def vocab_padded(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad_mult)

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def param_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def n_params(self) -> int:
        """Total parameter count (embedding included once if tied)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_padded
        hd, h, hkv = self.head_dim, self.n_heads, self.n_kv_heads
        per_kind = {}
        attn = d * (h * hd) + 2 * d * (hkv * hd) + (h * hd) * d
        dense_mlp = 3 * d * f if self.mlp_type in ("swiglu", "geglu") else 2 * d * f
        moe_mlp = self.n_experts * 3 * d * f + d * self.n_experts
        di, ds = self.mamba_d_inner, self.mamba_d_state
        mamba = d * 2 * di + di * (self.mamba_dt_rank + 2 * ds) + \
            self.mamba_dt_rank * di + di * ds + di * d + self.mamba_d_conv * di
        rwkv = 6 * d * d + 2 * d * (4 * f // 4)  # approx: tm + cm GEMMs
        for kind in self.pattern:
            if kind.startswith("attn"):
                per_kind[kind] = attn + (moe_mlp if kind.endswith("moe") else dense_mlp)
            elif kind.startswith("mamba"):
                per_kind[kind] = mamba + (moe_mlp if kind.endswith("moe") else dense_mlp)
            elif kind == "rwkv":
                per_kind[kind] = rwkv
        body = sum(per_kind[k] for k in self.pattern) * self.n_groups
        if self.enc_dec:
            body += self.n_enc_layers * (attn + dense_mlp) + \
                self.n_layers * attn  # decoder cross-attention
        emb = v * d * (1 if self.tie_embed else 2)
        return body + emb

    def n_active_params(self) -> int:
        """Active (per-token) params for MoE FLOP accounting."""
        if self.n_experts == 0:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        full_moe = self.n_experts * 3 * d * f
        act_moe = self.moe_top_k * 3 * d * f
        n_moe_layers = sum(1 for k in self.pattern if k.endswith("moe")) * self.n_groups
        if all(not k.endswith("moe") for k in self.pattern):
            n_moe_layers = 0
        return self.n_params() - n_moe_layers * (full_moe - act_moe)
