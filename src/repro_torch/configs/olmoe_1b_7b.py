"""olmoe-1b-7b [moe]: 16L d2048 16H (GQA kv=16) d_ff=1024/expert,
MoE 64e top-8, vocab 50304, QK-norm. [arXiv:2409.02060]

Fully expert-parallel (64 % 16 == 0) and head-parallel (16 % 16 == 0).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    pattern=("attn_moe",), n_experts=64, moe_top_k=8, qk_norm=True,
    notes="long_500k skipped (full attention).",
)
