"""jamba-v0.1-52b [hybrid]: 32L d4096 32H (GQA kv=8) d_ff=14336,
MoE 16e top-2, Mamba+attn 1:7 interleave, vocab 65536. [arXiv:2403.19887]

Layer period 8: attention at offset 4, MoE every other layer (as released).
Sub-quadratic (SSM-dominated) -> runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    pattern=("mamba", "mamba_moe", "mamba", "mamba_moe",
             "attn", "mamba_moe", "mamba", "mamba_moe"),
    n_experts=16, moe_top_k=2,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    sub_quadratic=True,
)
