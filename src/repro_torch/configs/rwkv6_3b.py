"""rwkv6-3b "Finch" [ssm]: 32L d2560 (attn-free, 40 wkv heads x 64),
d_ff=8960, vocab 65536, data-dependent decay. [arXiv:2404.05892]

Attention-free -> sub-quadratic -> runs long_500k. The paper's ACU technique
applies to all R/K/V/G/O + channel-mix GEMMs (DESIGN.md §6).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    pattern=("rwkv",), rope="none", rwkv_head_dim=64,
    sub_quadratic=True,
)
