"""qwen2.5-14b [dense]: 48L d5120 40H (GQA kv=8) d_ff=13824, vocab 152064,
QKV bias. [hf:Qwen/Qwen2.5 family]

40 heads % 16 != 0 -> heads replicated under TP (planner fallback; hillclimb
candidate: pad to 48 heads is still not divisible — TP lives on d_ff+vocab).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064, qkv_bias=True,
    notes="long_500k skipped (full attention).",
)
