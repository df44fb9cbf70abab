"""command-r-plus-104b [dense]: 64L d12288 96H (GQA kv=8) d_ff=33792,
vocab 256000, parallel attention+FFN blocks, no bias.
[hf:CohereForAI/c4ai-command-r-plus; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000,
    parallel_block=True, norm="ln",
    notes="long_500k skipped (full attention).",
)
