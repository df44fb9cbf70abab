"""smollm-135m [dense]: 30L d576 9H (GQA kv=3) d_ff=1536, vocab 49152,
llama-arch small, tied embeddings. [hf:HuggingFaceTB/SmolLM-135M]

The ~100M end-to-end training demo architecture (examples/train_lm_approx.py).
9 heads % 16 != 0 -> heads replicated under TP.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab_size=49152, tie_embed=True,
    notes="long_500k skipped (full attention).",
)
