"""granite-moe-3b-a800m [moe]: 32L d1536 24H (GQA kv=8) d_ff=512/expert,
MoE 40e top-8, vocab 49155. [hf:ibm-granite/granite-3.0-3b-a800m-base]

24 heads % 16 != 0 -> heads replicated under TP (planner fallback);
40 experts % 16 != 0 -> TP-in-expert (d_ff 512 / 16 = 32).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    pattern=("attn_moe",), n_experts=40, moe_top_k=8,
    notes="heads/experts not divisible by model axis: TP via d_ff+vocab; "
          "long_500k skipped (full attention).",
)
