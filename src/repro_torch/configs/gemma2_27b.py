"""gemma2-27b [dense]: 46L d4608 32H (GQA kv=16) d_ff=36864, vocab 256000,
local+global alternating attention, logit softcaps. [arXiv:2408.00118]

head_dim 128 (q/k/v project to 4096 != d_model, as released). Sandwich
(pre+post) RMSNorm with (1+w) parameterization; GeGLU; sqrt(d) embed scale.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    pattern=("attn_local", "attn_global"), window_size=4096,
    softcap_attn=50.0, softcap_final=30.0,
    norm="rms1p", post_norm=True, mlp_type="geglu", embed_scale=True,
    notes="long_500k skipped (global layers are full attention).",
)
