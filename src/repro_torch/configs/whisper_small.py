"""whisper-small [audio]: 12L enc + 12L dec, d768 12H (kv=12) d_ff=3072,
vocab 51865, enc-dec with conv frontend STUBBED per the assignment
(input_specs() provides post-conv frame embeddings, enc_ctx=1500).
[arXiv:2212.04356; unverified]

max_dec_pos is raised to 33k so decode_32k is structurally lowerable
(real whisper caps at 448 decoder positions — noted in DESIGN.md).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865,
    enc_dec=True, n_enc_layers=12, enc_ctx=1500, max_dec_pos=33000,
    norm="ln", mlp_type="gelu", rope="none",
    notes="12 heads % 16 != 0 -> heads replicated; long_500k skipped.",
)
