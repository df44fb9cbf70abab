"""qwen2-vl-72b [vlm]: 80L d8192 64H (GQA kv=8) d_ff=29568, vocab 152064,
M-RoPE, dynamic resolution. [arXiv:2409.12191]

Backbone only per the assignment: the vision frontend is a stub —
input_specs() provides token ids (+ M-RoPE position streams collapse to text
mode); dynamic-resolution patching happens upstream of the backbone.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064,
    rope="mrope", mrope_sections=(16, 24, 24), qkv_bias=True,
    notes="vision frontend stubbed; long_500k skipped (full attention).",
)
