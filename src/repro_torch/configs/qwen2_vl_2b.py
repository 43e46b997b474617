# Verbatim copy of repro/configs/qwen2_vl_2b.py (the JAX package's original); only import paths may differ.
"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

Backbone only: the ViT vision encoder + projector are a stub — ``input_specs``
feeds precomputed patch embeddings and (t, h, w) M-RoPE position streams.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    source="arXiv:2409.12191",
    qkv_bias=True,
    mrope_sections=(16, 24, 24),  # sums to head_dim/2 = 64
    rope_theta=1_000_000.0,
    input_mode="embeds",
    max_seq_len=32_768,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    mrope_sections=(4, 6, 6),  # head_dim 32 -> 16 rotary pairs
    param_dtype="float32",
    compute_dtype="float32",
)
