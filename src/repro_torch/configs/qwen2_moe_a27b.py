# Verbatim copy of repro/configs/qwen2_moe_a27b.py (the JAX package's original); only import paths may differ.
"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,  # unused (every layer is MoE); shared experts = 4 x 1408
    vocab_size=151936,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    qkv_bias=True,
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    d_ff_expert=1408,
    moe_every=1,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    d_ff_expert=64,
    n_experts=4,
    n_shared_experts=2,
    top_k=2,
    vocab_size=512,
    param_dtype="float32",
    compute_dtype="float32",
)
