# Verbatim copy of repro/configs/qwen15_4b.py (the JAX package's original); only import paths may differ.
"""qwen1.5-4b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    arch_type="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    source="hf:Qwen/Qwen1.5-0.5B",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    param_dtype="float32",
    compute_dtype="float32",
)
