# Verbatim copy of repro/configs/gemma3_1b.py (the JAX package's original); only import paths may differ.
"""gemma3-1b [dense] — 5:1 local:global, 128k context [hf:google/gemma-3-1b-pt]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    arch_type="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,  # MQA
    d_ff=6912,
    vocab_size=262144,
    source="hf:google/gemma-3-1b-pt",
    head_dim=256,
    act="gelu",
    gemma_norm=True,
    qk_norm=True,
    tie_embeddings=True,
    local_global=(5, 1),
    sliding_window=512,
    rope_theta=1_000_000.0,  # global layers
    rope_theta_local=10_000.0,  # local layers
    max_seq_len=131_072,
)

SMOKE = CONFIG.replace(
    n_layers=6,  # one full 5:1 macro-block
    d_model=128,
    n_heads=4,
    n_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    sliding_window=16,
    param_dtype="float32",
    compute_dtype="float32",
)
