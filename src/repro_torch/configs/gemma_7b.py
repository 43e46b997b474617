# Verbatim copy of repro/configs/gemma_7b.py (the JAX package's original); only import paths may differ.
"""gemma-7b [dense] — GeGLU, head_dim=256 [arXiv:2403.08295]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    arch_type="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    source="arXiv:2403.08295",
    head_dim=256,
    act="gelu",
    gemma_norm=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    max_seq_len=8_192,
    remat=True,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=512,
    vocab_size=512,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)
