# Verbatim copy of repro/configs/jamba_v01_52b.py (the JAX package's original); only import paths may differ.
"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2 [arXiv:2403.19887]."""
from .base import ArchConfig

# 8-layer macro-block: attention at position 4, Mamba elsewhere (1:7);
# MoE replaces the MLP on every other layer (odd indices).
_PATTERN = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    source="arXiv:2403.19887",
    hybrid_pattern=_PATTERN,
    n_experts=16,
    top_k=2,
    d_ff_expert=14336,
    moe_every=2,
    d_state=16,
    d_conv=4,
    ssm_expand=2,
    max_seq_len=262_144,
    remat=True,
)

SMOKE = CONFIG.replace(
    n_layers=8,  # one full macro-block
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    d_ff_expert=256,
    n_experts=4,
    top_k=2,
    vocab_size=512,
    d_state=8,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)
