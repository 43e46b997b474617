# Verbatim copy of repro/configs/musicgen_medium.py (the JAX package's original); only import paths may differ.
"""musicgen-medium [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].

Backbone only: the EnCodec conv codec is a stub — ``input_specs`` feeds
audio-token ids (vocab 2048) or frame embeddings directly.  long_500k is
skipped for this arch (524k EnCodec frames ≈ 3 h of audio, far outside the
model's 30 s regime; see DESIGN.md §4).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    arch_type="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    source="arXiv:2306.05284",
    norm="ln",
    act="gelu",
    rope_theta=10_000.0,
    max_seq_len=32_768,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=256,
    param_dtype="float32",
    compute_dtype="float32",
)
