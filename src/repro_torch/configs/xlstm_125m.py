# Verbatim copy of repro/configs/xlstm_125m.py (the JAX package's original); only import paths may differ.
"""xlstm-125m [ssm] — sLSTM + mLSTM blocks, no FFN [arXiv:2405.04517]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    arch_type="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,  # blocks carry their own up/down projections
    vocab_size=50304,
    source="arXiv:2405.04517",
    slstm_every=6,  # [mLSTM x5, sLSTM] x2
    ssm_expand=2,
    max_seq_len=1_048_576,  # recurrent state: unbounded context
)

SMOKE = CONFIG.replace(
    n_layers=6,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    vocab_size=512,
    param_dtype="float32",
    compute_dtype="float32",
)
