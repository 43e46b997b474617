# Verbatim copy of repro/configs/deepseek_v3_671b.py (the JAX package's original); only import paths may differ.
"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP [arXiv:2412.19437]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,  # nominal; MLA caches the 576-wide latent instead
    d_ff=18432,  # dense layers (first 3); routed experts use d_ff_expert
    vocab_size=129280,
    source="arXiv:2412.19437",
    attn_kind="mla",
    head_dim=128,  # qk nope dim
    v_head_dim=128,
    q_lora_rank=1536,
    kv_lora_rank=512,
    rope_head_dim=64,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    d_ff_expert=2048,
    n_dense_layers=3,
    moe_every=1,
    mtp_depth=1,
    rope_theta=10_000.0,
    max_seq_len=131_072,
    remat=True,
)

# reduced same-family variant for CPU smoke tests
SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    v_head_dim=32,
    q_lora_rank=64,
    kv_lora_rank=64,
    rope_head_dim=16,
    d_ff=512,
    d_ff_expert=128,
    n_experts=4,
    top_k=2,
    n_dense_layers=1,
    vocab_size=512,
    mtp_depth=1,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)
