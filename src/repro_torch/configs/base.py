# Verbatim copy of repro/configs/base.py (the JAX package's original); only import paths may differ.
"""Architecture configuration: one dataclass drives every assigned model family."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class LayerSpec:
    """What one decoder layer is made of."""

    mixer: str  # 'attn' | 'mla' | 'mamba' | 'mlstm' | 'slstm'
    ffn: str  # 'dense' | 'moe' | 'none'
    window: int | None = None  # sliding-window size for local attention
    rope_theta: float | None = None  # per-layer theta override (gemma3 locals)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str  # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""  # citation

    head_dim: int | None = None  # default d_model // n_heads
    # --- attention ---
    attn_kind: str = "gqa"  # 'gqa' | 'mla'
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int | None = None  # uniform window (or the local size)
    local_global: tuple[int, int] | None = None  # e.g. (5, 1) local:global
    rope_theta: float = 10_000.0
    rope_theta_local: float | None = None
    mrope_sections: tuple[int, ...] | None = None  # qwen2-vl M-RoPE
    # --- MLA (deepseek) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    v_head_dim: int | None = None
    # --- ffn ---
    act: str = "silu"  # 'silu' (swiglu) | 'gelu' (geglu)
    norm: str = "rms"  # 'rms' | 'ln'
    gemma_norm: bool = False  # (1+w) RMSNorm + sqrt(d) embedding scale
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1
    n_dense_layers: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- hybrid / ssm ---
    hybrid_pattern: tuple[str, ...] | None = None  # mixer per layer, cycled
    d_state: int = 16
    d_conv: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0  # xlstm: layer i is sLSTM when (i+1) % slstm_every == 0
    # --- embeddings / misc ---
    tie_embeddings: bool = False
    mtp_depth: int = 0  # deepseek multi-token-prediction aux heads
    input_mode: str = "tokens"  # 'tokens' | 'embeds' (vlm/audio frontends are stubs)
    max_seq_len: int = 131_072
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = False

    # ----------------------------------------------------------------- helpers
    @property
    def hdim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vdim(self) -> int:
        return self.v_head_dim or self.hdim

    @property
    def is_moe_arch(self) -> bool:
        return self.n_experts > 0

    def _mixer(self, i: int) -> tuple[str, int | None, float | None]:
        if self.hybrid_pattern is not None:
            m = self.hybrid_pattern[i % len(self.hybrid_pattern)]
        elif self.slstm_every:
            m = "slstm" if (i + 1) % self.slstm_every == 0 else "mlstm"
        elif self.attn_kind == "mla":
            m = "mla"
        else:
            m = "attn"
        window, theta = None, None
        if m in ("attn",):
            if self.local_global is not None:
                nl, ng = self.local_global
                if i % (nl + ng) < nl:
                    window = self.sliding_window
                    theta = self.rope_theta_local
            else:
                window = self.sliding_window
        return m, window, theta

    def _ffn(self, i: int) -> str:
        if self.d_ff == 0 and not self.is_moe_arch:
            return "none"  # xlstm blocks carry their own projections
        if not self.is_moe_arch or i < self.n_dense_layers:
            return "dense"
        j = i - self.n_dense_layers
        if self.moe_every == 1 or j % self.moe_every == self.moe_every - 1:
            return "moe"
        return "dense"

    def layer_specs(self) -> tuple[LayerSpec, ...]:
        out = []
        for i in range(self.n_layers):
            mixer, window, theta = self._mixer(i)
            out.append(LayerSpec(mixer, self._ffn(i), window, theta))
        return tuple(out)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def with_sliding_window(self, window: int) -> "ArchConfig":
        """Beyond-paper long-context variant: uniform local attention."""
        return self.replace(sliding_window=window, local_global=None)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES: dict[str, InputShape] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}
