# Copy of repro/profiling/analytic.py (the JAX package's original). Changed: the hardware spec type
# is GPUSpec, arch_profile's default hardware is the H100 (repro_torch.profiling.hardware), and the
# docstring no longer names the original's change history.
"""Analytic model accounting and the analytic TPU profiler.

One module for the whole analytic chain:

* parameter / FLOPs / KV-cache accounting per assigned architecture
  (MODEL_FLOPS = 6 N D for training, 2 N_active per token for inference),
  used by `launch.roofline` and the profiler below;
* the analytic TPU profiler ``(arch, batch, seq, hardware) -> duration``,
  replacing the paper's offline GPU profiling pass (Sec. III-A "profiling
  library"): module execution duration is the roofline max of the compute
  and HBM-streaming terms, with a batch-dependent efficiency ramp (small
  batches under-utilize the MXU) — producing Table-I-shaped profiles
  (duration affine-ish in batch, concave throughput).
"""
from __future__ import annotations

from ..configs.base import ArchConfig, LayerSpec
from ..core.profiles import Config, ModuleProfile
from .hardware import CATALOG, GPUSpec

DEFAULT_BATCHES = (1, 2, 4, 8, 16, 32)


# ---------------------------------------------------------------------------
# Parameter / FLOPs accounting
# ---------------------------------------------------------------------------


def _attn_params(cfg: ArchConfig) -> int:
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    p = d * H * Dh + 2 * d * Hkv * Dh + H * Dh * d
    if cfg.qkv_bias:
        p += H * Dh + 2 * Hkv * Dh
    return p


def _mla_params(cfg: ArchConfig) -> int:
    d, H = cfg.d_model, cfg.n_heads
    dq, dc, dr = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.rope_head_dim
    dn, dv = cfg.hdim, cfg.vdim
    p = d * (dc + dr) + dc * H * dn + dc * H * dv + H * dv * d
    if dq:
        p += d * dq + dq * H * (dn + dr)
    else:
        p += d * H * (dn + dr)
    return p


def _mamba_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.d_state
    dtr = max(1, d // 16)
    return 2 * d * di + cfg.d_conv * di + di * (dtr + 2 * N) + dtr * di + di * N + di * d


def _mlstm_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = cfg.n_heads
    return 2 * d * di + 4 * di + 3 * di * di + di * 2 * H + di * d


def _slstm_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    H = cfg.n_heads
    Dh = d // H
    dff = -(-(d * 4 // 3) // 8) * 8
    return 4 * d * d + H * Dh * 4 * Dh + 2 * d * dff + dff * d


def _moe_params(cfg: ArchConfig, *, active: bool) -> int:
    d, fe = cfg.d_model, cfg.d_ff_expert
    e = cfg.top_k if active else cfg.n_experts
    p = cfg.d_model * cfg.n_experts + e * 3 * d * fe  # router counted full
    p += 3 * d * fe * cfg.n_shared_experts
    return p


def layer_params(cfg: ArchConfig, spec: LayerSpec, *, active: bool = False) -> int:
    mix = {
        "attn": _attn_params,
        "mla": _mla_params,
        "mamba": _mamba_params,
        "mlstm": _mlstm_params,
        "slstm": _slstm_params,
    }[spec.mixer](cfg)
    ffn = 0
    if spec.ffn == "dense":
        ffn = 3 * cfg.d_model * cfg.d_ff
    elif spec.ffn == "moe":
        ffn = _moe_params(cfg, active=active)
    norms = 2 * cfg.d_model
    return mix + ffn + norms


def param_count(cfg: ArchConfig, *, active: bool = False, embed: bool = True) -> int:
    total = sum(layer_params(cfg, s, active=active) for s in cfg.layer_specs())
    if embed:
        total += cfg.vocab_size * cfg.d_model
        if not cfg.tie_embeddings:
            total += cfg.vocab_size * cfg.d_model
    return total


def layer_flops_per_token(
    cfg: ArchConfig, spec: LayerSpec, seq: int, *, decode: bool = False
) -> float:
    """Forward FLOPs per token of ONE layer: 2 x active params + context term."""
    flops = 2.0 * layer_params(cfg, spec, active=True)
    if spec.mixer in ("attn", "mla"):
        Dh = cfg.hdim + (cfg.rope_head_dim if spec.mixer == "mla" else 0)
        Dv = cfg.vdim if spec.mixer == "mla" else cfg.hdim
        ctx = seq if decode else seq / 2  # causal prefill averages ~S/2
        if spec.window:
            ctx = min(ctx, spec.window)
        flops += 2.0 * cfg.n_heads * (Dh + Dv) * ctx
    elif spec.mixer == "mamba":
        di = cfg.ssm_expand * cfg.d_model
        flops += 6.0 * di * cfg.d_state  # recurrence + output contraction
    elif spec.mixer in ("mlstm", "slstm"):
        di = cfg.ssm_expand * cfg.d_model
        flops += 8.0 * di * (di // max(1, cfg.n_heads))  # state update
    return flops


def flops_per_token(cfg: ArchConfig, seq: int, *, decode: bool = False) -> float:
    """Forward FLOPs per token: active matmuls + attention context + unembed."""
    flops = sum(
        layer_flops_per_token(cfg, s, seq, decode=decode) for s in cfg.layer_specs()
    )
    flops += 2.0 * cfg.d_model * cfg.vocab_size  # unembed
    return flops


def kv_cache_bytes_per_token(cfg: ArchConfig, dtype_bytes: int = 2) -> float:
    total = 0.0
    for s in cfg.layer_specs():
        if s.mixer == "attn":
            total += 2 * cfg.n_kv_heads * cfg.hdim * dtype_bytes
        elif s.mixer == "mla":
            total += (cfg.kv_lora_rank + cfg.rope_head_dim) * dtype_bytes
        # ssm mixers: O(1) state, no per-token cache
    return total


# ---------------------------------------------------------------------------
# Analytic TPU profiler
# ---------------------------------------------------------------------------


def module_duration(
    cfg: ArchConfig,
    batch: int,
    seq: int,
    hw: GPUSpec,
    *,
    mode: str = "prefill",
    base_mfu: float = 0.55,
) -> float:
    """Seconds to run one batched inference of the module on ONE chip."""
    ftok = flops_per_token(cfg, seq, decode=(mode == "decode"))
    tokens = batch * (1 if mode == "decode" else seq)
    flops = ftok * tokens
    # efficiency ramps with batch: tiny batches stall the MXU
    mfu = base_mfu * min(1.0, 0.35 + 0.65 * (batch / 16.0) ** 0.5)
    compute_t = flops / (hw.peak_flops_bf16 * mfu)
    # memory: weights stream once per batch; activations per token
    n_params = param_count(cfg, active=True)
    bytes_moved = 2.0 * n_params + tokens * cfg.d_model * 2.0 * (2 * cfg.n_layers)
    mem_t = bytes_moved / hw.hbm_bw
    fixed = 30e-6  # launch/dispatch overhead
    return fixed + max(compute_t, mem_t)


def arch_profile(
    cfg: ArchConfig,
    *,
    seq: int = 128,
    batches=DEFAULT_BATCHES,
    hardware: tuple[str, ...] = ("h100-sxm",),
    mode: str = "prefill",
) -> ModuleProfile:
    """A Harpagon ModuleProfile for one architecture (the planner's input)."""
    cfgs = []
    for hw_name in hardware:
        hw = CATALOG[hw_name]
        for b in batches:
            d = module_duration(cfg, b, seq, hw, mode=mode)
            cfgs.append(Config(b, round(d, 6), hw.name, hw.unit_price))
    return ModuleProfile(cfg.name, tuple(cfgs))
