"""Decoder layers: norms, RoPE / M-RoPE, GQA attention, gated MLPs.

Counterpart of `repro.models.layers` for the attention + dense-MLP stack.
Each function takes its parameters as a mapping of name to tensor or
sub-mapping (an `nn.ParameterDict` / `nn.ModuleDict` inside `Model`, or a
plain dict), in the JAX package's layout: a dense weight is (d_in, d_out)
and is applied as ``x @ w``.  Attention and RMSNorm go through `kernels.ops`.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig, LayerSpec
from ..kernels import ops

Params = Mapping[str, Any]


def _params(**tensors: torch.Tensor) -> nn.ParameterDict:
    return nn.ParameterDict(
        {k: nn.Parameter(t, requires_grad=False) for k, t in tensors.items()}
    )


class ParamGroup(nn.ModuleDict):
    """Sub-modules and raw parameters under one mapping: ``g["up"]`` is a
    dense dict, ``g["conv_w"]`` a tensor."""

    def __init__(self, modules: dict[str, nn.Module], **tensors: torch.Tensor):
        super().__init__(modules)
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return super().__getitem__(key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or super().__contains__(key)


# --------------------------------------------------------------------- init
def _dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, *, bias: bool = False) -> nn.ParameterDict:
    dev = gen.device
    w = torch.randn((d_in, d_out), generator=gen, device=dev, dtype=torch.float32) * (d_in ** -0.5)
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    return _params(**p)


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def norm_init(cfg: ArchConfig, d: int, dtype, device) -> nn.ParameterDict:
    if cfg.norm == "ln":
        return _params(
            w=torch.ones((d,), dtype=dtype, device=device),
            b=torch.zeros((d,), dtype=dtype, device=device),
        )
    # gemma-style (1 + w) stores zeros
    fill = torch.zeros if cfg.gemma_norm else torch.ones
    return _params(w=fill((d,), dtype=dtype, device=device))


def apply_norm(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "ln":
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + 1e-5)
        return (y * p["w"].float() + p["b"].float()).to(x.dtype)
    return ops.rmsnorm(x, p["w"], gemma=cfg.gemma_norm)


# --------------------------------------------------------------------- RoPE
def _rope_angles(pos: torch.Tensor, dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """pos (..., S) -> cos/sin (..., S, dim/2)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = pos.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(
    x: torch.Tensor,  # (B, S, H, D)
    positions: torch.Tensor,  # (B, S) or (3, B, S) for M-RoPE
    theta: float,
    mrope_sections: tuple[int, ...] | None = None,
) -> torch.Tensor:
    D = x.shape[-1]
    if mrope_sections is None:
        cos, sin = _rope_angles(positions, D, theta)  # (B, S, D/2)
    else:
        # Qwen2-VL M-RoPE: the D/2 rotary frequencies split into (temporal,
        # height, width) sections, each driven by its own position stream
        assert positions.ndim == 3 and sum(mrope_sections) == D // 2
        cos_full, sin_full = _rope_angles(positions, D, theta)  # (3, B, S, D/2)
        chunks_c, chunks_s = [], []
        off = 0
        for i, sec in enumerate(mrope_sections):
            chunks_c.append(cos_full[i, ..., off : off + sec])
            chunks_s.append(sin_full[i, ..., off : off + sec])
            off += sec
        cos = torch.cat(chunks_c, -1)
        sin = torch.cat(chunks_s, -1)
    cos = cos[:, :, None, :]  # (B, S, 1, D/2)
    sin = sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
def attn_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> nn.ModuleDict:
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    p = nn.ModuleDict({
        "q": _dense_init(gen, d, H * Dh, dtype, bias=cfg.qkv_bias),
        "k": _dense_init(gen, d, Hkv * Dh, dtype, bias=cfg.qkv_bias),
        "v": _dense_init(gen, d, Hkv * Dh, dtype, bias=cfg.qkv_bias),
        "o": _dense_init(gen, H * Dh, d, dtype),
    })
    if cfg.qk_norm:
        p["qn"] = _params(w=torch.ones((Dh,), dtype=dtype, device=gen.device))
        p["kn"] = _params(w=torch.ones((Dh,), dtype=dtype, device=gen.device))
    return p


def _qk_norm(cfg: ArchConfig, p: Params, q: torch.Tensor, k: torch.Tensor):
    if not cfg.qk_norm:
        return q, k
    return (
        ops.rmsnorm(q, p["qn"]["w"], gemma=cfg.gemma_norm),
        ops.rmsnorm(k, p["kn"]["w"], gemma=cfg.gemma_norm),
    )


def attn_cache_init(cfg: ArchConfig, spec: LayerSpec, batch: int, max_seq: int, dtype, device) -> dict:
    """Zeroed (B, size, Hkv, Dh) K and V caches; windowed layers keep a ring
    of ``min(max_seq, window)`` slots."""
    size = min(max_seq, spec.window) if spec.window else max_seq
    Hkv, Dh = cfg.n_kv_heads, cfg.hdim
    return {
        "k": torch.zeros((batch, size, Hkv, Dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, Hkv, Dh), dtype=dtype, device=device),
    }


def attn_forward(
    p: Params,
    cfg: ArchConfig,
    spec: LayerSpec,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,
    *,
    cache: dict | None = None,
    idx: int | None = None,  # cache fill level (decode)
) -> tuple[torch.Tensor, dict | None]:
    """Attention; returns (y, cache).

    Without a cache (train / prefill) the cache returned is None.  With one,
    ``S > 1`` is a prefill that writes the last ``size`` keys and values at
    slot 0 (rolled on a ring so that absolute position p lands in slot
    p % size), and ``S == 1`` a decode step that writes slot ``idx % size``
    on a ring, ``min(idx, size - 1)`` otherwise, then attends over the cache
    with `ops.decode_attention`.  Unlike the JAX package, which returns new
    arrays, the writes go in place into ``cache["k"]`` and ``cache["v"]``
    (copying the whole cache each step would move more bytes than the decode
    kernel reads), and the same dict is returned.
    """
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    theta = spec.rope_theta or cfg.rope_theta
    q = dense(p["q"], x).reshape(B, S, H, Dh)
    k = dense(p["k"], x).reshape(B, S, Hkv, Dh)
    v = dense(p["v"], x).reshape(B, S, Hkv, Dh)
    q, k = _qk_norm(cfg, p, q, k)
    q = apply_rope(q, positions, theta, cfg.mrope_sections)
    k = apply_rope(k, positions, theta, cfg.mrope_sections)

    if cache is None or S > 1:
        if cache is not None:  # prefill into the cache
            size = cache["k"].shape[1]
            k_in, v_in = k[:, -size:], v[:, -size:]
            if spec.window and S > size:
                # ring buffer: absolute position p lives in slot p % size
                k_in = torch.roll(k_in, S % size, dims=1)
                v_in = torch.roll(v_in, S % size, dims=1)
            cache["k"][:, : k_in.shape[1]] = k_in
            cache["v"][:, : v_in.shape[1]] = v_in
        out = ops.attention(q, k, v, causal=True, window=spec.window)
    else:  # single-token decode
        size = cache["k"].shape[1]
        # dynamic_update_slice clamps its start: mirror min(idx, size - 1)
        write = idx % size if spec.window else min(idx, size - 1)
        cache["k"][:, write] = k[:, 0]
        cache["v"][:, write] = v[:, 0]
        lengths = torch.full((B,), min(idx + 1, size), dtype=torch.int32, device=x.device)
        ring = spec.window is not None
        out = ops.decode_attention(
            q[:, 0], cache["k"], cache["v"], lengths, window=None if ring else spec.window,
        )[:, None]
    y = ops.row_parallel_dense(out.reshape(B, S, H * Dh), p["o"]["w"])
    return y, cache


# --------------------------------------------------------------------- MLP
def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype) -> nn.ModuleDict:
    return nn.ModuleDict({
        "w1": _dense_init(gen, d, d_ff, dtype),  # gate
        "w3": _dense_init(gen, d, d_ff, dtype),  # up
        "w2": _dense_init(gen, d_ff, d, dtype),  # down
    })


def mlp_forward(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    g = dense(p["w1"], x)
    # jax.nn.gelu defaults to the tanh approximation
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    h = g * dense(p["w3"], x)
    return ops.row_parallel_dense(h, p["w2"]["w"])


# --------------------------------------------------------------- embeddings
def embed_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> nn.ParameterDict:
    w = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=gen.device,
                    dtype=torch.float32) * 0.02
    return _params(w=w.to(dtype))


def embed(p: Params, cfg: ArchConfig, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    x = p["w"][tokens].to(compute_dtype)
    if cfg.gemma_norm:
        x = x * math.sqrt(cfg.d_model)
    return x
