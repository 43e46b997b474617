"""Plain PyTorch versions of the kernels (the semantics of record).

Counterpart of `repro.kernels.ref` for the functions this port's kernels
replace.  Numerics follow the JAX oracles: upcast to f32, fill masked
logits with ``NEG_INF = -1e30`` (not ``-inf``), softmax over the f32
logits, cast back to the input dtype.  CPU tensors run these; on the card
`chip_smoke.py` holds each kernel against them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6, gemma: bool = False) -> torch.Tensor:
    """RMSNorm; ``gemma=True`` uses the (1 + w) parameterization."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w32 = w.float()
    scale = 1.0 + w32 if gemma else w32
    return (y * scale).to(x.dtype)


def _mask(
    q_len: int, k_len: int, *, causal: bool, window: int | None, q_offset: int = 0,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """(q_len, k_len) boolean attention mask.

    ``q_offset`` is the absolute position of query row 0.
    """
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(k_len, device=device)[None, :]
    m = torch.ones((q_len, k_len), dtype=torch.bool, device=device)
    if causal:
        m &= kj <= qi
    if window is not None:
        m &= kj > qi - window
    return m


def attention(
    q: torch.Tensor,  # (B, Sq, Hq, Dk)
    k: torch.Tensor,  # (B, Sk, Hkv, Dk)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    kv_len: torch.Tensor | None = None,  # (B,) valid cache lengths
) -> torch.Tensor:
    """Grouped-query attention.  Returns (B, Sq, Hq, Dv) in ``q.dtype``."""
    B, Sq, Hq, Dk = q.shape
    _, Sk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    assert Hq % Hkv == 0, (Hq, Hkv)
    g = Hq // Hkv
    scale = scale if scale is not None else Dk ** -0.5
    qf = q.float().reshape(B, Sq, Hkv, g, Dk)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    mask = _mask(Sq, Sk, causal=causal, window=window, q_offset=q_offset, device=q.device)
    if kv_len is not None:
        valid = torch.arange(Sk, device=q.device)[None, :] < kv_len[:, None]  # (B, Sk)
        mask = (mask[None] & valid[:, None, :])[:, None, None]  # (B,1,1,Sq,Sk)
    else:
        mask = mask[None, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, Dv).to(q.dtype)
