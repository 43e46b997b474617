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

# PyTorch's CPU exp (seen with torch 2.13.0+cpu) can return values off in
# the fourth digit on its first call in a process when that call is split
# across threads, as the mLSTM weights' first exp is; one single-threaded
# call settles its kernel dispatch before any such call.
torch.exp(torch.zeros(1))


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


def decode_attention(
    q: torch.Tensor,        # (B, Hq, Dk): one new token per sequence
    k_cache: torch.Tensor,  # (B, S, Hkv, Dk)
    v_cache: torch.Tensor,  # (B, S, Hkv, Dv)
    lengths: torch.Tensor,  # (B,) valid cache entries (this token included)
    *,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-step cache attention.  Returns (B, Hq, Dv) in ``q.dtype``.

    Cache slot ``pos`` is live when ``pos < length`` and, given a window,
    ``pos > length - 1 - window``.
    """
    B, Hq, Dk = q.shape
    _, S, Hkv, _ = k_cache.shape
    Dv = v_cache.shape[-1]
    g = Hq // Hkv
    scale = scale if scale is not None else Dk ** -0.5
    qf = q.float().reshape(B, Hkv, g, Dk)
    logits = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)[None, :]
    lens = lengths.to(q.device)[:, None]
    valid = pos < lens
    if window is not None:
        valid &= pos > lens - 1 - window
    logits = torch.where(valid[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, Dv).to(q.dtype)


def mlstm_chunked(
    q: torch.Tensor,       # (B, L, H, D)
    k: torch.Tensor,       # (B, L, H, D)
    v: torch.Tensor,       # (B, L, H, D)
    i_gate: torch.Tensor,  # (B, L, H) log input gate (pre-exp)
    f_gate: torch.Tensor,  # (B, L, H) log forget gate (log sigmoid applied)
    *,
    chunk: int = 64,
) -> torch.Tensor:
    """mLSTM parallel form (full quadratic; the kernel is chunked, ``chunk``
    is not read).  Returns (B, L, H, D) in ``q.dtype``.  Computes in f32, as
    JAX does, or in f64 for f64 inputs (a reference for the f32 paths).

    Stabilized exponential gating as in the xLSTM paper: with cumulative log
    forget F_t = sum_{s<=t} logf_s, the unnormalized weight of (t, s) is
    exp(F_t - F_s + i_s - m_t) where m_t is the running max for stability.
    """
    B, L, H, D = q.shape
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf, kf, vf = (x.to(ct) for x in (q, k, v))
    lf = f_gate.to(ct)
    li = i_gate.to(ct)
    F = torch.cumsum(lf, dim=1)  # (B, L, H)
    # log weight matrix  Dmat[t, s] = F_t - F_s + i_s  (s <= t)
    logw = F[:, :, None] - F[:, None, :] + li[:, None, :]  # (B, L, L, H)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    logw = torch.where(tri[None, :, :, None], logw, torch.full_like(logw, NEG_INF))
    m = logw.amax(dim=2, keepdim=True)  # (B, L, 1, H)
    w = torch.exp(logw - m)
    scores = torch.einsum("bthd,bshd->btsh", qf, kf) * (D ** -0.5)
    num = torch.einsum("btsh,btsh,bshd->bthd", scores, w, vf)
    den = torch.einsum("btsh,btsh->bth", scores, w).abs()
    den = torch.maximum(den, torch.exp(-m[:, :, 0, :]))  # xLSTM max(|n|, exp(-m))
    return (num / den[..., None]).to(q.dtype)
