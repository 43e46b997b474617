"""Recurrent mixers: Mamba (jamba) and xLSTM's mLSTM and sLSTM blocks.

Counterpart of `repro.models.ssm`.  The Mamba prefill runs the selective
scan through `kernels.ops.selective_scan`, and the mLSTM prefill the
chunkwise kernel through `kernels.ops.mlstm`; their single-step decodes
and the rebuild of the mLSTM's terminal state after a cached prefill are
plain tensor code, as in JAX.  The sLSTM is a Python loop over the
sequence in place of ``lax.scan``: it is sequential by nature, and JAX has
no kernel for it either.

Parameters mirror the JAX pytree, whose mixer dicts hold raw arrays
(``conv_w``, ``conv_b``, Mamba's ``A_log`` and ``D``, the sLSTM's ``r``)
beside dense sub-dicts: a `ParamGroup` holds both and is read as a
mapping.  With a cache, the state tensors are updated in place (``copy_``,
``mul_``) and the same dict is returned, as the attention cache is.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops
from .layers import ParamGroup, _dense_init, _params, dense

Params = Mapping[str, Any]


def _headify(x: torch.Tensor, H: int) -> torch.Tensor:
    B, L, di = x.shape
    return x.reshape(B, L, H, di // H)


def _groupnorm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-head RMS-style normalization; x: (B, L, H, Dh)."""
    B, L, H, Dh = x.shape
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + 1e-6)
    return (y.reshape(B, L, H * Dh) * w.float()).to(x.dtype)


def _causal_conv(p: Params, xm: torch.Tensor, state: torch.Tensor | None):
    """Depthwise causal conv + SiLU over (B, L, di), as the JAX package's
    shifted-window sum in f32 (not ``F.conv1d``, which cuDNN runs in TF32).
    ``state`` holds the K - 1 rows before ``xm``; returns (xc, context)."""
    L = xm.shape[1]
    K = p["conv_w"].shape[0]
    if state is not None:
        ctx = torch.cat([state.to(xm.dtype), xm], dim=1)
    else:
        ctx = F.pad(xm, (0, 0, K - 1, 0))
    w = p["conv_w"].float()
    acc = ctx[:, 0:L].float() * w[0]
    for i in range(1, K):
        acc = acc + ctx[:, i : i + L].float() * w[i]
    return F.silu(acc + p["conv_b"].float()).to(xm.dtype), ctx


# ------------------------------------------------------------------- Mamba
def mamba_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> ParamGroup:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.d_state
    dt_rank = max(1, d // 16)
    dev = gen.device
    conv_w = torch.randn((cfg.d_conv, di), generator=gen, device=dev, dtype=torch.float32) * 0.1
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(di, 1)
    return ParamGroup(
        {
            "in_proj": _dense_init(gen, d, 2 * di, dtype),
            "x_proj": _dense_init(gen, di, dt_rank + 2 * N, dtype),
            "dt_proj": _dense_init(gen, dt_rank, di, dtype, bias=True),
            "out_proj": _dense_init(gen, di, d, dtype),
        },
        conv_w=conv_w.to(dtype),
        conv_b=torch.zeros((di,), dtype=dtype, device=dev),
        A_log=torch.log(A),  # f32 whatever ``dtype``, as in JAX
        D=torch.ones((di,), dtype=torch.float32, device=dev),
    )


def mamba_cache_init(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    """The conv tail (B, d_conv - 1, di) in ``dtype``; the state h in f32,
    in the JAX package's (B, N, D) layout."""
    di = cfg.ssm_expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_state, di), dtype=torch.float32, device=device),
    }


def _mamba_ssm_inputs(p: Params, cfg: ArchConfig, xc: torch.Tensor):
    """xc (B, L, di), the post-conv activations -> (dt, A, B, C) of the
    recurrence: dt (B, L, di) and A (di, N) f32; B and C (B, L, N) f32,
    column slices of one projection when the model computes in f32."""
    N = cfg.d_state
    dt_rank = p["dt_proj"]["w"].shape[0]
    dt, Bm, Cm = dense(p["x_proj"], xc).split([dt_rank, N, N], dim=-1)
    dt = F.softplus(dense(p["dt_proj"], dt).float())
    A = -torch.exp(p["A_log"].float())
    return dt, A, Bm.float(), Cm.float()


def mamba_forward(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, L, d)
    *,
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Mamba block; returns (y, cache).

    Without a cache, or with one and ``L > 1`` (a prefill that starts from
    the cache's h and conv rows, as JAX's does), the sequence runs through
    the selective scan.  With a cache and ``L == 1`` it is one recurrent
    step from the cached state, in the (B, N, D) layout.  The D x skip is
    added outside the scan, and y is rounded to x's dtype before the
    ``silu(z)`` gate, as in JAX.  The cache is written in place and returned.
    """
    xm, z = dense(p["in_proj"], x).chunk(2, dim=-1)
    xc, ctx = _causal_conv(p, xm, None if cache is None else cache["conv"])
    dt, A, Bm, Cm = _mamba_ssm_inputs(p, cfg, xc)
    if x.shape[1] == 1 and cache is not None:
        h = cache["h"]
        a = torch.exp(dt[:, 0, None, :] * A.T[None])  # (B, N, D)
        bx = (dt[:, 0] * xc[:, 0].float())[:, None, :] * Bm[:, 0, :, None]
        h.mul_(a).add_(bx)
        y = torch.einsum("bnd,bn->bd", h, Cm[:, 0])[:, None]
    else:
        y, h_last = ops.selective_scan(xc, dt, A, Bm, Cm, None if cache is None else cache["h"])
        y = y.float()
        if cache is not None:
            cache["h"].copy_(h_last)
    y = y + xc.float() * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    if cache is not None:
        K = p["conv_w"].shape[0]
        cache["conv"].copy_(ctx[:, -(K - 1):])
    return dense(p["out_proj"], y), cache


# ------------------------------------------------------------------- mLSTM
def mlstm_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> ParamGroup:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = cfg.n_heads
    dev = gen.device
    conv_w = torch.randn((4, di), generator=gen, device=dev, dtype=torch.float32) * 0.1
    return ParamGroup(
        {
            "up": _dense_init(gen, d, 2 * di, dtype),
            "q": _dense_init(gen, di, di, dtype),
            "k": _dense_init(gen, di, di, dtype),
            "v": _dense_init(gen, di, di, dtype),
            "if_gate": _dense_init(gen, di, 2 * H, dtype, bias=True),
            "gn": _params(w=torch.ones((di,), dtype=dtype, device=dev)),  # per-head groupnorm scale
            "down": _dense_init(gen, di, d, dtype),
        },
        conv_w=conv_w.to(dtype),
        conv_b=torch.zeros((di,), dtype=dtype, device=dev),
    )


def mlstm_cache_init(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    """The conv tail in ``dtype``; the matrix memory C, normalizer n and
    stabilizer m in f32."""
    di = cfg.ssm_expand * cfg.d_model
    H = cfg.n_heads
    Dh = di // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, 3, di), dtype=dtype, device=device),
        "C": torch.zeros((batch, H, Dh, Dh), **f32),
        "n": torch.zeros((batch, H, Dh), **f32),
        "m": torch.zeros((batch, H), **f32),
    }


def mlstm_forward(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, L, d)
    *,
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """mLSTM block; returns (y, cache).

    Without a cache the sequence runs through the chunkwise kernel.  With
    one, ``L == 1`` is a single recurrent step from the cached state, and
    ``L > 1`` a prefill that starts the matrix state from zero (reading only
    the cache's conv rows, as JAX does) and rebuilds the terminal C, n and m
    in closed form.  The cache is written in place and returned.
    """
    B, L, d = x.shape
    H = cfg.n_heads
    Dh = cfg.ssm_expand * d // H
    xm, z = dense(p["up"], x).chunk(2, dim=-1)
    xc, ctx = _causal_conv(p, xm, None if cache is None else cache["conv"])

    # v comes from the pre-conv activations, q and k from the conv output
    q = _headify(dense(p["q"], xc), H)
    k = _headify(dense(p["k"], xc), H)
    v = _headify(dense(p["v"], xm), H)
    gif = dense(p["if_gate"], xc).float()
    li = gif[..., :H]  # log input gate (pre-exp)
    lf = F.logsigmoid(gif[..., H:])  # log forget gate

    if L == 1 and cache is not None:
        m_prev, C, n = cache["m"], cache["C"], cache["n"]
        li0, lf0 = li[:, 0], lf[:, 0]
        m_new = torch.maximum(lf0 + m_prev, li0)
        i_s = torch.exp(li0 - m_new)[..., None]
        f_s = torch.exp(lf0 + m_prev - m_new)[..., None]
        kf = k[:, 0].float() * (Dh ** -0.5)
        vf = v[:, 0].float()
        C.mul_(f_s[..., None]).add_(i_s[..., None] * kf[..., :, None] * vf[..., None, :])
        n.mul_(f_s).add_(i_s * kf)
        qf = q[:, 0].float()
        num = torch.einsum("bhd,bhdv->bhv", qf, C)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(), torch.exp(-m_new))
        y = (num / den[..., None]).to(x.dtype)[:, None]  # (B, 1, H, Dh)
        m_prev.copy_(m_new)
    else:
        y = ops.mlstm(q, k, v, li, lf)
        if cache is not None:
            # rebuild the terminal recurrent state for subsequent decode
            kf = k.float() * (Dh ** -0.5)
            vf = v.float()
            Fc = torch.cumsum(lf, dim=1)
            m_new = (Fc[:, -1:] - Fc + li).amax(dim=1)  # (B, H)
            w = torch.exp(Fc[:, -1:] - Fc + li - m_new[:, None])  # (B, L, H)
            cache["C"].copy_(torch.einsum("blh,blhd,blhv->bhdv", w, kf, vf))
            cache["n"].copy_(torch.einsum("blh,blhd->bhd", w, kf))
            cache["m"].copy_(m_new)
    if cache is not None:
        K = p["conv_w"].shape[0]
        cache["conv"].copy_(ctx[:, -(K - 1):])
    y = _groupnorm(y, p["gn"]["w"])
    return dense(p["down"], y * F.silu(z)), cache


# ------------------------------------------------------------------- sLSTM
def slstm_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> ParamGroup:
    d = cfg.d_model
    H = cfg.n_heads
    Dh = d // H
    dff = -(-(d * 4 // 3) // 8) * 8  # ~4/3 expansion, rounded up to multiple of 8
    r = torch.randn((H, Dh, 4 * Dh), generator=gen, device=gen.device, dtype=torch.float32) * (Dh ** -0.5)
    return ParamGroup(
        {
            "w": _dense_init(gen, d, 4 * d, dtype, bias=True),  # i f z o from input
            "gn": _params(w=torch.ones((d,), dtype=dtype, device=gen.device)),
            "up": _dense_init(gen, d, 2 * dff, dtype),
            "down": _dense_init(gen, dff, d, dtype),
        },
        r=r.to(dtype),
    )


def slstm_cache_init(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    """The cell c, normalizer n, hidden h (B, H, Dh) and stabilizer m (B, H),
    all f32 whatever ``dtype`` (as in JAX)."""
    H = cfg.n_heads
    Dh = cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, H, Dh), **f32),
        "n": torch.zeros((batch, H, Dh), **f32),
        "h": torch.zeros((batch, H, Dh), **f32),
        "m": torch.zeros((batch, H), **f32),
    }


def _slstm_step(r: torch.Tensor, cfg: ArchConfig, state: dict, wx_t: torch.Tensor):
    """One sLSTM step.  ``r``: the recurrent weights in f32; wx_t: (B, 4d)
    precomputed input contribution.  Returns (new state, h)."""
    H = cfg.n_heads
    Dh = cfg.d_model // H
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    rh = torch.einsum("bhd,hdk->bhk", h, r)  # (B, H, 4Dh)
    g = wx_t.reshape(-1, H, 4 * Dh).float() + rh
    gi, gf, gz, go = g.chunk(4, dim=-1)
    li = gi.mean(-1)  # scalar gates per head
    lf = F.logsigmoid(gf.mean(-1))
    zt = torch.tanh(gz)
    ot = torch.sigmoid(go)
    m_new = torch.maximum(lf + m, li)
    i_s = torch.exp(li - m_new)[..., None]
    f_s = torch.exp(lf + m - m_new)[..., None]
    c_new = f_s * c + i_s * zt
    n_new = f_s * n + i_s
    h_new = ot * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}, h_new


def slstm_forward(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, L, d)
    *,
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """sLSTM block; returns (y, cache).  The recurrence starts from the
    cache's state (zeros without one), and a given cache ends holding the
    state after the last token, written in place."""
    B, L, d = x.shape
    H = cfg.n_heads
    wx = dense(p["w"], x)  # (B, L, 4d)
    state = dict(cache) if cache is not None else slstm_cache_init(cfg, B, x.dtype, x.device)
    r = p["r"].float()
    hs = []
    for t in range(L):
        state, h = _slstm_step(r, cfg, state, wx[:, t])
        hs.append(h)
    hs = torch.stack(hs, dim=1).reshape(B, L, d).to(x.dtype)  # (B, L, H*Dh)
    y = _groupnorm(hs.reshape(B, L, H, d // H), p["gn"]["w"])
    a, b = dense(p["up"], y).chunk(2, dim=-1)
    # jax.nn.gelu defaults to the tanh approximation
    out = dense(p["down"], F.gelu(a, approximate="tanh") * b)
    if cache is not None:
        for name, t in state.items():
            cache[name].copy_(t)
    return out, cache
