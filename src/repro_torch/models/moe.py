"""Mixture-of-Experts, the local (one-device, dropless) path.

Counterpart of `repro.models.moe` for one device: `moe_init` (ep = 1),
`route`, `expert_ffn_local` and `moe_forward` with shared experts.  Tokens
are sorted by expert (a stable sort, as ``jnp.argsort``), each expert's
rows go through its gated FFN, and the gated outputs are scattered back
with ``index_add_``.  The JAX package's grouped matmul is
``jax.lax.ragged_dot``, which no Pallas kernel computes, so here it is one
``torch.matmul`` per expert on that expert's slice of the sorted rows.
Expert parallelism (``expert_ffn_ep``, the shard_map path) waits for a
multi-GPU slice.

Expert weights are stored stacked, (E, d, f) and (E, f, d), as in JAX, in a
`layers.ParamGroup` beside the ``router`` and the optional ``shared`` MLP.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import ParamGroup, _dense_init, dense, mlp_forward, mlp_init

Params = Mapping[str, Any]


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> ParamGroup:
    """The router (d, E), w1 and w3 (E, d, f) and w2 (E, f, d), and, with
    shared experts, one MLP of width ``n_shared_experts * f``."""
    d, f, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    dev = gen.device

    def stacked(d_in: int, d_out: int) -> torch.Tensor:
        w = torch.empty((E, d_in, d_out), dtype=dtype, device=dev)
        for e in range(E):  # one expert at a time: an f32 draw of all E would take E times the memory
            w[e] = torch.randn((d_in, d_out), generator=gen, device=dev, dtype=torch.float32) * (d_in ** -0.5)
        return w

    modules = {"router": _dense_init(gen, d, E, dtype)}
    if cfg.n_shared_experts:
        modules["shared"] = mlp_init(gen, d, f * cfg.n_shared_experts, dtype)
    return ParamGroup(modules, w1=stacked(d, f), w3=stacked(d, f), w2=stacked(f, d))


def route(p: Params, cfg: ArchConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: top-k ids, renormalized gates and the switch-style aux loss.

    x (N, d) -> ids (N, k) int64, gates (N, k) f32, aux () f32.
    """
    E = cfg.n_experts
    logits = dense(p["router"], x).float()[..., :E]  # drop padding experts
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balance loss: E * sum_e (fraction routed to e) * (mean prob of e)
    frac = F.one_hot(ids, E).float().sum(1).mean(0) / cfg.top_k
    aux = E * torch.sum(frac * probs.mean(0))
    return ids, gates, aux


def expert_ffn_local(p: Params, cfg: ArchConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dropless MoE on one device: sort by expert, per-expert FFN, unsort.

    x (N, d) -> (N, d) in x's dtype, aux loss.
    """
    N, d = x.shape
    k = cfg.top_k
    E_pad = p["w1"].shape[0]
    ids, gates, aux = route(p, cfg, x)
    flat_ids = ids.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    token_of = order // k
    xs = x[token_of]  # (N k, d), sorted by expert
    # The group sizes are read on the host: one sync per MoE layer, which a
    # step captured in a CUDA graph will have to do without.
    sizes = torch.bincount(flat_ids, minlength=E_pad).tolist()
    ys = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(sizes):
        if n == 0:
            continue
        xe = xs[start:start + n]
        h1 = xe @ p["w1"][e].to(x.dtype)
        h3 = xe @ p["w3"][e].to(x.dtype)
        # jax.nn.gelu defaults to the tanh approximation
        act = F.silu(h1) if cfg.act == "silu" else F.gelu(h1, approximate="tanh")
        ys[start:start + n] = (act * h3) @ p["w2"][e].to(x.dtype)
        start += n
    w = gates.reshape(-1)[order].to(x.dtype)
    out = torch.zeros((N, d), dtype=x.dtype, device=x.device).index_add_(0, token_of, ys * w[:, None])
    return out, aux


def moe_forward(p: Params, cfg: ArchConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (B, S, d), aux: the routed experts plus the shared ones."""
    B, S, d = x.shape
    flat = x.reshape(B * S, d)
    y, aux = expert_ffn_local(p, cfg, flat)
    if "shared" in p:
        y = y + mlp_forward(p["shared"], flat, cfg.act)
    return y.reshape(B, S, d), aux
