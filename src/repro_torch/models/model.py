"""Decoder model: embed, a stack of blocks, final norm, unembed.

Counterpart of `repro.models.model` for stacks of attention + dense-MLP
blocks and of xLSTM's mLSTM / sLSTM blocks.  `segmentize` is copied verbatim
so the bridge can read the JAX parameter layout; the blocks themselves are a
flat `nn.ModuleList` in layer order, and a Python loop over it replaces the
JAX package's ``lax.scan``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..configs.base import ArchConfig, LayerSpec
from . import layers as Lyr
from . import ssm as Ssm

# the ROADMAP items (queue 1) that bring the parts this slice does not port
_LATER = {
    "mla": "item 5 (Mamba, MLA and MoE)",
    "moe": "item 5 (Mamba, MLA and MoE)",
    "mamba": "item 5 (Mamba, MLA and MoE)",
}
# each mixer's (init, forward, cache_init), called as
#   init(gen, cfg, dtype)
#   forward(p, cfg, spec, x, positions, cache, idx) -> (y, cache)
#   cache_init(cfg, spec, batch, max_seq, dtype, device)
# the recurrent mixers' states have no length, so they ignore max_seq
_MIXERS = {
    "attn": (
        Lyr.attn_init,
        lambda p, cfg, spec, x, pos, cache, idx: Lyr.attn_forward(p, cfg, spec, x, pos, cache=cache, idx=idx),
        Lyr.attn_cache_init,
    ),
    "mlstm": (
        Ssm.mlstm_init,
        lambda p, cfg, spec, x, pos, cache, idx: Ssm.mlstm_forward(p, cfg, x, cache=cache),
        lambda cfg, spec, batch, max_seq, dtype, device: Ssm.mlstm_cache_init(cfg, batch, dtype, device),
    ),
    "slstm": (
        Ssm.slstm_init,
        lambda p, cfg, spec, x, pos, cache, idx: Ssm.slstm_forward(p, cfg, x, cache=cache),
        lambda cfg, spec, batch, max_seq, dtype, device: Ssm.slstm_cache_init(cfg, batch, dtype, device),
    ),
}


# ----------------------------------------------------------------- segments
# Verbatim copy of repro/models/model.py: segmentize.
def segmentize(specs: tuple[LayerSpec, ...]) -> list[tuple[tuple[LayerSpec, ...], int]]:
    """Compress a layer-spec list into (pattern, repeats) segments."""
    out: list[tuple[tuple[LayerSpec, ...], int]] = []
    i, n = 0, len(specs)
    while i < n:
        best_p, best_r = 1, 1
        for p in range(1, min(8, n - i) + 1):
            pat = specs[i : i + p]
            r = 1
            while specs[i + r * p : i + (r + 1) * p] == pat:
                r += 1
            if r > 1 and p * r > best_p * best_r:
                best_p, best_r = p, r
        if best_r == 1:
            # literal run: absorb consecutive non-repeating layers
            j = i + 1
            out.append((specs[i:j], 1))
            i = j
        else:
            out.append((specs[i : i + best_p], best_r))
            i += best_p * best_r
    # merge adjacent literal singletons into one unrolled pattern
    merged: list[tuple[tuple[LayerSpec, ...], int]] = []
    for pat, r in out:
        if r == 1 and merged and merged[-1][1] == 1:
            merged[-1] = (merged[-1][0] + pat, 1)
        else:
            merged.append((pat, r))
    return merged


# ------------------------------------------------------------------- blocks
def _block_init(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec, dtype) -> nn.ModuleDict:
    for part in (spec.mixer, spec.ffn):
        if part in _LATER:
            raise NotImplementedError(
                f"{cfg.name}: {part!r} layers are not ported yet (ROADMAP queue 1, {_LATER[part]})"
            )
    p = nn.ModuleDict({
        "mix_norm": Lyr.norm_init(cfg, cfg.d_model, dtype, gen.device),
        "mix": _MIXERS[spec.mixer][0](gen, cfg, dtype),
    })
    if spec.ffn != "none":
        p["ffn_norm"] = Lyr.norm_init(cfg, cfg.d_model, dtype, gen.device)
        p["ffn"] = Lyr.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def _block_apply(p, cfg: ArchConfig, spec: LayerSpec, x: torch.Tensor, positions: torch.Tensor,
                 cache: dict | None = None, idx: int | None = None) -> torch.Tensor:
    h = Lyr.apply_norm(cfg, p["mix_norm"], x)
    y, _ = _MIXERS[spec.mixer][1](p["mix"], cfg, spec, h, positions, cache, idx)
    x = x + y
    if spec.ffn != "none":
        h = Lyr.apply_norm(cfg, p["ffn_norm"], x)
        x = x + Lyr.mlp_forward(p["ffn"], h, cfg.act)
    return x


@dataclass
class ModelOutput:
    logits: torch.Tensor | None
    cache: object
    aux_loss: torch.Tensor
    hidden: torch.Tensor | None = None


class Model(nn.Module):
    """Decoder with parameters made from ``seed`` on ``device``.

    Parameters mirror the JAX pytree: ``embed.w``, ``final_norm``, an
    optional untied ``head``, and ``layers[i]`` holding ``mix_norm``,
    ``mix`` (attention: q, k, v, o and optional qn / kn; mLSTM / sLSTM: the
    `ssm.ParamGroup` of `ssm.mlstm_init` / `ssm.slstm_init`) and, unless the
    spec has no FFN, ``ffn_norm`` and ``ffn`` (w1, w3, w2).
    """

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__()
        if cfg.mtp_depth:
            raise NotImplementedError(
                f"{cfg.name}: multi-token-prediction heads are not ported yet "
                f"(ROADMAP queue 1, {_LATER['mla']})"
            )
        self.cfg = cfg
        self.specs = cfg.layer_specs()
        self.segments = segmentize(self.specs)
        self.pdtype = getattr(torch, cfg.param_dtype)
        self.cdtype = getattr(torch, cfg.compute_dtype)
        gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
        self.embed = Lyr.embed_init(gen, cfg, self.pdtype)
        self.layers = nn.ModuleList(_block_init(gen, cfg, s, self.pdtype) for s in self.specs)
        self.final_norm = Lyr.norm_init(cfg, cfg.d_model, self.pdtype, gen.device)
        if not cfg.tie_embeddings:
            self.head = Lyr._dense_init(gen, cfg.d_model, cfg.vocab_size, self.pdtype)

    @property
    def device(self) -> torch.device:
        return self.embed["w"].device

    def init_cache(self, batch: int, max_seq: int, dtype=None) -> list[dict]:
        """One zeroed cache per layer, in layer order, on the model's device:
        K/V in ``dtype`` (default: the compute dtype) for attention; for the
        recurrent mixers their state (``max_seq`` unused), f32 but for the
        mLSTM's conv rows.  `forward` fills it in place."""
        dtype = dtype or self.cdtype
        return [_MIXERS[spec.mixer][2](self.cfg, spec, batch, max_seq, dtype, self.device) for spec in self.specs]

    def forward(
        self,
        tokens: torch.Tensor | None = None,
        *,
        embeds: torch.Tensor | None = None,
        positions: torch.Tensor | None = None,
        cache: list[dict] | None = None,
        idx: int | None = None,
        return_hidden: bool = False,
        compute_logits: bool = True,
    ) -> ModelOutput:
        """Logits of ``tokens`` (or ``embeds``) at positions ``idx, idx+1, ...``.

        With ``cache`` (from `init_cache`) the layers prefill it (S > 1) or
        decode one token against it (S == 1) in place, and the output
        carries the same cache object.
        """
        cfg = self.cfg
        if embeds is None:
            x = Lyr.embed(self.embed, cfg, tokens, self.cdtype)
        else:
            x = embeds.to(self.cdtype)
        B, S, _ = x.shape
        if positions is None:
            positions = (torch.arange(S, device=x.device) + (idx or 0))[None, :].expand(B, S)
            if cfg.mrope_sections is not None:
                positions = positions.expand(3, B, S)
        layer_caches = cache if cache is not None else [None] * len(self.layers)
        for spec, blk, c in zip(self.specs, self.layers, layer_caches):
            x = _block_apply(blk, cfg, spec, x, positions, c, idx)
        x = Lyr.apply_norm(cfg, self.final_norm, x)
        hidden = x if return_hidden else None
        logits = self.unembed(x) if compute_logits else None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return ModelOutput(logits, cache, aux, hidden)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return x @ self.embed["w"].to(x.dtype).T
        return Lyr.dense(self.head, x)
