"""Load a JAX parameter pytree, carried over as numpy arrays, into a `Model`.

The JAX model stacks each segment with repeats > 1 on a leading axis (it
initializes them under ``jax.vmap`` and runs them under ``lax.scan``); this
port keeps one module per layer, so the bridge unstacks them.  Every leaf of
the tree must land on a parameter of the same shape and every parameter
must be written: anything else raises.  A leaf is a dense weight or bias,
a norm scale, one of the recurrent mixers' raw arrays (the Mamba and mLSTM
``conv_w`` / ``conv_b``, Mamba's ``A_log`` and ``D``, the sLSTM's ``r``) or
an MoE layer's stacked expert weights (``w1``, ``w3`` (E, d, f), ``w2``
(E, f, d)), which a `layers.ParamGroup` keeps beside its dense sub-dicts.
Each leaf is cast to its parameter's dtype, so ``A_log`` and ``D`` stay f32
in a bf16 model, as in JAX.  Typical source:
``jax.tree.map(np.asarray, params)``.  `load_jax_cache` does the same for a
cache from the JAX model's ``init_cache`` or a cached forward.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from .model import Model


def _tensor(arr: Any) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: jax hands out read-only buffers
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _child(dst: nn.Module, key: str):
    if isinstance(dst, (nn.ModuleDict, nn.ParameterDict)):
        return dst[key] if key in dst else None
    return getattr(dst, key, None)


def _put(dst: nn.Module, src: Mapping[str, Any], path: str, written: set[int], take) -> None:
    for key, val in src.items():
        where = f"{path}/{key}"
        child = _child(dst, key)
        if child is None:
            raise KeyError(f"JAX parameter {where} has no counterpart in the torch model")
        if isinstance(val, Mapping):
            _put(child, val, where, written, take)
            continue
        param = child
        t = _tensor(take(val))
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"{where}: JAX shape {tuple(t.shape)} != torch shape {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(t.to(param.dtype))
        written.add(id(param))


def load_jax_params(model: Model, tree: Mapping[str, Any]) -> Model:
    """Copy ``tree`` into ``model``'s parameters in place; returns ``model``."""
    extra = set(tree) - {"embed", "segments", "final_norm", "head"}
    if extra:
        raise KeyError(f"JAX parameters {sorted(extra)} have no counterpart in the torch model")
    written: set[int] = set()
    whole = lambda a: a  # noqa: E731
    _put(model, {k: tree[k] for k in ("embed", "final_norm", "head") if k in tree}, "", written, whole)
    segments = tree["segments"]
    if len(segments) != len(model.segments):
        raise ValueError(f"{len(segments)} JAX segments, torch model has {len(model.segments)}")
    layer = 0
    for si, (pattern, repeats) in enumerate(model.segments):
        seg = segments[si]
        if len(seg) != len(pattern):
            raise ValueError(f"segment {si}: {len(seg)} blocks, pattern has {len(pattern)}")
        for r in range(repeats):
            take = whole if repeats == 1 else (lambda a, r=r: np.asarray(a)[r])
            for j in range(len(pattern)):
                _put(model.layers[layer], seg[j], f"/segments/{si}/{j}[{r}]", written, take)
                layer += 1
    missing = [n for n, p in model.named_parameters() if id(p) not in written]
    if missing:
        raise KeyError(f"torch parameters not in the JAX tree: {missing}")
    return model


def load_jax_cache(model: Model, jax_cache: Any) -> list[dict]:
    """The JAX model's cache (a list of segments, each a tuple of per-layer
    dicts, stacked on a leading axis where the segment repeats) as the port's
    per-layer list of dicts of tensors on the model's device.  Each layer
    keeps its own state names and dtypes: ``k``, ``v`` for attention;
    ``conv``, ``h`` (B, N, D) for Mamba; ``conv``, ``C``, ``n``, ``m`` for
    mLSTM; ``c``, ``n``, ``h``, ``m`` for sLSTM."""
    if len(jax_cache) != len(model.segments):
        raise ValueError(f"{len(jax_cache)} JAX cache segments, torch model has {len(model.segments)}")
    out: list[dict] = []
    for si, (pattern, repeats) in enumerate(model.segments):
        seg = jax_cache[si]
        if len(seg) != len(pattern):
            raise ValueError(f"cache segment {si}: {len(seg)} layers, pattern has {len(pattern)}")
        for r in range(repeats):
            take = (lambda a: a) if repeats == 1 else (lambda a, r=r: np.asarray(a)[r])
            for j in range(len(pattern)):
                out.append({name: _tensor(take(arr)).to(model.device) for name, arr in seg[j].items()})
    return out
