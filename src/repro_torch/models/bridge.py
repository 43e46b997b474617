"""Load a JAX parameter pytree, carried over as numpy arrays, into a `Model`.

The JAX model stacks each segment with repeats > 1 on a leading axis (it
initializes them under ``jax.vmap`` and runs them under ``lax.scan``); this
port keeps one module per layer, so the bridge unstacks them.  Every leaf of
the tree must land on a parameter of the same shape and every parameter
must be written: anything else raises.  Typical source:
``jax.tree.map(np.asarray, params)``.
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
