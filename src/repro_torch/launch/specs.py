"""Serving step functions: prefill and decode.

Counterpart of `repro.launch.specs` (``make_prefill_fn``, ``make_decode_fn``)
for the port.  The model owns its parameters, so the steps take only the
batch.  The train step and the shape-only input specs of the dry-run come
with the training slice.

* prefill: forward S tokens into a fresh cache, emit the last position's
  logits and the filled cache;
* decode: one token per sequence against the cache at fill level ``idx``,
  which it updates in place.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

from ..configs.base import InputShape
from ..models import Model


def make_prefill_fn(model: Model, shape: InputShape) -> Callable[[Mapping[str, Any]], tuple]:
    B, S = shape.global_batch, shape.seq_len

    def prefill_step(batch: Mapping[str, Any]) -> tuple[torch.Tensor, list[dict]]:
        cache = model.init_cache(B, S)
        out = model(
            batch.get("tokens"),
            embeds=batch.get("embeds"),
            cache=cache,
            idx=0,
            compute_logits=False,
            return_hidden=True,
        )
        # serving needs only the last position's logits: unembedding all S
        # positions would cost a V x d matmul per token and a large logits tensor
        logits = model.unembed(out.hidden[:, -1:])
        return logits[:, 0], out.cache

    return prefill_step


def make_decode_fn(model: Model) -> Callable[[Mapping[str, Any]], tuple]:
    def decode_step(batch: Mapping[str, Any]) -> tuple[torch.Tensor, list[dict]]:
        out = model(batch["tokens"], cache=batch["cache"], idx=batch["idx"])
        return out.logits[:, 0], out.cache

    return decode_step
