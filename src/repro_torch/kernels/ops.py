"""Model-facing ops: the kernel for CUDA tensors, the plain version for CPU.

Counterpart of `repro.kernels.ops` for one device.  On CUDA every call
launches the hand-written kernel, at any shape: unlike the JAX package, which
takes its TPU kernels only on 128-aligned shapes, there is no alignment
fallback and no switch.  On CPU the kernel wrappers themselves run the plain
versions of `ref`.
"""
from __future__ import annotations

import torch

from .decode_attention import flash_decode
from .flash_attention import flash_attention
from .mlstm_chunk import chunked_mlstm
from .rmsnorm import fused_rmsnorm


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6, gemma: bool = False) -> torch.Tensor:
    return fused_rmsnorm(x, w, eps=eps, gemma=gemma)


def attention(q, k, v, *, causal: bool = True, window: int | None = None, scale: float | None = None):
    return flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def decode_attention(q, k_cache, v_cache, lengths, *, window: int | None = None, scale: float | None = None):
    return flash_decode(q, k_cache, v_cache, lengths, window=window, scale=scale)


def mlstm(q, k, v, i_gate, f_gate, *, chunk: int = 128):
    return chunked_mlstm(q, k, v, i_gate, f_gate, chunk=chunk)


def row_parallel_dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w: on one device the Megatron row-parallel projection is a matmul."""
    return x @ w.to(x.dtype)
