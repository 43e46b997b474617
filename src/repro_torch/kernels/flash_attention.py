"""Flash-attention forward (prefill), a CUDA C++ kernel for Hopper.

Replaces the TPU kernel `repro/kernels/flash_attention.py: flash_attention`:
causal / windowed GQA with a blocked online softmax in f32.  The kernel is
``csrc/flash_attention.cu`` (its header says how it is laid out and what
bounds it); this module checks the arguments, allocates the output and
launches it on PyTorch's current stream.  Its plain version is
`repro_torch.kernels.ref.attention`, which a CPU tensor takes instead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_DIM = 256


@functools.cache
def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, Dk)
    k: torch.Tensor,  # (B, Sk, Hkv, Dk)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Returns (B, Sq, Hq, Dv) in ``q.dtype``."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window, scale=scale)
    if not q.is_cuda:
        raise ValueError(f"flash_attention runs on CUDA tensors, got {q.device}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention wants 4-d q, k, v; got {q.shape}, {k.shape}, {v.shape}")
    B, Sq, Hq, Dk = q.shape
    _, Sk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    if k.shape != (B, Sk, Hkv, Dk) or v.shape[:3] != (B, Sk, Hkv):
        raise ValueError(f"flash_attention shape mismatch: {q.shape}, {k.shape}, {v.shape}")
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} are not a multiple of KV heads {Hkv}")
    if not (0 < Dk <= _MAX_HEAD_DIM and 0 < Dv <= _MAX_HEAD_DIM):
        raise ValueError(f"head dims {Dk}, {Dv} outside 1..{_MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v only")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError(f"flash_attention got an empty input: {q.shape}, {k.shape}")
    scale = scale if scale is not None else Dk ** -0.5
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        B, Sq, Sk, Hq, Hkv, Dk, Dv, float(scale), int(causal),
        -1 if window is None else int(window), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
