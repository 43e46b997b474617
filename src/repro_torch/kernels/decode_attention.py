"""Flash-decode (one query token per sequence against a KV cache), a CUDA C++
kernel for Hopper.

Replaces the TPU kernel `repro/kernels/decode_attention.py: flash_decode`:
the g = Hq / Hkv grouped queries of a KV head share one pass over the cache,
per-sequence ``lengths`` mask the tail, an optional window masks the head,
and the softmax runs online in f32.  The kernel is ``csrc/flash_decode.cu``
(its header says how it is laid out and what bounds it); this module checks
the arguments, allocates the output and the split workspace from PyTorch's
caching allocator and launches both passes on PyTorch's current stream.
``lengths`` is never read on the host, so a call can be captured in a CUDA
graph.  Its plain version is `repro_torch.kernels.ref.decode_attention`,
which a CPU tensor takes instead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_DIM = 576  # MLA's absorbed decode: Dk 512 + 64, Dv 512


@functools.cache
def _lib():
    lib = _build.load("flash_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, i, p]
    lib.flash_decode_fwd.restype = ctypes.c_int
    lib.flash_decode_workspace.argtypes = [i] * 8
    lib.flash_decode_workspace.restype = ctypes.c_longlong
    return lib


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def _workspace_floats(*shape: int) -> int:
    n = _lib().flash_decode_workspace(*shape)
    if n < 0:
        raise ValueError(f"flash_decode does not take (dtype, B, S, Hq, Hkv, Dk, Dv, SMs) = {shape}")
    return n


def flash_decode(
    q: torch.Tensor,        # (B, Hq, Dk)
    k_cache: torch.Tensor,  # (B, S, Hkv, Dk)
    v_cache: torch.Tensor,  # (B, S, Hkv, Dv)
    lengths: torch.Tensor,  # (B,) int32: live cache entries, this token included
    *,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Returns (B, Hq, Dv) in ``q.dtype``."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, lengths, window=window, scale=scale)
    if not q.is_cuda:
        raise ValueError(f"flash_decode runs on CUDA tensors, got {q.device}")
    if q.ndim != 3 or k_cache.ndim != 4 or v_cache.ndim != 4:
        raise ValueError(f"flash_decode wants q (B, Hq, Dk) and 4-d caches; got "
                         f"{q.shape}, {k_cache.shape}, {v_cache.shape}")
    B, Hq, Dk = q.shape
    _, S, Hkv, _ = k_cache.shape
    Dv = v_cache.shape[-1]
    if k_cache.shape != (B, S, Hkv, Dk) or v_cache.shape[:3] != (B, S, Hkv) or lengths.shape != (B,):
        raise ValueError(f"flash_decode shape mismatch: {q.shape}, {k_cache.shape}, "
                         f"{v_cache.shape}, lengths {lengths.shape}")
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} are not a multiple of KV heads {Hkv}")
    if not (0 < Dk <= _MAX_HEAD_DIM and 0 < Dv <= _MAX_HEAD_DIM):
        raise ValueError(f"head dims {Dk}, {Dv} outside 1..{_MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"flash_decode dtypes {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"flash_decode lengths must be int32, got {lengths.dtype}")
    if not all(t.device == q.device for t in (k_cache, v_cache, lengths)):
        raise ValueError("q, the caches and lengths must lie on one device")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, lengths)):
        raise ValueError("flash_decode takes contiguous q, caches and lengths only")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if B == 0 or S == 0:
        raise ValueError(f"flash_decode got an empty input: {q.shape}, {k_cache.shape}")
    scale = scale if scale is not None else Dk ** -0.5
    shape = (_DTYPES[q.dtype], B, S, Hq, Hkv, Dk, Dv, _sm_count(q.device))
    ws = torch.empty((_workspace_floats(*shape),), dtype=torch.float32, device=q.device)
    out = torch.empty((B, Hq, Dv), dtype=q.dtype, device=q.device)
    err = _lib().flash_decode_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        ws.data_ptr(), *shape[:7], float(scale), -1 if window is None else int(window), shape[7],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_decode_fwd: CUDA error {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
