"""Chunkwise mLSTM (the xLSTM matrix-memory cell), a CUDA C++ kernel for Hopper.

Replaces the TPU kernel `repro/kernels/mlstm_chunk.py: chunked_mlstm`:
stabilized exponential-gated attention within each chunk, with the (D, D)
matrix memory, the (D,) normalizer and the scalar stabilizer carried across
chunks.  The kernel is ``csrc/mlstm_chunk.cu`` (its header says how the
state is split over blocks and what bounds it); this module checks the
arguments, allocates the output and launches it on PyTorch's current
stream.  Unlike the JAX package, which takes its kernel only when L is a
multiple of 128, every CUDA call launches it, at any L >= 1.  Its plain
version is `repro_torch.kernels.ref.mlstm_chunked`, which a CPU tensor
takes instead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_DIM = 512


@functools.cache
def _lib():
    lib = _build.load("mlstm_chunk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mlstm_chunk_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    lib.mlstm_chunk_fwd.restype = ctypes.c_int
    return lib


def chunked_mlstm(
    q: torch.Tensor,       # (B, L, H, D)
    k: torch.Tensor,       # (B, L, H, D)
    v: torch.Tensor,       # (B, L, H, D)
    i_gate: torch.Tensor,  # (B, L, H) log input gate
    f_gate: torch.Tensor,  # (B, L, H) log forget gate (log-sigmoid applied)
    *,
    chunk: int = 128,
) -> torch.Tensor:
    """Returns (B, L, H, D) in ``q.dtype``.

    ``chunk`` is not read, as in the plain version: the kernel walks chunks
    of 64 rows (its shared-memory tile), and the chunking changes only the
    rounding, not the function.  The gates are read as contiguous f32
    (converted here when they are not).
    """
    if q.device.type == "cpu":
        return ref.mlstm_chunked(q, k, v, i_gate, f_gate, chunk=chunk)
    if not q.is_cuda:
        raise ValueError(f"chunked_mlstm runs on CUDA tensors, got {q.device}")
    if q.ndim != 4:
        raise ValueError(f"chunked_mlstm wants q, k, v (B, L, H, D); got {q.shape}")
    B, L, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape or i_gate.shape != (B, L, H) or f_gate.shape != (B, L, H):
        raise ValueError(f"chunked_mlstm shape mismatch: {q.shape}, {k.shape}, {v.shape}, "
                         f"gates {i_gate.shape}, {f_gate.shape}")
    if not 0 < D <= _MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside 1..{_MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"chunked_mlstm dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.device == q.device for t in (k, v, i_gate, f_gate)):
        raise ValueError("q, k, v and the gates must lie on one device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("chunked_mlstm takes contiguous q, k and v only")
    if B == 0 or L == 0 or H == 0:
        raise ValueError(f"chunked_mlstm got an empty input: {q.shape}")
    li = i_gate.float().contiguous()
    lf = f_gate.float().contiguous()
    out = torch.empty_like(q)
    err = _lib().mlstm_chunk_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(), lf.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, L, H, D, float(D ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mlstm_chunk_fwd: CUDA error {err}")
    chunked_mlstm.launches += 1
    return out


chunked_mlstm.launches = 0
