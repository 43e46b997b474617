"""Selective scan (the Mamba SSM core), a CUDA C++ kernel for Hopper.

Replaces the TPU kernel `repro/kernels/ssm_scan.py: chunked_selective_scan`:
a = exp(dt A), h = a h + (dt x) B and y = C . h along L, from h0, with the
(N, D) state in the JAX package's transposed (B, N, D) layout.  The kernel
is ``csrc/ssm_scan.cu`` (its header says how the channels are laid out and
what bounds it); this module checks the arguments, allocates y and h_last
and launches it on PyTorch's current stream.  Unlike the JAX package, which
takes its kernel only when L is a multiple of 128, every CUDA call launches
it, at any L >= 1.  Its plain version is
`repro_torch.kernels.ref.selective_scan`, which a CPU tensor takes instead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_STATE = 16


@functools.cache
def _lib():
    lib = _build.load("ssm_scan")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.selective_scan_fwd.argtypes = [p] * 8 + [i] * 6 + [ll] * 4 + [p]
    lib.selective_scan_fwd.restype = ctypes.c_int
    return lib


def chunked_selective_scan(
    x: torch.Tensor,   # (B, L, D) post-conv activations
    dt: torch.Tensor,  # (B, L, D) softplus'd step sizes
    A: torch.Tensor,   # (D, N) negative decay rates, f32
    Bm: torch.Tensor,  # (B, L, N)
    Cm: torch.Tensor,  # (B, L, N)
    h0: torch.Tensor | None = None,  # (B, N, D) f32, transposed state layout
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, L, D) in ``x.dtype``, h_last (B, N, D) f32).

    x and dt are contiguous; dt, Bm and Cm are f32 or x's type, all three
    the same; Bm and Cm may have any batch and time stride but a unit last
    stride (in Mamba they are column slices of one projection).  h0 is
    read, never written.
    """
    if x.device.type == "cpu":
        return ref.selective_scan(x, dt, A, Bm, Cm, h0)
    if not x.is_cuda:
        raise ValueError(f"chunked_selective_scan runs on CUDA tensors, got {x.device}")
    if x.ndim != 3 or A.ndim != 2:
        raise ValueError(f"chunked_selective_scan wants x (B, L, D) and A (D, N); got {x.shape}, {A.shape}")
    B, L, D = x.shape
    N = A.shape[1]
    if dt.shape != x.shape or A.shape[0] != D or Bm.shape != (B, L, N) or Cm.shape != (B, L, N):
        raise ValueError(f"chunked_selective_scan shape mismatch: x {x.shape}, dt {dt.shape}, A {A.shape}, "
                         f"B {Bm.shape}, C {Cm.shape}")
    if not 0 < N <= _MAX_STATE:
        raise ValueError(f"state size {N} outside 1..{_MAX_STATE}")
    if B == 0 or L == 0 or D == 0:
        raise ValueError(f"chunked_selective_scan got an empty input: {x.shape}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"chunked_selective_scan: x dtype {x.dtype}")
    if not dt.dtype == Bm.dtype == Cm.dtype or dt.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"chunked_selective_scan: dt, B, C must all be f32 or all {x.dtype}; "
                        f"got {dt.dtype}, {Bm.dtype}, {Cm.dtype}")
    if A.dtype != torch.float32:
        raise TypeError(f"chunked_selective_scan: A must be f32, got {A.dtype}")
    ins = (x, dt, A, Bm, Cm) + (() if h0 is None else (h0,))
    if not all(t.device == x.device for t in ins):
        raise ValueError("chunked_selective_scan: all inputs must lie on one device")
    if not (x.is_contiguous() and dt.is_contiguous()) or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("chunked_selective_scan: x and dt must be contiguous, B and C need a unit last stride")
    if h0 is not None and (h0.shape != (B, N, D) or h0.dtype != torch.float32 or not h0.is_contiguous()):
        raise ValueError(f"chunked_selective_scan: h0 must be a contiguous f32 (B, N, D) = {(B, N, D)}, "
                         f"got {tuple(h0.shape)} {h0.dtype}")
    A = A.contiguous()
    y = torch.empty((B, L, D), dtype=x.dtype, device=x.device)
    h_last = torch.empty((B, N, D), dtype=torch.float32, device=x.device)
    err = _lib().selective_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
        _DTYPES[x.dtype], int(dt.dtype != torch.float32), B, L, D, N,
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"selective_scan_fwd: CUDA error {err}")
    chunked_selective_scan.launches += 1
    return y, h_last


chunked_selective_scan.launches = 0
