"""Fused RMSNorm, a Triton kernel for Hopper.

Replaces the TPU kernel `repro/kernels/rmsnorm.py: fused_rmsnorm`:
y = x * rsqrt(mean(x^2) + eps) * w, or (1 + w) with ``gemma``, reduced in
f32 and cast back to ``x.dtype``.

Bound on this card: bytes.  Each row is read once and written once and the
arithmetic is a handful of operations per element, with nothing for the
tensor cores; one program per row loads the whole row as one masked block
(``BLOCK_D = next_power_of_2(D)``, so any D works), reduces it in registers
and stores it, which is one pass over device memory.  Triton's masked block
load and ``tl.sum`` express exactly that, so CUDA C++ would buy nothing.

Triton is imported inside the launching function: the module must import
where no Triton is installed.  Its plain version is
`repro_torch.kernels.ref.rmsnorm`, which a CPU tensor takes instead.
"""
from __future__ import annotations

import functools
import os

import torch

from . import _build, ref


@functools.cache
def _kernel():
    # keep Triton's compile cache inside the checkout's build directory
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, w_ptr, o_ptr, D, eps, BLOCK_D: tl.constexpr, GEMMA: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < D
        x = tl.load(x_ptr + row * D + cols, mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / D
        y = x * (1.0 / tl.sqrt(var + eps))
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        if GEMMA:
            w = 1.0 + w
        tl.store(o_ptr + row * D + cols, (y * w).to(o_ptr.dtype.element_ty), mask=mask)

    return triton, rmsnorm_kernel


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6, gemma: bool = False) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` (..., D) with weight ``w`` (D,)."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, w, eps=eps, gemma=gemma)
    if not x.is_cuda:
        raise ValueError(f"fused_rmsnorm runs on CUDA tensors, got {x.device}")
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"weight shape {tuple(w.shape)} does not match last dim {D}")
    if w.device != x.device:
        raise ValueError("x and w must lie on one device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_rmsnorm takes contiguous x and w only")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"fused_rmsnorm dtype {x.dtype}")
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    triton, kernel = _kernel()
    block = triton.next_power_of_2(D)
    kernel[(rows,)](
        x, w, out, D, float(eps), BLOCK_D=block, GEMMA=bool(gemma),
        num_warps=min(max(block // 256, 1), 16),
    )
    fused_rmsnorm.launches += 1
    return out


fused_rmsnorm.launches = 0
