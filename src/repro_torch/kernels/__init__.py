"""Hand-written Hopper kernels (+ plain PyTorch versions in ref.py, dispatch in ops.py).

Each kernel: a CUDA C++ source in ``csrc/`` with a Python wrapper of the same
name (built by `_build`), or a Triton kernel in its module; `ref` holds the
semantics of record; `ops` is what the models call.  Each wrapper counts its
launches in ``<wrapper>.launches``.
"""
from . import ops, ref
from .flash_attention import flash_attention
from .rmsnorm import fused_rmsnorm

KERNELS = (fused_rmsnorm, flash_attention)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "flash_attention", "fused_rmsnorm", "ops", "ref", "reset_launch_counts"]
