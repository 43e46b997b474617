"""Hand-written Hopper kernels (+ plain PyTorch versions in ref.py, dispatch in ops.py).

Each kernel: a CUDA C++ source in ``csrc/`` with a Python wrapper of the same
name (built by `_build`), or a Triton kernel in its module; `ref` holds the
semantics of record; `ops` is what the models call.  Each wrapper counts its
launches in ``<wrapper>.launches``.
"""
from . import ops, ref
from .decode_attention import flash_decode
from .flash_attention import flash_attention
from .mlstm_chunk import chunked_mlstm
from .rmsnorm import fused_rmsnorm
from .ssm_scan import chunked_selective_scan

KERNELS = (fused_rmsnorm, flash_attention, flash_decode, chunked_mlstm, chunked_selective_scan)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "KERNELS", "chunked_mlstm", "chunked_selective_scan", "flash_attention", "flash_decode",
    "fused_rmsnorm", "ops", "ref", "reset_launch_counts",
]
