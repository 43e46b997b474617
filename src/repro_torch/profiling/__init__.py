"""Analytic accounting and the H100 spec (the planner's profile source)."""
from .analytic import (
    arch_profile,
    flops_per_token,
    kv_cache_bytes_per_token,
    module_duration,
    param_count,
)
from .hardware import CATALOG, H100_SXM, TARGET, GPUSpec

__all__ = [
    "CATALOG", "GPUSpec", "H100_SXM", "TARGET", "arch_profile",
    "flops_per_token", "kv_cache_bytes_per_token", "module_duration",
    "param_count",
]
