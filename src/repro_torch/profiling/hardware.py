"""GPU hardware spec the analytic profiler and the planner read.

`GPUSpec` carries the fields of `repro.profiling.hardware.TPUSpec`, so
`analytic.module_duration` reads it unchanged: ``peak_flops_bf16`` is the
dense bf16 tensor-core rate, ``hbm_bw`` the device-memory rate, ``ici_bw``
the NVLink rate each way to the other cards of the host.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GPUSpec:
    name: str
    peak_flops_bf16: float  # FLOP/s per card, dense
    hbm_bw: float  # bytes/s per card
    hbm_bytes: float
    ici_bw: float  # bytes/s per link direction (NVLink)
    unit_price: float  # relative $ / card-hour


# NVIDIA H100 SXM data sheet, at its 700 W power limit: 989 TFLOP/s bf16
# dense, 80 GB HBM3 at 3.35 TB/s, NVLink 900 GB/s all to all (450 GB/s each
# way).  A card capped below 700 W runs slower under load.
H100_SXM = GPUSpec("h100-sxm", 989e12, 3.35e12, 80e9, 450e9, 1.0)

CATALOG: dict[str, GPUSpec] = {H100_SXM.name: H100_SXM}

# the profiling / roofline target (single card numbers)
TARGET = H100_SXM
