# Verbatim copy of repro/core/profiles.py (the JAX package's original); only import paths may differ.
"""Module profiles: the (batch, duration, hardware) -> throughput/cost tables Harpagon plans over.

A *configuration* is one row of a module's offline profile: running the module at
batch size ``b`` on hardware ``hw`` takes ``d`` seconds per batch, i.e. throughput
``t = b / d`` req/s at unit price ``p`` $/machine.  The *throughput-cost ratio*
``r = t / p`` is the paper's ranking key: covering a request rate ``f`` with a
configuration costs ``p * f / t = f / r`` machines-worth of money (frame-rate
proportionality, paper Sec. III-A), so higher ``r`` is strictly cheaper.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class Hardware:
    """A hardware type in the heterogeneous pool (paper: P100/V100; here: TPU tiers)."""

    name: str
    unit_price: float  # $ per machine per unit time (relative)


# TPU catalog used by the analytic profiler (price ratios ~ GCP on-demand).
TPU_V5E = Hardware("tpu-v5e", 1.0)
TPU_V4 = Hardware("tpu-v4", 1.35)
TPU_V5P = Hardware("tpu-v5p", 1.75)
HARDWARE_CATALOG = (TPU_V5E, TPU_V4, TPU_V5P)


@dataclass(frozen=True)
class Config:
    """One profiled configuration of a module."""

    batch: int
    duration: float  # seconds per batch at this batch size
    hardware: str = "default"
    unit_price: float = 1.0

    @property
    def throughput(self) -> float:
        return self.batch / self.duration

    @property
    def ratio(self) -> float:
        """Throughput-cost ratio r = t / p."""
        return self.throughput / self.unit_price

    def __repr__(self) -> str:  # compact: (b=8@tpu-v5e t=32.0)
        return f"(b={self.batch}@{self.hardware} t={self.throughput:.4g})"


@dataclass(frozen=True)
class ModuleProfile:
    """All candidate configurations for one DNN module, sorted by ratio desc."""

    name: str
    configs: tuple[Config, ...]

    def __post_init__(self):
        ordered = tuple(sorted(self.configs, key=lambda c: -c.ratio))
        object.__setattr__(self, "configs", ordered)

    def restrict(
        self,
        *,
        max_batch: int | None = None,
        hardware: Sequence[str] | None = None,
    ) -> "ModuleProfile":
        """Filtered copy (used by ablations Harp-nb / Harp-nhc / Harp-nhe).

        Unfiltered calls return ``self``: the planner restricts profiles on
        every `plan()`, and a stable ``configs`` tuple identity keeps the
        batched-WCL array caches (keyed by that identity) hot across calls.
        """
        if max_batch is None and hardware is None:
            return self
        cfgs = [
            c
            for c in self.configs
            if (max_batch is None or c.batch <= max_batch)
            and (hardware is None or c.hardware in hardware)
        ]
        return dataclasses.replace(self, configs=tuple(cfgs))

    @property
    def hardware_names(self) -> tuple[str, ...]:
        return tuple(sorted({c.hardware for c in self.configs}))

    def cheapest_hardware(self) -> str:
        return min(self.configs, key=lambda c: c.unit_price).hardware

    def most_expensive_hardware(self) -> str:
        return max(self.configs, key=lambda c: c.unit_price).hardware

    def least_efficient(self) -> Config:
        """Starting point of Algorithm 2: the minimum throughput-cost-ratio config."""
        return self.configs[-1]


def _mk(name: str, rows: Sequence[tuple[int, float]]) -> ModuleProfile:
    return ModuleProfile(name, tuple(Config(b, d) for b, d in rows))


# Paper Table I (homogeneous hardware, unit price 1.0). Used verbatim in tests.
TABLE1_M1 = _mk("M1", [(2, 0.160), (4, 0.200), (8, 0.320)])
TABLE1_M2 = _mk("M2", [(2, 0.125), (4, 0.160), (8, 0.250)])
TABLE1_M3 = _mk("M3", [(2, 0.100), (8, 0.250), (32, 0.800)])

# Paper Sec. III-B worked example: module M4 (A/B at b=6 d=2.0, C at b=2 d=1.0).
TABLE_M4 = _mk("M4", [(6, 2.0), (2, 1.0)])

TABLE1 = {"M1": TABLE1_M1, "M2": TABLE1_M2, "M3": TABLE1_M3}
