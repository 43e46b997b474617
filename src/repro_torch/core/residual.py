# Verbatim copy of repro/core/residual.py (the JAX package's original); only import paths may differ.
"""Residual-workload optimization: dummy generator (Theorem 2) + latency reassigner.

Paper Sec. III-C.  Both act on a module's allocation set produced by
Algorithm 1 and are accepted only if they strictly reduce the module cost.

* Dummy generator: Theorem 2 shows the cost-minimum schedule has leftover
  workload ``u_i < t_i`` for every configuration ``c_i``.  Padding the rate by
  ``dum_i = t_i - u_i`` lets the leftover ride one more machine of the
  higher-ratio configuration ``c_i`` — cheaper despite serving phantom load.
* Latency reassigner: the latency gap left by the splitter/scheduler is handed
  to the *residual* workload (the majority configuration cannot benefit,
  otherwise Algorithm 1 would have chosen differently), re-running Algorithm 1
  on the residual with the enlarged budget.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .dispatch import Alloc, Policy, module_wcl, total_cost
from .profiles import ModuleProfile
from .scheduler import generate_config

_EPS = 1e-9


@dataclass(frozen=True)
class ModuleSchedule:
    """Final per-module scheduling result."""

    module: str
    rate: float          # real request rate
    dummy: float         # extra phantom rate added by the dummy generator
    budget: float        # latency budget the schedule was derived under
    allocs: tuple[Alloc, ...]
    policy: Policy

    @property
    def cost(self) -> float:
        return total_cost(list(self.allocs))

    @property
    def wcl(self) -> float:
        return module_wcl(list(self.allocs), self.policy)


def leftover_workloads(allocs: list[Alloc]) -> list[float]:
    """u_i = total rate assigned to strictly lower-ratio allocations."""
    out = []
    for i, a in enumerate(allocs):
        u = sum(x.rate for x in allocs if x.config.ratio < a.config.ratio - _EPS)
        out.append(u)
    return out


def apply_dummy(
    T: float,
    L: float,
    profile: ModuleProfile,
    allocs: list[Alloc],
    policy: Policy,
    *,
    headroom: float = 0.0,
    burst: float = 0.0,
    vectorized: bool = True,
) -> tuple[float, list[Alloc]]:
    """Try Theorem-2 dummy padding; returns (dummy_rate, allocs) of the best result."""
    best_cost = total_cost(allocs)
    best = (0.0, allocs)
    for a, u in zip(allocs, leftover_workloads(allocs)):
        t_i = a.cap  # per-machine assigned capacity (headroom-derated)
        dum = t_i - u
        if dum <= _EPS or u <= _EPS:
            continue  # nothing below this config, or already saturated
        ok, cand = generate_config(
            T + dum, L, profile, policy, headroom=headroom, burst=burst,
            vectorized=vectorized,
        )
        if ok and total_cost(cand) < best_cost - 1e-12:
            best_cost = total_cost(cand)
            best = (dum, cand)
    return best


def apply_reassign(
    T: float,
    L: float,
    extra: float,
    profile: ModuleProfile,
    allocs: list[Alloc],
    policy: Policy,
    *,
    headroom: float = 0.0,
    burst: float = 0.0,
    vectorized: bool = True,
) -> tuple[list[Alloc], float]:
    """Re-run Algorithm 1 on the residual workload with budget ``L + extra``.

    Keeps the majority allocation (the leading full-capacity group) fixed.
    Returns (allocs, latency_used_beyond_L) of the best cost-reducing result,
    or the input unchanged.
    """
    if extra <= _EPS or len(allocs) < 2 or not allocs[0].full:
        return allocs, 0.0
    majority = allocs[0]
    residual_rate = T - majority.rate
    if residual_rate <= _EPS:
        return allocs, 0.0
    base_cost = total_cost(allocs)
    ok, cand = generate_config(
        residual_rate, L + extra, profile, policy, headroom=headroom, burst=burst,
        vectorized=vectorized,
    )
    if not ok:
        return allocs, 0.0
    new_allocs = [majority] + cand
    if total_cost(new_allocs) >= base_cost - 1e-12:
        return allocs, 0.0
    new_wcl = module_wcl(new_allocs, policy)
    overshoot = max(0.0, new_wcl - L)
    return new_allocs, overshoot


def schedule_module(
    module: str,
    T: float,
    L: float,
    profile: ModuleProfile,
    policy: Policy = Policy.TC,
    *,
    use_dummy: bool = True,
    k_tuples: int | None = None,
    headroom: float = 0.0,
    burst: float = 0.0,
    vectorized: bool = True,
) -> ModuleSchedule | None:
    """Algorithm 1 (+ optional dummy generator) for one module.

    ``headroom`` (utilization slack, multi-tuple scheduler only) provisions
    machines at ``(1 - headroom) * throughput``; the k-tuple baselines ignore
    it (they model prior systems' zero-slack provisioning).
    """
    from .scheduler import generate_config_ktuple  # local: avoid cycle

    if k_tuples is None:
        ok, allocs = generate_config(
            T, L, profile, policy, headroom=headroom, burst=burst,
            vectorized=vectorized,
        )
    else:
        ok, allocs = generate_config_ktuple(
            T, L, profile, policy, k_tuples, vectorized=vectorized
        )
    if not ok:
        return None
    dummy = 0.0
    if use_dummy and k_tuples is None:
        dummy, allocs = apply_dummy(
            T, L, profile, allocs, policy, headroom=headroom, burst=burst,
            vectorized=vectorized,
        )
    return ModuleSchedule(module, T, dummy, L, tuple(allocs), policy)
