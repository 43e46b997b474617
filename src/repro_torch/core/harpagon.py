# Copy of repro/core/harpagon.py (the JAX package's original); only import paths and one comment's
# reference to the original's change history differ.
"""The Harpagon planner: dispatch model ∘ latency splitting ∘ module scheduling.

``Planner`` composes the three levels of the paper (Fig. 3):

1. pick the dispatch policy (which fixes every L_wc estimate),
2. split the end-to-end SLO into per-module budgets (Sec. III-D),
3. schedule each module with Algorithm 1 + residual optimizers (Sec. III-C),
4. reassign leftover end-to-end latency to residual workloads (Sec. III-C).

Every baseline system and every Harp-* ablation of the paper is an options
preset over the same composition (see `repro.core.baselines`).
"""
from __future__ import annotations

import math
import time
from contextlib import nullcontext
from dataclasses import dataclass, field, replace
from typing import Mapping

from .dag import Workload
from .dispatch import Policy, collect_capacity, wcl_memo
from .profiles import Config, ModuleProfile
from .residual import ModuleSchedule, apply_reassign, schedule_module
from . import splitter as sp

_EPS = 1e-9


@dataclass(frozen=True)
class PlannerOptions:
    name: str = "harpagon"
    policy: Policy = Policy.TC
    k_tuples: int | None = None          # None = multi-tuple (Algorithm 1)
    split: str = "lc"                    # lc | throughput | even | quantized | dp
    quantize: float = 0.01               # interval for split="quantized"
    node_merge: bool = True
    cost_direct: bool = True
    use_dummy: bool = True
    reassign: int = 10 ** 6              # max reassigner iterations (0 / 1 / many)
    hardware: str | None = None          # None=all, "cheapest", "most_expensive"
    max_batch: int | None = None         # 1 => batching disabled (Harp-nb)
    headroom: float = 0.0                # provision machines at t*(1-headroom):
    #   slack absorbs timeout-flushed partial batches (multi-tuple scheduler
    #   only; 0.0 = paper's zero-slack pacing).  Costs ~1/(1-headroom) more.
    burst_aware: bool = False            # burst-aware tail WCL correction:
    #   downstream of a batched stage, arrivals come quantized in upstream
    #   batch completions, so a fractional tail machine's realized collection
    #   can straddle one upstream batch-arrival quantum b_up / rate_up beyond
    #   its steady-state Theorem-1 fill time.  When on,
    #   tail feasibility is checked at d + b/w + burst, so the scheduler
    #   places tails that hold their budget under batched hand-off.  Off =
    #   paper semantics (golden equivalence).
    vectorized: bool = True              # batched numpy WCL cascade: Algorithm
    #   1's config walk, the dummy generator and the whole splitter evaluate
    #   candidate (config, remaining-workload) tuples as arrays in one
    #   `config_wcl_batch` call instead of memoized scalar `config_wcl`
    #   cascades.  Plans are bit-identical either way; False selects the
    #   scalar reference path (the bit-exactness oracle), which runs under
    #   `dispatch.wcl_memo`.


@dataclass(frozen=True)
class Plan:
    workload: Workload
    options: PlannerOptions
    schedules: Mapping[str, ModuleSchedule]
    feasible: bool
    runtime_s: float
    # -- control-plane identity: plans are live, versioned objects ----------
    version: int = 0                     # bumped by Planner.replan
    provenance: Mapping[str, str] = field(default_factory=dict)
    #   per-module replan action: "reused" | "repaired" | "cached" | "cold"
    #   (empty for a cold plan() — every module was solved from scratch)

    @property
    def cost(self) -> float:
        if not self.feasible:
            return math.inf
        return sum(s.cost for s in self.schedules.values())

    @property
    def e2e_latency(self) -> float:
        if not self.feasible:
            return math.inf
        return self.workload.app.latency({m: s.wcl for m, s in self.schedules.items()})

    def summary(self) -> str:
        hr = f" headroom={self.options.headroom:g}" if self.options.headroom else ""
        lines = [
            f"plan[{self.options.name}] v{self.version} app={self.workload.app.name}"
            f" slo={self.workload.slo}"
            f" feasible={self.feasible} cost={self.cost:.4g} e2e={self.e2e_latency:.4g}"
            f"{hr} runtime={self.runtime_s * 1e3:.2f}ms"
        ]
        for m, s in self.schedules.items():
            prov = self.provenance.get(m)
            tag = f" [{prov}]" if prov else ""
            lines.append(
                f"  {m}:{tag} rate={s.rate:.4g} dummy={s.dummy:.4g} "
                f"budget={s.budget:.4g} wcl={s.wcl:.4g} cost={s.cost:.4g}"
            )
            # epoch-by-epoch plan logs must be auditable: every alloc line
            # carries its dummy rate and headroom derate explicitly, zero or not
            for a in s.allocs:
                lines.append(
                    f"    {a.machines:.4g}x b{a.config.batch}@{a.config.hardware}"
                    f" rate={a.rate:.4g} dummy={a.dummy:.4g} derate={a.derate:.4g}"
                )
        return "\n".join(lines)

    def diff(self, other: "Plan") -> "PlanDelta":
        """Module-by-module delta from ``self`` to ``other`` (see PlanDelta)."""
        return diff_plans(self, other)


def _machines_by_config(s: ModuleSchedule) -> dict[Config, float]:
    out: dict[Config, float] = {}
    for a in s.allocs:
        out[a.config] = out.get(a.config, 0.0) + a.machines
    return out


@dataclass(frozen=True)
class ModuleDelta:
    """One module's change between two plan versions.

    ``added`` / ``drained`` are machine-count changes per configuration
    (fractional tails included), ``dummy_*`` the provisioned phantom rate
    ``sum(a.dummy)`` the frontend streams, and ``action`` how the replan
    resolved the module ("reused" | "repaired" | "cached" | "cold").
    """

    module: str
    rate_before: float
    rate_after: float
    added: tuple[tuple[Config, float], ...]
    drained: tuple[tuple[Config, float], ...]
    dummy_before: float
    dummy_after: float
    action: str = "cold"

    @property
    def changed(self) -> bool:
        return bool(self.added or self.drained) or (
            abs(self.dummy_after - self.dummy_before) > 1e-9
        )

    @property
    def machines_added(self) -> float:
        return sum(n for _, n in self.added)

    @property
    def machines_drained(self) -> float:
        return sum(n for _, n in self.drained)


@dataclass(frozen=True)
class PlanDelta:
    """The diff between two plan versions: what the serving layer must apply.

    A hot-swap is exactly this object realized against live stages: drained
    machines finish their open batch and retire, added machines join the
    dispatch walk, and dummy streamers re-anchor to the new provisioned rate.
    """

    version_from: int
    version_to: int
    cost_before: float
    cost_after: float
    modules: Mapping[str, ModuleDelta]

    @property
    def changed_modules(self) -> tuple[str, ...]:
        return tuple(m for m, d in self.modules.items() if d.changed)

    @property
    def empty(self) -> bool:
        return not self.changed_modules

    def summary(self) -> str:
        head = (
            f"delta v{self.version_from}->v{self.version_to}"
            f" cost {self.cost_before:.4g}->{self.cost_after:.4g}"
        )
        lines = [head]
        for m, d in self.modules.items():
            if not d.changed:
                continue
            add = "+".join(f"{n:.3g}x b{c.batch}@{c.hardware}" for c, n in d.added)
            drain = "+".join(f"{n:.3g}x b{c.batch}@{c.hardware}" for c, n in d.drained)
            lines.append(
                f"  {m}[{d.action}]: rate {d.rate_before:.4g}->{d.rate_after:.4g}"
                f" add[{add}] drain[{drain}]"
                f" dummy {d.dummy_before:.4g}->{d.dummy_after:.4g}"
            )
        return "\n".join(lines)


def diff_plans(prev: Plan, new: Plan) -> PlanDelta:
    """Per-module machine/config/dummy diff between two plans of one app."""
    if prev.workload.app.name != new.workload.app.name:
        raise ValueError("can only diff plans of the same application")
    modules: dict[str, ModuleDelta] = {}
    for m in new.workload.app.modules:
        s0, s1 = prev.schedules.get(m), new.schedules.get(m)
        by0 = _machines_by_config(s0) if s0 else {}
        by1 = _machines_by_config(s1) if s1 else {}
        added, drained = [], []
        for c in {**by0, **by1}:
            d = by1.get(c, 0.0) - by0.get(c, 0.0)
            if d > 1e-9:
                added.append((c, d))
            elif d < -1e-9:
                drained.append((c, -d))
        modules[m] = ModuleDelta(
            module=m,
            rate_before=s0.rate if s0 else 0.0,
            rate_after=s1.rate if s1 else 0.0,
            added=tuple(added),
            drained=tuple(drained),
            dummy_before=sum(a.dummy for a in s0.allocs) if s0 else 0.0,
            dummy_after=sum(a.dummy for a in s1.allocs) if s1 else 0.0,
            action=new.provenance.get(m, "cold"),
        )
    return PlanDelta(
        version_from=prev.version,
        version_to=new.version,
        cost_before=prev.cost,
        cost_after=new.cost,
        modules=modules,
    )


_INFEASIBLE = object()


class Planner:
    def __init__(self, options: PlannerOptions | None = None, *, cache_size: int = 128):
        self.options = options or PlannerOptions()
        # replan memo: quantized-rate-vector -> guard-cleared Plan.  A control
        # loop walking a diurnal cycle revisits rate buckets (the falling
        # phase mirrors the rising one; periods repeat), so hot-swap replans
        # amortize to a dict lookup in steady state.
        self._replan_cache: dict[tuple, Plan] = {}
        self._cache_size = cache_size

    def _cache_key(
        self,
        wl: Workload,
        tolerance: float,
        profiles: "Mapping[str, ModuleProfile] | None" = None,
    ) -> tuple:
        # the tolerance is part of the key: the same bucket integer under a
        # different quantization step maps to a completely different rate
        q = math.log1p(max(tolerance, 1e-6))
        # so is a cheap profile fingerprint: a control loop correcting
        # profiles toward measured durations must not replay plans memoized
        # under the uncorrected (or differently corrected) durations
        fp = ()
        if profiles is not None:
            fp = tuple(
                (m, len(p.configs), round(sum(c.duration for c in p.configs), 12))
                for m, p in sorted(profiles.items())
            )
        return (
            wl.app.name,
            round(wl.slo, 9),
            round(q, 12),
            tuple(
                int(round(math.log(max(float(wl.rates[m]), 1e-12)) / q))
                for m in wl.app.modules
            ),
            fp,
        )

    # -- profile preparation -------------------------------------------------
    def _profiles(
        self, profiles: Mapping[str, ModuleProfile]
    ) -> Mapping[str, ModuleProfile] | None:
        o = self.options
        out = {}
        for m, p in profiles.items():
            hw = None
            if o.hardware == "cheapest":
                hw = [p.cheapest_hardware()]
            elif o.hardware == "most_expensive":
                hw = [p.most_expensive_hardware()]
            p = p.restrict(max_batch=o.max_batch, hardware=hw)
            if not p.configs:
                return None
            out[m] = p
        return out

    # -- splitting ------------------------------------------------------------
    def _split_with(
        self, wl: Workload, profiles: Mapping[str, ModuleProfile], split: str
    ) -> dict[str, float] | None:
        o = self.options
        if split in ("lc", "lc_int"):
            return sp.split_lc(
                wl,
                profiles,
                o.policy,
                node_merge=o.node_merge,
                cost_direct=o.cost_direct,
                integer_tails=split == "lc_int",
                vectorized=o.vectorized,
            )
        if split == "throughput":
            return sp.split_throughput(
                wl, profiles, o.policy, vectorized=o.vectorized
            )
        if split in ("even", "even_int"):
            return sp.split_even(
                wl, profiles, o.policy, integer_tails=split == "even_int",
                vectorized=o.vectorized,
            )
        if split == "quantized":
            return sp.split_quantized(
                wl, profiles, o.policy, q=o.quantize, vectorized=o.vectorized
            )
        if split == "dp":
            return sp.split_dp(
                wl, profiles, o.policy,
                use_dummy=o.use_dummy and o.k_tuples is None,
            )
        raise ValueError(f"unknown splitter {split}")

    # -- full pipeline ---------------------------------------------------------
    def plan(self, wl: Workload, profiles: Mapping[str, ModuleProfile]) -> Plan:
        """Split -> schedule -> residual-optimize.

        Per the paper (Fig. 3) the module scheduler and latency splitter
        iterate: when the LC split's fractionally-tight budgets turn out to
        be integer-unschedulable, Harpagon retries with progressively looser
        splitting strategies and keeps the cheapest feasible plan.  On the
        default ``vectorized`` path every tier evaluates its candidate
        (config, remaining-workload) tuples with the batched WCL kernel
        (`dispatch.config_wcl_batch`); the scalar oracle path
        (``vectorized=False``) instead runs the whole cascade under one
        `dispatch.wcl_memo` scope, which collapses its repeated scalar
        ``(config, rate, burst)`` WCL tuples to dict hits — the
        "millisecond-level planning" claim is tracked (and smoke-gated) by
        the ``planner_speed`` benchmark row.
        """
        t0 = time.perf_counter()
        o = self.options
        best: Plan | None = None
        restricted = self._profiles(profiles)
        if restricted is None:
            return Plan(wl, o, {}, False, time.perf_counter() - t0)
        cascade = [o.split]
        if o.split == "lc":
            # schedule-aware refinement (paper Fig. 3's scheduler<->splitter
            # iteration): looser heuristics + integer-tail-aware budgets
            cascade += ["throughput", "lc_int", "even_int"]
        with nullcontext() if o.vectorized else wcl_memo():
            for split in cascade:
                plan = self._plan_with_split(wl, restricted, split, t0)
                if plan.feasible and (best is None or plan.cost < best.cost - 1e-12):
                    best = plan
        if best is not None:
            return best
        return Plan(wl, o, {}, False, time.perf_counter() - t0)

    def _plan_with_split(
        self,
        wl: Workload,
        restricted: Mapping[str, ModuleProfile],
        split: str,
        t0: float,
    ) -> Plan:
        """One cascade tier over already-restricted profiles (`_profiles`)."""
        o = self.options
        budgets = self._split_with(wl, restricted, split)
        if budgets is None:
            return Plan(wl, o, {}, False, time.perf_counter() - t0)

        # per-module scheduling (Algorithm 1 / k-tuple variants + dummy);
        # wl.app.modules is SP-leaf (topological) order, so a module's burst
        # correction can read its parents' already-fixed schedules
        schedules: dict[str, ModuleSchedule] = {}
        gap = wl.slo - wl.app.latency(budgets)
        for m in wl.app.modules:
            burst = self._burst_of(wl, schedules, m)
            s = schedule_module(
                m,
                wl.rates[m],
                budgets[m],
                restricted[m],
                o.policy,
                use_dummy=o.use_dummy and o.k_tuples is None,
                k_tuples=o.k_tuples,
                headroom=o.headroom,
                burst=burst,
                vectorized=o.vectorized,
            )
            if s is None and gap > _EPS:
                # fallback: spend the global slack on this module's budget
                s = schedule_module(
                    m,
                    wl.rates[m],
                    budgets[m] + gap,
                    restricted[m],
                    o.policy,
                    use_dummy=o.use_dummy and o.k_tuples is None,
                    k_tuples=o.k_tuples,
                    headroom=o.headroom,
                    burst=burst,
                    vectorized=o.vectorized,
                )
                if s is not None:
                    gap = max(0.0, gap - max(0.0, s.wcl - budgets[m]))
            if s is None:
                return Plan(wl, o, {}, False, time.perf_counter() - t0)
            schedules[m] = s

        # latency reassigner: hand the remaining end-to-end gap to residuals
        if o.reassign > 0 and o.k_tuples is None:
            self._reassign(wl, restricted, schedules)

        e2e = wl.app.latency({m: s.wcl for m, s in schedules.items()})
        feasible = e2e <= wl.slo + 1e-6
        return Plan(wl, o, schedules, feasible, time.perf_counter() - t0)

    def _burst_of(
        self, wl: Workload, schedules: Mapping[str, ModuleSchedule], m: str
    ) -> float:
        """Burst-aware tail correction for ``m``: one upstream batch quantum.

        Arrivals at ``m`` come in its parents' batch completions, so a tail
        machine's collection can straddle an inter-completion gap — up to one
        upstream batch's worth of arrival time ``max(b_up) / rate_up`` (the
        realized overshoot observed via the pipeline's overrun attribution).
        Zero for source modules or with ``burst_aware`` off.
        """
        if not self.options.burst_aware:
            return 0.0
        burst = 0.0
        for p in wl.app.parents(m):
            s = schedules.get(p)
            if s is None or not s.allocs:
                continue
            b_up = max(a.config.batch for a in s.allocs)
            burst = max(burst, b_up / max(s.rate, _EPS))
        return burst

    def _reassign(
        self,
        wl: Workload,
        profiles: Mapping[str, ModuleProfile],
        schedules: dict[str, ModuleSchedule],
        max_iters: int | None = None,
    ) -> None:
        o = self.options
        for _ in range(min(o.reassign, max_iters if max_iters is not None else 64)):
            e2e = wl.app.latency({m: s.wcl for m, s in schedules.items()})
            gap = wl.slo - e2e
            if gap <= 1e-9:
                return
            best: tuple[float, str, ModuleSchedule] | None = None
            for m, s in schedules.items():
                new_allocs, _over = apply_reassign(
                    s.rate + s.dummy, s.budget, gap, profiles[m], list(s.allocs),
                    o.policy, headroom=o.headroom,
                    burst=self._burst_of(wl, schedules, m),
                    vectorized=o.vectorized,
                )
                cand = replace(s, allocs=tuple(new_allocs))
                dcost = s.cost - cand.cost
                if dcost <= 1e-12:
                    continue
                # feasibility: the module's wcl may grow, re-check end-to-end
                trial = {
                    k: (cand.wcl if k == m else v.wcl) for k, v in schedules.items()
                }
                if wl.app.latency(trial) <= wl.slo + 1e-9 and (
                    best is None or dcost > best[0]
                ):
                    best = (dcost, m, cand)
            if best is None:
                return
            schedules[best[1]] = best[2]

    # -- incremental repair ----------------------------------------------------
    def replan(
        self,
        prev: Plan,
        new_rates: Mapping[str, float],
        profiles: Mapping[str, ModuleProfile],
        *,
        tolerance: float = 0.02,
        cost_guard: float = 0.01,
        force: "frozenset[str] | set[str]" = frozenset(),
    ) -> Plan:
        """Warm-start incremental repair of ``prev`` for ``new_rates``.

        Reuses the previous per-module budgets (the expensive splitter
        cascade is skipped entirely) and the previous allocation covers:

        * a module whose rate moved at most ``tolerance`` (relative) and
          still fits the provisioned collect capacity is **reused** as-is —
          the provisioned dummy/slack absorbs the drift;
        * a module beyond tolerance is **repaired**: Algorithm 1 re-solves it
          at the new rate under the *previous* budget (the split barely moves
          for moderate rate changes);
        * a cost regression beyond ``cost_guard`` over the rate-scaled
          previous cost — or any repair failure — falls back to a **cold**
          re-split (full cascade as backstop) so the warm path can never be
          worse than re-planning;
        * results are memoized by quantized rate vector (bucket width =
          ``tolerance``): a diurnal control loop revisits its rate buckets
          every period, so steady-state replans are a dict lookup.

        The result carries ``version = prev.version + 1`` and per-module
        ``provenance`` ("reused" | "repaired" | "cached" | "cold");
        ``prev.diff(new)`` yields the hot-swap delta.

        ``force`` names modules that must be re-solved even when their rate
        sits within tolerance — the control plane passes the modules whose
        *profiles* were just corrected toward measured durations, since a
        rate-drift test alone would happily reuse an allocation sized under
        the stale durations.
        """
        with nullcontext() if self.options.vectorized else wcl_memo():
            return self._replan_impl(
                prev, new_rates, profiles, tolerance=tolerance,
                cost_guard=cost_guard, force=frozenset(force),
            )

    def _replan_impl(
        self,
        prev: Plan,
        new_rates: Mapping[str, float],
        profiles: Mapping[str, ModuleProfile],
        *,
        tolerance: float,
        cost_guard: float,
        force: frozenset,
    ) -> Plan:
        t0 = time.perf_counter()
        o = self.options
        wl = replace(
            prev.workload,
            rates=dict(new_rates),
            tag=f"{prev.workload.app.name}@replan-v{prev.version + 1}",
        )

        key = self._cache_key(wl, tolerance, profiles)
        hit = self._replan_cache.get(key)
        if hit is not None and all(
            float(new_rates[m])
            <= collect_capacity(list(hit.schedules[m].allocs)) + _EPS
            for m in wl.app.modules
        ):
            return replace(
                hit,
                workload=wl,
                version=prev.version + 1,
                provenance={m: "cached" for m in wl.app.modules},
                runtime_s=time.perf_counter() - t0,
            )

        def _memo(p: Plan) -> Plan:
            if p.feasible:
                if len(self._replan_cache) >= self._cache_size:
                    self._replan_cache.pop(next(iter(self._replan_cache)))
                self._replan_cache[key] = p
            return p

        def _restamp(p: Plan) -> Plan:
            return replace(
                p,
                version=prev.version + 1,
                provenance={m: "cold" for m in wl.app.modules},
                runtime_s=time.perf_counter() - t0,
            )

        restricted = self._profiles(profiles)

        def single_split() -> Plan:
            # cheap cold tier: one pass of the configured split (it re-derives
            # the budgets, which is the one thing warm repair keeps stale)
            if restricted is None:
                return _restamp(Plan(wl, o, {}, False, 0.0))
            return _restamp(
                self._plan_with_split(wl, restricted, o.split, time.perf_counter())
            )

        def cold() -> Plan:
            p = single_split()
            if not p.feasible:
                p = _restamp(self.plan(wl, profiles))
            return p

        if not prev.feasible:
            return _memo(cold())
        if restricted is None:
            return _memo(cold())
        schedules: dict[str, ModuleSchedule] = {}
        actions: dict[str, str] = {}
        for m in wl.app.modules:
            s_prev = prev.schedules[m]
            r1 = float(new_rates[m])
            drift = abs(r1 - s_prev.rate)
            if (
                m not in force
                and drift <= tolerance * max(s_prev.rate, _EPS)
                and r1 <= collect_capacity(list(s_prev.allocs)) + _EPS
            ):
                schedules[m] = s_prev
                actions[m] = "reused"
                continue
            s = schedule_module(
                m,
                r1,
                s_prev.budget,
                restricted[m],
                o.policy,
                use_dummy=o.use_dummy and o.k_tuples is None,
                k_tuples=o.k_tuples,
                headroom=o.headroom,
                burst=self._burst_of(wl, schedules, m),
                vectorized=o.vectorized,
            )
            if s is None:
                return _memo(cold())
            schedules[m] = s
            actions[m] = "repaired"
        # short reassign pass: hand any e2e slack the rate change opened to
        # residuals (bounded — the full budget search belongs to plan())
        if o.reassign > 0 and o.k_tuples is None and "repaired" in actions.values():
            self._reassign(wl, restricted, schedules, max_iters=8)
        e2e = wl.app.latency({m: s.wcl for m, s in schedules.items()})
        if e2e > wl.slo + 1e-6:
            return _memo(cold())
        warm = Plan(
            wl,
            o,
            schedules,
            True,
            time.perf_counter() - t0,
            version=prev.version + 1,
            provenance=actions,
        )
        # cost-regression guard: frame-rate proportionality says a module's
        # cost scales ~linearly with its rate under a fixed budget, so a warm
        # plan pricier than the per-module-scaled previous cost by more than
        # the guard means the kept budgets went stale — re-derive them
        expected = 0.0
        for m in wl.app.modules:
            s_prev = prev.schedules[m]
            ratio = float(new_rates[m]) / max(s_prev.rate, _EPS)
            expected += s_prev.cost * (ratio if actions[m] != "reused" else 1.0)
        if warm.cost > expected * (1.0 + cost_guard):
            # escalate through the cold tiers until the regression clears:
            # the single-split pass usually recovers the budgets; the full
            # cascade is the backstop when the configured split itself is
            # what went stale (its extra cost is paid only on these epochs)
            best = warm
            for maker in (single_split, lambda: _restamp(self.plan(wl, profiles))):
                fb = maker()
                if fb.feasible and fb.cost < best.cost - 1e-12:
                    best = fb
                if best.cost <= expected * (1.0 + cost_guard):
                    break
            return _memo(best)
        return _memo(warm)


def plan(wl: Workload, profiles: Mapping[str, ModuleProfile], options: PlannerOptions | None = None) -> Plan:
    return Planner(options).plan(wl, profiles)
