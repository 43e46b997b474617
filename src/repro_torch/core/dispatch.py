# Verbatim copy of repro/core/dispatch.py (the JAX package's original); only import paths may differ.
"""Request dispatching: worst-case-latency (L_wc) models and the TC dispatcher.

Paper Sec. III-B.  Three dispatch policies:

* ``TC``  (Harpagon, Theorem 1): batched requests are handed to machines in
  descending throughput-cost-ratio order, so machine *i* collects its batch at
  its *remaining workload* rate ``w_i = sum_{r_j <= r_i} f_j``:
  ``L_wc(i) = d_i + b_i / w_i``.
* ``RR``  (Nexus/InferLine/Clipper): individual requests round-robin'ed; a
  full-capacity machine collects at its own throughput (``b/t = d``), giving
  ``L_wc = 2 d``; a partially-loaded machine (rate ``f < t``) collects at
  ``f``: ``L_wc = d + b / f``.
* ``DT``  (Scrooge): frontend forms batches and paces each machine at its
  configuration throughput, ``L_wc = d + b / t = 2 d`` for every machine
  (optimistic for partial machines; Table III row "Scrooge").

``dispatch_trace`` realizes TC/RR dispatching request-by-request; the
event-driven simulator (`repro.serving.simulator`) uses it to validate
Theorem 1 empirically.
"""
from __future__ import annotations

import enum
import math
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np

from .profiles import Config

_EPS = 1e-9

# per-planning-call memo for `config_wcl` (None = memoization off).  The
# planner's splitter cascade re-evaluates the same (config, policy, rate,
# full, burst) tuples many times — every cascade tier re-runs Algorithm 1,
# the dummy generator re-runs it once per allocation, and the reassigner
# loops over modules — so `Planner.plan`/`replan` wrap their bodies in
# `wcl_memo()` and the pure function amortizes to a dict hit.  Scoped to
# the call (not a global LRU) so the cache can never outlive the inputs
# that shaped it and costs nothing outside planning.
_WCL_MEMO: "dict | None" = None


@contextmanager
def wcl_memo():
    """Enable `config_wcl` memoization for the enclosed planning call.

    Re-entrant: a nested scope (e.g. ``replan`` falling back to ``plan``)
    keeps sharing the outermost cache.
    """
    global _WCL_MEMO
    outer = _WCL_MEMO
    if outer is None:
        _WCL_MEMO = {}
    try:
        yield
    finally:
        _WCL_MEMO = outer


class Policy(enum.Enum):
    TC = "tc"  # throughput-cost batched dispatch (Harpagon)
    RR = "rr"  # round-robin individual dispatch (Nexus/InferLine/Clipper)
    DT = "dt"  # machine-throughput-paced dispatch (Scrooge), sound on partials
    DT_OPT = "dt_opt"  # Table III "d + b/t" taken literally (Harp-dt ablation)


@dataclass(frozen=True)
class Alloc:
    """``machines`` (possibly fractional tail) running ``config``, serving ``rate`` req/s.

    ``dummy`` is phantom request rate injected by the frontend (dummy
    generator / dummy-filled residual): it raises the batch-collection rate
    (and the machine count paid for) without carrying real traffic.

    ``derate`` is the utilization-headroom factor the scheduler provisioned
    under: each machine is assigned only ``derate * throughput`` traffic, so
    its run period ``b / (derate * t) = d / derate`` leaves slack for
    timeout-flushed partial batches (``derate == 1`` = paper semantics, zero
    slack).  The invariant ``rate + dummy == machines * derate * throughput``
    holds for scheduler-produced allocations.
    """

    config: Config
    machines: float
    rate: float  # real request rate (machines * derate * throughput - dummy)
    dummy: float = 0.0
    derate: float = 1.0

    @property
    def cost(self) -> float:
        """Frame-rate-proportional cost: p * (f + dummy) / t == p * machines."""
        return self.config.unit_price * self.machines

    @property
    def full(self) -> bool:
        return self.machines >= 1.0 - 1e-12

    @property
    def cap(self) -> float:
        """Per-machine assigned capacity under headroom derating."""
        return self.config.throughput * self.derate

    @property
    def collect_rate(self) -> float:
        return self.rate + self.dummy

    @property
    def eff_ratio(self) -> float:
        """Dispatch rank: dummy-filled machines are always dispatched last
        (their padded stream feeds the collection of everything above)."""
        return -math.inf if self.dummy > _EPS else self.config.ratio

    def __repr__(self) -> str:
        dm = f"+{self.dummy:.3g}dum" if self.dummy else ""
        hr = f" util<={self.derate:.2g}" if self.derate < 1.0 - 1e-12 else ""
        return f"{self.rate:.6g}{dm} ({self.machines:.3g} x b{self.config.batch}@{self.config.hardware}{hr})"


@dataclass(frozen=True, eq=False)
class ConfigArrays:
    """Columnar (numpy) view of a configuration table.

    The batched WCL kernel (`config_wcl_batch`) evaluates Theorem 1 over a
    whole profile at once instead of one scalar `config_wcl` call per
    config.  ``throughput``/``ratio`` are materialized from the scalar
    `Config` properties so the array entries are the *same doubles* the
    scalar path computes — elementwise IEEE-754 arithmetic on them is then
    bit-identical to the scalar cascade.
    """

    configs: tuple[Config, ...]
    duration: np.ndarray
    batch: np.ndarray
    throughput: np.ndarray
    unit_price: np.ndarray
    ratio: np.ndarray

    @classmethod
    def build(cls, configs) -> "ConfigArrays":
        configs = tuple(configs)
        return cls(
            configs=configs,
            duration=np.array([c.duration for c in configs], dtype=np.float64),
            batch=np.array([float(c.batch) for c in configs], dtype=np.float64),
            throughput=np.array([c.throughput for c in configs], dtype=np.float64),
            unit_price=np.array([c.unit_price for c in configs], dtype=np.float64),
            ratio=np.array([c.ratio for c in configs], dtype=np.float64),
        )

    def __len__(self) -> int:
        return len(self.configs)

    def tail(self, k: int) -> "ConfigArrays":
        """View of configs[k:] (numpy slices are views — no copy)."""
        return ConfigArrays(
            self.configs[k:],
            self.duration[k:],
            self.batch[k:],
            self.throughput[k:],
            self.unit_price[k:],
            self.ratio[k:],
        )


# id-keyed ConfigArrays cache.  Keying by ``id(configs)`` skips re-hashing
# the config tuple on every lookup (a tuple hash walks every frozen
# dataclass); storing the tuple in the value keeps it alive, so its id can
# never be reused while the entry exists.
_ARRAYS_CACHE: "dict[int, tuple[tuple, ConfigArrays]]" = {}


def config_arrays(configs: "tuple[Config, ...]") -> ConfigArrays:
    """Cached columnar view of a profile's config tuple."""
    key = id(configs)
    hit = _ARRAYS_CACHE.get(key)
    if hit is not None and hit[0] is configs:
        return hit[1]
    arrs = ConfigArrays.build(configs)
    if len(_ARRAYS_CACHE) > 4096:
        _ARRAYS_CACHE.clear()
    _ARRAYS_CACHE[key] = (configs, arrs)
    return arrs


def config_wcl_batch(
    arrs: ConfigArrays,
    policy: Policy,
    *,
    collect_rate,
    full=True,
    burst: float = 0.0,
) -> np.ndarray:
    """Elementwise `config_wcl` over a whole config table in one call.

    ``collect_rate`` may be a scalar (one rate for every config) or an
    array (one rate per config); ``full`` likewise a bool or bool array.
    Branches mirror the scalar kernel exactly — same operations in the
    same order on the same doubles — so the result is bit-identical to
    calling `config_wcl` per row (the scalar path stays as the
    bit-exactness oracle behind ``PlannerOptions.vectorized=False``).
    """
    d, b = arrs.duration, arrs.batch
    if policy is Policy.DT_OPT:
        return d + b / arrs.throughput  # == 2d, optimistic on partials
    cr = collect_rate
    if isinstance(cr, np.ndarray):
        starved = cr <= _EPS
        gen = d + b / np.where(starved, 1.0, cr) + burst
        gen = np.where(starved, math.inf, gen)
    elif cr <= _EPS:
        gen = np.full_like(d, math.inf)
    else:
        gen = d + b / cr + burst
    if policy in (Policy.RR, Policy.DT):
        if full is True:
            return 2.0 * d  # RR: local collection at own throughput; DT: d + b/t
        if full is False:
            return gen
        return np.where(full, 2.0 * d, gen)
    return gen  # TC: Theorem 1 at the remaining workload


def total_cost(allocs: list[Alloc]) -> float:
    return sum(a.cost for a in allocs)


def total_rate(allocs: list[Alloc]) -> float:
    return sum(a.rate for a in allocs)


def collect_capacity(allocs: list[Alloc]) -> float:
    """Provisioned batch-collection capacity ``sum(machines * derate * t)``.

    For scheduler-produced allocations this equals ``sum(rate + dummy)`` —
    the total traffic (real + streamed phantom) the machines are paid to
    collect.  The control plane's replan reuses a module whose new rate
    still fits under this capacity: the dummy share absorbs the drift.
    """
    return sum(a.machines * a.cap for a in allocs)


def config_wcl(
    config: Config, policy: Policy, *, collect_rate: float, full: bool = True,
    burst: float = 0.0,
) -> float:
    """Worst-case latency of ONE machine at ``config``.

    ``collect_rate`` is the rate at which this machine's batch fills up:
    * TC: the remaining workload ``w`` (Theorem 1),
    * RR full machine: its own throughput; RR partial: its assigned rate,
    * DT: its own throughput always.

    ``burst`` is a burst-aware collection correction (seconds): downstream
    of a batched stage, arrivals come quantized in upstream batch
    completions, so any machine whose batch waits on arrivals can straddle
    an inter-completion gap of up to one upstream batch's arrival quantum
    ``b_up / rate_up`` beyond the steady-state ``b / w`` fill time —
    `scheduler.get_wcl` applies it to full and tail machines alike (a full
    machine with a short fill time straddles the gap just the same); the
    RR/DT ``2d`` short-circuit below skips it, so that caller adds it
    explicitly.
    """
    memo = _WCL_MEMO
    if memo is not None:
        key = (config, policy, collect_rate, full, burst)
        hit = memo.get(key)
        if hit is not None:
            return hit
    d, b = config.duration, config.batch
    if policy is Policy.DT_OPT:
        out = d + b / config.throughput  # == 2d, optimistic on partials
    elif policy in (Policy.RR, Policy.DT) and full:
        out = 2.0 * d  # RR: local collection at own throughput; DT: d + b/t
    elif collect_rate <= _EPS:
        out = math.inf
    else:
        out = d + b / collect_rate + burst
    if memo is not None:
        memo[key] = out
    return out


def module_wcl(allocs: list[Alloc], policy: Policy) -> float:
    """Worst-case latency of a module = max over its machines (Theorem 1)."""
    if not allocs:
        return 0.0
    worst = 0.0
    for a in allocs:
        if a.rate <= _EPS:
            continue
        if policy is Policy.TC:
            # remaining workload: every alloc ranked at-or-below this one
            # (dummy traffic counts towards batch collection; dummy-filled
            # machines rank last)
            w = sum(
                x.collect_rate
                for x in allocs
                if x.eff_ratio <= a.eff_ratio + _EPS
            )
            if a.dummy > _EPS:
                w = max(w, a.collect_rate)
            lat = config_wcl(a.config, policy, collect_rate=w)
        elif policy in (Policy.RR, Policy.DT):
            # the tail machine of a fractional alloc collects at its own rate
            frac = a.machines - math.floor(a.machines)
            if a.derate < 1.0 - 1e-12:
                # headroom-derated machine: collects at its assigned capacity
                lat = config_wcl(a.config, policy, collect_rate=a.cap, full=False)
            else:
                lat = config_wcl(a.config, policy, collect_rate=a.config.throughput)
            if frac > 1e-12:
                tail_rate = frac * a.cap + a.dummy
                lat = max(
                    lat,
                    config_wcl(
                        a.config, policy, collect_rate=tail_rate, full=False
                    ),
                )
        else:  # DT_OPT: d + b/t for every machine
            lat = config_wcl(a.config, policy, collect_rate=a.config.throughput)
        worst = max(worst, lat)
    return worst


# ---------------------------------------------------------------------------
# Request-level dispatch traces (ground truth for the event simulator).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Machine:
    """A concrete machine instance in a dispatch plan."""

    mid: int
    config: Config
    rate: float  # assigned request rate (== throughput if at full capacity)


def machine_fractions(allocs: list[Alloc]) -> list[tuple[Alloc, float]]:
    """The single machine enumerator: ``(owning alloc, capacity fraction)``
    per machine id, ratio-descending, full machines first, fractional tail
    last.  Everything that needs a per-machine-id view of an allocation set
    (`expand_machines`, `remaining_workloads`, the tenancy layer's
    device-centric plan view) derives from this walk so the id
    correspondence is structural, not re-implemented."""
    out: list[tuple[Alloc, float]] = []
    for a in sorted(allocs, key=lambda x: -x.eff_ratio):
        n_full = math.floor(a.machines + 1e-12)
        out.extend((a, 1.0) for _ in range(n_full))
        frac = a.machines - n_full
        if frac > 1e-9:
            out.append((a, frac))
    return out


def expand_machines(allocs: list[Alloc]) -> list[Machine]:
    """Expand allocations to individual machines, ratio-descending order.

    Each machine's assigned rate is the alloc's per-machine capacity
    ``derate * throughput`` (== throughput without headroom); the fractional
    tail machine carries the fractional share of that capacity.
    """
    return [
        Machine(mid, a.config, frac * a.cap)
        for mid, (a, frac) in enumerate(machine_fractions(allocs))
    ]


def remaining_workloads(allocs: list[Alloc]) -> dict[int, float]:
    """Per-machine-id remaining REAL workload ``w_i`` under TC ranking.

    Theorem 1: the machines of allocation *a* collect their batches at the
    total rate of traffic dispatched at-or-below *a*'s rank — not at the
    whole module rate.  Machine ids match `expand_machines` (both derive
    from `machine_fractions`).  Only real rates count: the caller is the
    ``timeout="budget"`` fill-time floor for plans whose dummy traffic is
    *not* streamed, where phantoms cannot help fill a batch.
    """
    return {
        mid: sum(x.rate for x in allocs if x.eff_ratio <= a.eff_ratio + _EPS)
        for mid, (a, _frac) in enumerate(machine_fractions(allocs))
    }


def dispatch_runs(
    machines: list[Machine], n_requests: int, policy: Policy
) -> list[tuple[int, int]]:
    """Assign requests to machines as run-length pairs ``[(machine_id, count)]``.

    Runs cover request ids 0..n-1 consecutively; this is the compact form of
    ``dispatch_trace`` (one entry per batch under TC instead of one per
    request), which the vectorized replay kernel expands with ``np.repeat``.

    TC: consecutive runs of ``batch`` requests per machine, walking machines in
    throughput-cost order (machines of equal ratio take turns batch-by-batch).
    RR: individual requests round-robin, weighted by assigned rate (each
    machine receives requests at a rate equal to its share of the workload).
    """
    runs: list[tuple[int, int]] = []
    if n_requests <= 0 or not machines:
        return runs
    if policy is Policy.TC:
        # Weighted fair batch scheduling: machine i receives one batch every
        # b_i / f_i time units; ties are broken by throughput-cost ratio
        # (matching Fig. 4: req1-6 -> A, req7-12 -> B, req13-16 -> C).
        # The greedy min-walk over (next_t, -ratio, index) is equivalent to
        # merge-sorting every machine's periodic run slots k * b_i / f_i by
        # that same key, which vectorizes: O(batches log batches) in numpy
        # instead of O(batches * machines) in Python — this is on the
        # simulator hot path for 10^6-request replays.
        periods = np.array([m.config.batch / m.rate for m in machines])
        batches = np.array([m.config.batch for m in machines], dtype=np.int64)
        ratios = np.array([m.config.ratio for m in machines])
        mids = np.array([m.mid for m in machines], dtype=np.int64)
        # horizon: coverage(v) = sum_i b_i * (floor(v / p_i) + 1) >= v * T,
        # so slots up to v_n = n / sum(rates) always cover n requests
        v_n = n_requests / sum(m.rate for m in machines)
        counts = (np.floor(v_n / periods).astype(np.int64) + 1)
        midx = np.repeat(np.arange(len(machines)), counts)
        k = np.arange(midx.size) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
        )
        slot_t = k * periods[midx]
        order = np.lexsort((midx, -ratios[midx], slot_t))
        sizes = batches[midx[order]]
        cum = np.cumsum(sizes)
        n_runs = int(np.searchsorted(cum, n_requests, side="left")) + 1
        run_mids = mids[midx[order[:n_runs]]]
        run_sizes = sizes[:n_runs].copy()
        run_sizes[-1] -= int(cum[n_runs - 1]) - n_requests
        return [(int(a), int(b)) for a, b in zip(run_mids, run_sizes)]
    # RR / DT: weighted round-robin of individual requests (deficit counter).
    credit = [0.0] * len(machines)
    tot = sum(m.rate for m in machines)
    prev_mid, count = -1, 0
    for _ in range(n_requests):
        for i, m in enumerate(machines):
            credit[i] += m.rate / tot
        # give the request to the machine with the largest credit
        j = max(range(len(machines)), key=lambda i: credit[i])
        credit[j] -= 1.0
        mid = machines[j].mid
        if mid == prev_mid:
            count += 1
        else:
            if count:
                runs.append((prev_mid, count))
            prev_mid, count = mid, 1
    if count:
        runs.append((prev_mid, count))
    return runs


def dispatch_trace(
    machines: list[Machine], n_requests: int, policy: Policy
) -> list[tuple[int, int]]:
    """Assign request ids 0..n-1 to machines: returns [(req_id, machine_id)].

    Per-request expansion of ``dispatch_runs`` (see there for the policy
    semantics); kept for compatibility and the trace-shape property tests.
    """
    out: list[tuple[int, int]] = []
    rid = 0
    for mid, count in dispatch_runs(machines, n_requests, policy):
        for _ in range(count):
            out.append((rid, mid))
            rid += 1
    return out
