# Verbatim copy of repro/core/splitter.py (the JAX package's original); only import paths may differ.
"""Latency splitting: Algorithm 2 (latency-cost efficiency) + optimizers + baselines.

Paper Sec. III-D.  During splitting each module is represented by a single
*split configuration* ``c``; its fractional-packing cost is
``C_M(c) = p_c * T_M / t_c`` and its latency contribution is
``GetWCL(c) = d + b / T_M`` under TC dispatch (the whole module rate is the
batch-collection rate for the majority machines).

Splitters implemented:

* ``split_lc``          — Algorithm 2: greedy max latency-cost efficiency
                          ``LC = dCost / dL_wc``; optional *node merger*
                          (sibling joint upgrades) and *cost-direct* (re-do
                          the last R iterations greedily by raw cost delta).
* ``split_throughput``  — Scrooge/InferLine-style: greedy by throughput.
* ``split_even``        — Clipper-style: ``L / depth`` per module.
* ``split_quantized``   — Nexus-style: exact DP over a discretized budget
                          grid on the SP tree (interval ``q``).
* ``split_dp``          — exact quantized-budget DP over the app DAG with the
                          *full* module scheduler as the cost oracle (the
                          brute-force optimum at the splitting level; see
                          `repro.core.bruteforce`).

Each returns ``{module: budget}`` — the per-module latency budget handed to
the module scheduler — and is feasible by construction
(``critical-path latency <= SLO``) or ``None`` when even the least-demanding
configuration cannot meet the SLO.

The greedy splitters run on an array-backed state (`_VecState`) by default:
module rates are fixed during splitting, so every config's split WCL and
fractional-packing cost is precomputed once per module with the batched WCL
kernel, and candidate selection walks a descending sort instead of probing
every candidate's end-to-end latency.  ``vectorized=False`` selects the
scalar reference implementation (`_State`) — the bit-exactness oracle.
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np

from .dag import AppDAG, Leaf, Par, Series, SP, Workload
from .dispatch import Policy, config_arrays
from .profiles import Config, ModuleProfile
from .scheduler import get_wcl, get_wcl_batch

_EPS = 1e-9
INF = math.inf


def split_cost(c: Config, T: float) -> float:
    """Fractional-packing cost of carrying rate T entirely on configuration c."""
    return c.unit_price * T / c.throughput


def split_wcl(c: Config, T: float, policy: Policy) -> float:
    """Module-level L_wc when the whole rate T rides configuration c
    (fractional-packing view: the tail machine is ignored)."""
    return get_wcl(c, policy, T, full=T >= c.throughput - _EPS)


def split_wcl_integer(c: Config, T: float, policy: Policy) -> float:
    """Integer-aware L_wc: accounts for the fractional tail machine, which
    either collects at its own small rate or is dummy-filled to a full
    machine (L_wc = 2d).  Budgets derived from this are schedulable by
    construction (the single-config integer cover fits)."""
    t = c.throughput
    if T < t - _EPS:
        # single partial machine — or dummy-filled if collection is too slow
        return min(get_wcl(c, policy, T, full=False), get_wcl(c, policy, t, full=True))
    full = get_wcl(c, policy, T, full=True)
    tail = T - math.floor(T / t + 1e-12) * t
    if tail <= _EPS:
        return full
    tail_wcl = min(
        get_wcl(c, policy, tail, full=False), get_wcl(c, policy, t, full=True)
    )
    return max(full, tail_wcl)


class _State:
    """Mutable Algorithm-2 state: one split config per module."""

    def __init__(
        self,
        wl: Workload,
        profiles: Mapping[str, ModuleProfile],
        policy: Policy,
        *,
        integer_tails: bool = False,
    ):
        self.wl = wl
        self.profiles = profiles
        self.policy = policy
        self.integer_tails = integer_tails
        self._wcl_fn = split_wcl_integer if integer_tails else split_wcl
        # Start at the least cost-efficient / lowest-latency configuration
        # (paper: batch 1 on the priciest hardware).  We pick the minimum-WCL
        # config (tie: highest unit price) so that the start is feasible
        # whenever any single-config assignment is.
        self.cfg: dict[str, Config] = {
            m: min(
                profiles[m].configs,
                key=lambda c: (self._wcl_fn(c, wl.rates[m], policy), -c.unit_price),
            )
            for m in wl.app.modules
        }

    def wcl(self, m: str, c: Config | None = None) -> float:
        return self._wcl_fn(c or self.cfg[m], self.wl.rates[m], self.policy)

    def cost(self, m: str, c: Config | None = None) -> float:
        return split_cost(c or self.cfg[m], self.wl.rates[m])

    def e2e(self, override: Mapping[str, Config] | None = None) -> float:
        def w(m: str) -> float:
            c = override.get(m) if override else None
            return self.wcl(m, c or self.cfg[m])

        return self.wl.app.latency({m: w(m) for m in self.wl.app.modules})

    def total_cost(self) -> float:
        return sum(self.cost(m) for m in self.wl.app.modules)

    def feasible(self) -> bool:
        return self.e2e() <= self.wl.slo + _EPS

    def budgets(self) -> dict[str, float]:
        return {m: self.wcl(m) for m in self.wl.app.modules}


def _candidates(st: _State, m: str) -> list[tuple[float, float, Config]]:
    """Cost-reducing upgrade candidates for module m: (dcost, dlat, config)."""
    out = []
    prev = st.cfg[m]
    c_prev, l_prev = st.cost(m), st.wcl(m)
    for c in st.profiles[m].configs:
        if c == prev:
            continue
        dcost = c_prev - st.cost(m, c)
        if dcost <= 1e-12:
            continue
        dlat = st.wcl(m, c) - l_prev
        out.append((dcost, dlat, c))
    return out


def _lc(dcost: float, dlat: float) -> float:
    """Latency-cost efficiency; free (non-latency-increasing) moves rank first."""
    return INF if dlat <= _EPS else dcost / dlat


# ---------------------------------------------------------------------------
# Vectorized Algorithm-2 machinery.
# ---------------------------------------------------------------------------


def _split_wcl_arr(arrs, T: float, policy: Policy) -> np.ndarray:
    """Elementwise `split_wcl` over a config table."""
    full = T >= arrs.throughput - _EPS
    return get_wcl_batch(arrs, policy, T, full=full)


def _split_wcl_integer_arr(arrs, T: float, policy: Policy) -> np.ndarray:
    """Elementwise `split_wcl_integer` over a config table."""
    t = arrs.throughput
    w_t_full = get_wcl_batch(arrs, policy, t, full=True)
    w_T_full = get_wcl_batch(arrs, policy, T, full=True)
    w_T_part = get_wcl_batch(arrs, policy, T, full=False)
    tail = T - np.floor(T / t + 1e-12) * t
    tail_wcl = np.minimum(get_wcl_batch(arrs, policy, tail, full=False), w_t_full)
    integer = np.where(tail <= _EPS, w_T_full, np.maximum(w_T_full, tail_wcl))
    return np.where(T < t - _EPS, np.minimum(w_T_part, w_t_full), integer)


# (wcl, cost) arrays per (config table, rate, policy, tail model), id-keyed
# like `dispatch.config_arrays` (the stored configs tuple keeps the id
# alive).  Rates are fixed during splitting and repeat across the planner's
# cascade tiers, so the arrays amortize across `_VecState` constructions.
_SPLIT_ARRAYS_CACHE: dict = {}


def _split_arrays(
    configs, T: float, policy: Policy, integer_tails: bool
) -> "tuple[np.ndarray, np.ndarray]":
    key = (id(configs), T, policy, integer_tails)
    hit = _SPLIT_ARRAYS_CACHE.get(key)
    if hit is not None and hit[0] is configs:
        return hit[1], hit[2]
    arrs = config_arrays(configs)
    wcl = (
        _split_wcl_integer_arr(arrs, T, policy)
        if integer_tails
        else _split_wcl_arr(arrs, T, policy)
    )
    cost = arrs.unit_price * T / arrs.throughput
    if len(_SPLIT_ARRAYS_CACHE) > 8192:
        _SPLIT_ARRAYS_CACHE.clear()
    _SPLIT_ARRAYS_CACHE[key] = (configs, wcl, cost)
    return wcl, cost


class _VecState:
    """Array-backed Algorithm-2 state (the vectorized `_State`).

    Every config's split WCL / fractional-packing cost is precomputed per
    module (rates are fixed during splitting), the current pick is tracked
    by config *index*, and the per-module WCL map is maintained
    incrementally so an e2e probe is one `AppDAG.latency` walk.  Candidate
    winners are found by walking a stable descending sort of the key
    (module order × config order on ties — the scalar loop's iteration
    order), stopping at the first e2e-feasible candidate: that is exactly
    the scalar argmax-with-strict-``>`` winner, but e2e probes are paid
    only until the first feasible candidate instead of per candidate.
    """

    __slots__ = (
        "wl", "profiles", "policy", "integer_tails", "modules", "wcl_arr",
        "cost_arr", "idx", "curw", "_sl", "g_lc", "g_dcost", "g_thr",
        "g_mid", "g_cid", "g_tie", "g_infeas",
    )

    def __init__(self, wl, profiles, policy, *, integer_tails=False, _src=None):
        if _src is not None:  # clone: share the immutable arrays
            self.wl, self.profiles, self.policy = _src.wl, _src.profiles, _src.policy
            self.integer_tails = _src.integer_tails
            self.modules = _src.modules
            self.wcl_arr, self.cost_arr = _src.wcl_arr, _src.cost_arr
            self._sl = _src._sl
            self.g_mid, self.g_cid, self.g_tie = _src.g_mid, _src.g_cid, _src.g_tie
            self.g_thr = _src.g_thr
            self.idx = dict(_src.idx)
            self.curw = dict(_src.curw)
            self.g_lc = _src.g_lc.copy()
            self.g_dcost = _src.g_dcost.copy()
            self.g_infeas = _src.g_infeas.copy()
            return
        self.wl, self.profiles, self.policy = wl, profiles, policy
        self.integer_tails = integer_tails
        self.modules = list(wl.app.modules)
        self.wcl_arr, self.cost_arr = {}, {}
        self.idx, self.curw, self._sl = {}, {}, {}
        off = 0
        mids: list[int] = []
        cids: list[int] = []
        thrs: list[np.ndarray] = []
        for mi, m in enumerate(self.modules):
            configs = profiles[m].configs
            w, c = _split_arrays(configs, wl.rates[m], policy, integer_tails)
            self.wcl_arr[m], self.cost_arr[m] = w, c
            price = config_arrays(configs).unit_price
            thrs.append(config_arrays(configs).throughput)
            n = len(configs)
            self._sl[m] = slice(off, off + n)
            mids.extend([mi] * n)
            cids.extend(range(n))
            off += n
            # start at min (wcl, -price): feasible whenever any single-config
            # assignment is (same tie order as the scalar min())
            i = int(np.lexsort((np.arange(n), -price, w))[0])
            self.idx[m] = i
            self.curw[m] = float(w[i])
        self.g_mid = np.array(mids, dtype=np.int64)
        self.g_cid = np.array(cids, dtype=np.int64)
        self.g_tie = np.arange(off)
        self.g_thr = np.concatenate(thrs) if thrs else np.empty(0)
        self.g_lc = np.empty(off)
        self.g_dcost = np.empty(off)
        self.g_infeas = np.zeros(off, dtype=bool)
        for m in self.modules:
            self._refresh(m)

    def clone(self) -> "_VecState":
        return _VecState(None, None, None, _src=self)

    def _refresh(self, m: str) -> None:
        """Recompute module m's candidate keys after its pick changed.

        Invalid candidates (non-cost-reducing, incl. the current pick at
        dcost 0) are encoded as -inf so they sort last; valid LC values are
        positive (or +inf for free moves), so -inf doubles as the walk's
        end-of-valid sentinel.
        """
        sl = self._sl[m]
        i = self.idx[m]
        ca, wa = self.cost_arr[m], self.wcl_arr[m]
        dcost = ca[i] - ca
        dlat = wa - wa[i]
        valid = dcost > 1e-12
        with np.errstate(divide="ignore", invalid="ignore"):
            lc = np.where(dlat <= _EPS, INF, dcost / dlat)
        self.g_lc[sl] = np.where(valid, lc, -INF)
        self.g_dcost[sl] = np.where(valid, dcost, -INF)

    def set_idx(self, m: str, i: int) -> None:
        old = self.curw[m]
        self.idx[m] = i
        w = float(self.wcl_arr[m][i])
        self.curw[m] = w
        if w < old:
            # A budget decreased: cached infeasibility verdicts (valid only
            # while every other module's WCL is >= when they were probed)
            # may be stale.  Drop them all.
            self.g_infeas[:] = False
        self._refresh(m)

    def cfg_of(self, m: str) -> Config:
        return self.profiles[m].configs[self.idx[m]]

    def e2e(self) -> float:
        return self.wl.app.latency(self.curw)

    def e2e_with(self, move: "Mapping[str, int]") -> float:
        w = dict(self.curw)
        for m, i in move.items():
            w[m] = float(self.wcl_arr[m][i])
        return self.wl.app.latency(w)

    def feasible(self) -> bool:
        return self.e2e() <= self.wl.slo + _EPS

    def total_cost(self) -> float:
        return sum(float(self.cost_arr[m][self.idx[m]]) for m in self.modules)

    def budgets(self) -> dict[str, float]:
        return dict(self.curw)

    def _walk(self, order: np.ndarray, keyarr: np.ndarray) -> int | None:
        """First e2e-feasible candidate in ``order`` (descending key); the
        -inf sentinel in ``keyarr`` marks where valid candidates end.

        Infeasible probes are cached in ``g_infeas``: a single-module move's
        e2e latency depends only on the *other* modules' WCLs (the move
        overrides its own), and `AppDAG.latency` is monotone in every leaf
        (sum/max compositions, monotone under IEEE-754 rounding too) — so
        once a move is infeasible it stays infeasible until some budget
        decreases (which clears the cache in `set_idx`).  This turns the
        per-step probe cost from O(rejected candidates) into amortized O(1).
        """
        slo = self.wl.slo
        for pos in order:
            p = int(pos)
            if keyarr[p] == -INF:
                return None
            if self.g_infeas[p]:
                continue
            m = self.modules[self.g_mid[p]]
            if self.e2e_with({m: int(self.g_cid[p])}) <= slo + _EPS:
                return p
            self.g_infeas[p] = True
        return None

    def step_lc(self, groups, history: list) -> bool:
        """One Algorithm-2 iteration: apply the max-(LC, dcost) feasible
        operation over single-module upgrades and sibling-group merges."""
        order = np.lexsort((self.g_tie, -self.g_dcost, -self.g_lc))
        best: "tuple[float, float, dict[str, int]] | None" = None
        p = self._walk(order, self.g_lc)
        if p is not None:
            m = self.modules[self.g_mid[p]]
            best = (float(self.g_lc[p]), float(self.g_dcost[p]), {m: int(self.g_cid[p])})
        for grp in groups:
            move: dict[str, int] = {}
            dcost_sum, dlat_max = 0.0, 0.0
            for m in grp:
                sl = self._sl[m]
                lc_m = self.g_lc[sl]
                j = int(np.argmax(lc_m))  # first-max tie == scalar max()
                if lc_m[j] == -INF:
                    continue
                move[m] = j
                dcost_sum += float(self.g_dcost[sl][j])
                dlat_max = max(dlat_max, float(self.wcl_arr[m][j]) - self.curw[m])
            if len(move) < 2:
                continue
            key = (_lc(dcost_sum, dlat_max), dcost_sum)
            if (best is None or key > (best[0], best[1])) and self.e2e_with(
                move
            ) <= self.wl.slo + _EPS:
                best = (key[0], dcost_sum, move)
        if best is None:
            return False
        history.append({m: (self.idx[m], i) for m, i in best[2].items()})
        for m, i in best[2].items():
            self.set_idx(m, i)
        return True

    def step_cost(self) -> bool:
        """One cost-direct iteration: apply the max-dcost feasible upgrade."""
        p = self._walk(np.lexsort((self.g_tie, -self.g_dcost)), self.g_dcost)
        if p is None:
            return False
        self.set_idx(self.modules[self.g_mid[p]], int(self.g_cid[p]))
        return True

    def step_throughput(self) -> bool:
        """One throughput-greedy iteration: max-(throughput, dcost) feasible."""
        thr = np.where(self.g_dcost == -INF, -INF, self.g_thr)
        p = self._walk(np.lexsort((self.g_tie, -self.g_dcost, -thr)), thr)
        if p is None:
            return False
        self.set_idx(self.modules[self.g_mid[p]], int(self.g_cid[p]))
        return True


def split_lc(
    wl: Workload,
    profiles: Mapping[str, ModuleProfile],
    policy: Policy = Policy.TC,
    *,
    node_merge: bool = True,
    cost_direct: bool = True,
    cost_direct_r: tuple[int, ...] = (1, 2, 3),
    integer_tails: bool = False,
    vectorized: bool = True,
) -> dict[str, float] | None:
    """Algorithm 2 + node merger + cost-direct.  Returns per-module budgets."""
    if vectorized:
        return _split_lc_vec(
            wl, profiles, policy, node_merge=node_merge, cost_direct=cost_direct,
            cost_direct_r=cost_direct_r, integer_tails=integer_tails,
        )
    st = _State(wl, profiles, policy, integer_tails=integer_tails)
    if not st.feasible():
        return None
    groups = wl.app.sibling_groups() if node_merge else []
    history: list[dict[str, tuple[Config, Config]]] = []

    def step_lc() -> bool:
        """One Algorithm-2 iteration: apply the max-LC feasible operation."""
        best: tuple[float, float, dict[str, Config]] | None = None  # (lc, dcost, move)
        for m in wl.app.modules:
            for dcost, dlat, c in _candidates(st, m):
                move = {m: c}
                key = (_lc(dcost, dlat), dcost)
                if (best is None or key > (best[0], best[1])) and st.e2e(move) <= wl.slo + _EPS:
                    best = (key[0], dcost, move)
        # node merger: joint upgrade of sibling groups, LC summed
        for grp in groups:
            move: dict[str, Config] = {}
            dcost_sum, dlat_max = 0.0, 0.0
            for m in grp:
                cands = _candidates(st, m)
                if not cands:
                    continue
                dcost, dlat, c = max(cands, key=lambda x: _lc(x[0], x[1]))
                move[m] = c
                dcost_sum += dcost
                dlat_max = max(dlat_max, dlat)
            if len(move) < 2:
                continue
            key = (_lc(dcost_sum, dlat_max), dcost_sum)
            if (best is None or key > (best[0], best[1])) and st.e2e(move) <= wl.slo + _EPS:
                best = (key[0], dcost_sum, move)
        if best is None:
            return False
        record = {m: (st.cfg[m], c) for m, c in best[2].items()}
        st.cfg.update(best[2])
        history.append(record)
        return True

    while step_lc():
        pass

    if cost_direct and history:
        best_cfg = dict(st.cfg)
        best_cost = st.total_cost()
        for r in cost_direct_r:
            if r > len(history):
                continue
            # roll back the final r operations
            trial = _State(wl, profiles, policy, integer_tails=integer_tails)
            trial.cfg = dict(st.cfg)
            for record in reversed(history[-r:]):
                for m, (old, _new) in record.items():
                    trial.cfg[m] = old
            # greedy by raw cost delta
            while True:
                best_mv: tuple[float, dict[str, Config]] | None = None
                for m in wl.app.modules:
                    for dcost, _dlat, c in _candidates(trial, m):
                        if (best_mv is None or dcost > best_mv[0]) and trial.e2e(
                            {m: c}
                        ) <= wl.slo + _EPS:
                            best_mv = (dcost, {m: c})
                if best_mv is None:
                    break
                trial.cfg.update(best_mv[1])
            if trial.total_cost() < best_cost - 1e-12:
                best_cost = trial.total_cost()
                best_cfg = dict(trial.cfg)
        st.cfg = best_cfg

    return st.budgets()


def _split_lc_vec(
    wl: Workload,
    profiles: Mapping[str, ModuleProfile],
    policy: Policy,
    *,
    node_merge: bool,
    cost_direct: bool,
    cost_direct_r: tuple[int, ...],
    integer_tails: bool,
) -> dict[str, float] | None:
    """`split_lc` on the array-backed state: bit-identical budgets."""
    st = _VecState(wl, profiles, policy, integer_tails=integer_tails)
    if not st.feasible():
        return None
    groups = wl.app.sibling_groups() if node_merge else []
    history: list[dict[str, tuple[int, int]]] = []
    while st.step_lc(groups, history):
        pass
    if cost_direct and history:
        best_idx = dict(st.idx)
        best_cost = st.total_cost()
        for r in cost_direct_r:
            if r > len(history):
                continue
            # roll back the final r operations, then greedy by raw cost delta
            trial = st.clone()
            for record in reversed(history[-r:]):
                for m, (old_i, _new_i) in record.items():
                    trial.set_idx(m, old_i)
            while trial.step_cost():
                pass
            tc = trial.total_cost()
            if tc < best_cost - 1e-12:
                best_cost = tc
                best_idx = dict(trial.idx)
        for m, i in best_idx.items():
            if i != st.idx[m]:
                st.set_idx(m, i)
    return st.budgets()


def split_throughput(
    wl: Workload,
    profiles: Mapping[str, ModuleProfile],
    policy: Policy = Policy.TC,
    *,
    vectorized: bool = True,
) -> dict[str, float] | None:
    """Scrooge/InferLine-style: greedily upgrade whichever module gains the
    highest throughput, ignoring latency-budget efficiency."""
    if vectorized:
        st = _VecState(wl, profiles, policy)
        if not st.feasible():
            return None
        while st.step_throughput():
            pass
        return st.budgets()
    st = _State(wl, profiles, policy)
    if not st.feasible():
        return None
    while True:
        best: tuple[tuple[float, float], dict[str, Config]] | None = None
        for m in wl.app.modules:
            for dcost, _dlat, c in _candidates(st, m):
                key = (c.throughput, dcost)
                if (best is None or key > best[0]) and st.e2e({m: c}) <= wl.slo + _EPS:
                    best = (key, {m: c})
        if best is None:
            break
        st.cfg.update(best[1])
    return st.budgets()


def split_even(
    wl: Workload,
    profiles: Mapping[str, ModuleProfile],
    policy: Policy = Policy.RR,
    *,
    integer_tails: bool = False,
    vectorized: bool = True,
) -> dict[str, float] | None:
    """Clipper-style: every module gets SLO / depth."""
    per = wl.slo / wl.app.depth
    budgets = {}
    if vectorized:
        for m in wl.app.modules:
            w, _cost = _split_arrays(
                profiles[m].configs, wl.rates[m], policy, integer_tails
            )
            if not bool((w <= per + _EPS).any()):
                return None
            budgets[m] = per
        return budgets
    wf = split_wcl_integer if integer_tails else split_wcl
    for m in wl.app.modules:
        feas = [
            c
            for c in profiles[m].configs
            if wf(c, wl.rates[m], policy) <= per + _EPS
        ]
        if not feas:
            return None
        budgets[m] = per
    return budgets


def _sp_quantized_dp(
    sp: SP, nq: int, q: float, cost_at: Mapping[str, list[float]]
) -> list[float]:
    """min-cost DP over the SP tree: dp[k] = min cost with latency <= k*q."""
    if isinstance(sp, Leaf):
        return cost_at[sp.name]
    if isinstance(sp, Series):
        dp = _sp_quantized_dp(sp.parts[0], nq, q, cost_at)
        for p in sp.parts[1:]:
            nxt = _sp_quantized_dp(p, nq, q, cost_at)
            out = [INF] * (nq + 1)
            # dp and nxt are monotone non-increasing in k; combine minimally.
            for a in range(nq + 1):
                if dp[a] is INF:
                    continue
                for b in range(nq + 1 - a):
                    v = dp[a] + nxt[b]
                    if v < out[a + b]:
                        out[a + b] = v
            # prefix-min to enforce monotonicity
            for k in range(1, nq + 1):
                out[k] = min(out[k], out[k - 1])
            dp = out
        return dp
    # Par: same budget for every branch
    parts = [_sp_quantized_dp(p, nq, q, cost_at) for p in sp.parts]
    return [sum(p[k] for p in parts) for k in range(nq + 1)]


def _sp_quantized_assign(
    sp: SP, k: int, nq: int, q: float, cost_at: Mapping[str, list[float]]
) -> dict[str, float]:
    """Recover per-module budgets from the DP solution with total budget k*q."""
    if isinstance(sp, Leaf):
        return {sp.name: k * q}
    if isinstance(sp, Par):
        out: dict[str, float] = {}
        for p in sp.parts:
            out.update(_sp_quantized_assign(p, k, nq, q, cost_at))
        return out
    # Series: re-run the pairwise combination tracking the split point
    tails = [_sp_quantized_dp(Series(sp.parts[i:]), nq, q, cost_at) for i in range(len(sp.parts))]
    out = {}
    rem = k
    for i, p in enumerate(sp.parts):
        head = _sp_quantized_dp(p, nq, q, cost_at)
        if i == len(sp.parts) - 1:
            out.update(_sp_quantized_assign(p, rem, nq, q, cost_at))
            break
        tail = tails[i + 1]
        best_a, best_v = 0, INF
        for a in range(rem + 1):
            v = head[a] + tail[rem - a]
            if v < best_v - 1e-15:
                best_v, best_a = v, a
        out.update(_sp_quantized_assign(p, best_a, nq, q, cost_at))
        rem -= best_a
    return out


def split_quantized(
    wl: Workload,
    profiles: Mapping[str, ModuleProfile],
    policy: Policy = Policy.TC,
    q: float = 0.01,
    *,
    vectorized: bool = True,
) -> dict[str, float] | None:
    """Nexus-style: exact DP over budgets quantized to multiples of ``q``."""
    nq = int(wl.slo / q)
    if nq < 1:
        return None
    cost_at: dict[str, list[float]] = {}
    ks = np.arange(nq + 1) if vectorized else None
    for m in wl.app.modules:
        T = wl.rates[m]
        if vectorized:
            arrs = config_arrays(profiles[m].configs)
            lw = _split_wcl_arr(arrs, T, policy)
            cst = arrs.unit_price * T / arrs.throughput
            k0 = np.ceil(lw / q - 1e-9)
            per_arr = np.where(ks[:, None] >= k0[None, :], cst[None, :], INF).min(
                axis=1, initial=INF
            )
            # restore the INF singleton for the DP's identity fast path
            per = [v if v < INF else INF for v in per_arr.tolist()]
            cost_at[m] = per
            continue
        per = [INF] * (nq + 1)
        for c in profiles[m].configs:
            lw = split_wcl(c, T, policy)
            k0 = math.ceil(lw / q - 1e-9)
            if k0 > nq:
                continue
            cst = split_cost(c, T)
            for k in range(k0, nq + 1):
                if cst < per[k]:
                    per[k] = cst
        cost_at[m] = per
    dp = _sp_quantized_dp(wl.app.sp, nq, q, cost_at)
    if dp[nq] is INF or dp[nq] == INF:
        return None
    budgets = _sp_quantized_assign(wl.app.sp, nq, nq, q, cost_at)
    # guard: every module must have at least one feasible config at its budget
    for m, b in budgets.items():
        if cost_at[m][min(nq, int(b / q))] == INF:
            return None
    return budgets


def split_dp(
    wl: Workload,
    profiles: Mapping[str, ModuleProfile],
    policy: Policy = Policy.TC,
    *,
    n_grid: int = 240,
    use_dummy: bool = True,
) -> dict[str, float] | None:
    """Exact quantized-budget DP over the app DAG (the fifth splitter).

    Unlike `split_quantized`, whose per-budget cost model is the
    fractional-packing estimate of a *single* split configuration, the DP
    here prices every grid budget with the **full module scheduler**
    (Algorithm 1 + dummy generator) — the same curves `bruteforce.
    optimal_cost` composes, so the recovered budgets realize the
    brute-force optimum at the splitting level (state = (module, remaining
    budget), value = total serving cost; series = min-plus convolution,
    parallel = shared budget).

    Exactness caveats: the cost oracle runs at ``headroom=0``/``burst=0``
    (the paper's zero-slack semantics — matching ``optimal_cost``), and
    optimality is up to the ``slo / n_grid`` budget quantum.  At the
    default 240-point grid this derives the brute-force bound for the
    paper's 91.5%-style share of feasible workloads while staying ~10^3x
    cheaper than the paper's 35.9 s/workload exhaustive search.  Still far
    pricier than the greedy splitters, so the planner offers it as the
    selectable ``split="dp"`` tier, not part of the default cascade.
    """
    from .bruteforce import optimal_split  # local: keep module load cheap

    return optimal_split(
        wl, profiles, policy, n_grid=n_grid, use_dummy=use_dummy
    )
