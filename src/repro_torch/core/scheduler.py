# Verbatim copy of repro/core/scheduler.py (the JAX package's original); only import paths may differ.
"""Module scheduling: Algorithm 1 (multi-tuple GenerateConfig) + restricted variants.

Given a module's request rate ``T``, latency budget ``L`` and profile ``P``
(configs ordered by throughput-cost ratio), produce the allocation set.

* ``generate_config``         — paper Algorithm 1 (any number of tuples).
* ``generate_config_ktuple``  — baseline variant limited to K distinct
  configurations (K=1: InferLine/Clipper/Harp-1c, K=2: Nexus/Scrooge/Harp-2c).

Feasibility of a configuration at a point in the greedy walk is checked with
``GetWCL`` under the session's dispatch policy: for TC the batch-collection
rate is the *current unallocated workload* ``rw`` (which, walking in ratio
order, equals Theorem 1's remaining workload ``w_i``).
"""
from __future__ import annotations

import math

import numpy as np

from .dispatch import Alloc, ConfigArrays, Policy, config_arrays, config_wcl, config_wcl_batch
from .profiles import Config, ModuleProfile

_EPS = 1e-9


def get_wcl(
    config: Config, policy: Policy, rw: float, *, full: bool, headroom: float = 0.0,
    burst: float = 0.0,
) -> float:
    """L_wc estimate for a machine at ``config`` when ``rw`` workload remains.

    With ``headroom`` > 0 a full machine is only assigned
    ``(1 - headroom) * throughput`` traffic, so under RR/DT it collects at
    that derated capacity instead of its own throughput (TC collection is the
    remaining *real* workload either way — Theorem 1 is headroom-invariant).

    ``burst`` (seconds) is the burst-aware collection correction downstream
    of batched stages (see `dispatch.config_wcl`).  It applies to every
    machine whose batch actually waits on arrivals: a short-fill machine
    (full or tail) straddles an upstream inter-completion gap just the same.
    """
    if policy is Policy.TC:
        return config_wcl(config, policy, collect_rate=rw, burst=burst)
    if policy in (Policy.RR, Policy.DT):
        # sound model: full machines collect at their own throughput (2d);
        # partial machines cannot collect faster than their assigned rate.
        if headroom > 0.0:
            cap = config.throughput * (1.0 - headroom)
            return config_wcl(
                config, policy, collect_rate=(cap if full else min(rw, cap)),
                full=False, burst=burst,
            )
        rate = config.throughput if full else rw
        if full:
            # 2d short-circuit in config_wcl skips the burst term; a full
            # machine's local collection is still arrival-quantized
            return config_wcl(config, policy, collect_rate=rate, full=True) + burst
        return config_wcl(config, policy, collect_rate=rate, full=False, burst=burst)
    return config_wcl(config, policy, collect_rate=config.throughput)  # DT_OPT


def get_wcl_batch(
    arrs: ConfigArrays, policy: Policy, rw, *, full, headroom: float = 0.0,
    burst: float = 0.0,
) -> np.ndarray:
    """Elementwise `get_wcl` over a whole config table (see `get_wcl`).

    ``rw`` may be a scalar or a per-config array; ``full`` a bool or bool
    array.  Mirrors the scalar branch structure exactly, so the result is
    bit-identical to a per-row `get_wcl` call.
    """
    if policy is Policy.TC:
        return config_wcl_batch(arrs, policy, collect_rate=rw, burst=burst)
    if policy in (Policy.RR, Policy.DT):
        if headroom > 0.0:
            cap = arrs.throughput * (1.0 - headroom)
            if full is True:
                cr = cap
            elif full is False:
                cr = np.minimum(rw, cap)
            else:
                cr = np.where(full, cap, np.minimum(rw, cap))
            return config_wcl_batch(
                arrs, policy, collect_rate=cr, full=False, burst=burst
            )
        if full is True:
            # 2d short-circuit skips the burst term; add it back (see get_wcl)
            return config_wcl_batch(
                arrs, policy, collect_rate=arrs.throughput, full=True
            ) + burst
        part = config_wcl_batch(arrs, policy, collect_rate=rw, full=False, burst=burst)
        if full is False:
            return part
        return np.where(full, 2.0 * arrs.duration + burst, part)
    return config_wcl_batch(arrs, policy, collect_rate=arrs.throughput)  # DT_OPT


def _first_feasible(
    arrs: ConfigArrays, k: int, rw: float, L: float, policy: Policy,
    derate: float, headroom: float, burst: float,
) -> int | None:
    """First config at-or-after ``k`` whose machine holds the budget at
    remaining workload ``rw`` — one batched WCL call over the whole tail
    instead of Algorithm 1's one-at-a-time advance (the remaining workload
    is unchanged while the walk skips infeasible configs, so the batch
    evaluates exactly the feasibility checks the scalar walk would)."""
    if k >= len(arrs):
        return None
    sub = arrs.tail(k)
    full = rw / (sub.throughput * derate) >= 1.0 - 1e-12
    wcl = get_wcl_batch(sub, policy, rw, full=full, headroom=headroom, burst=burst)
    feas = wcl <= L + _EPS
    if not bool(feas.any()):
        return None
    return k + int(np.argmax(feas))


def _merge(allocs: list[Alloc]) -> list[Alloc]:
    """Merge adjacent allocations that share a configuration."""
    out: list[Alloc] = []
    for a in allocs:
        if out and out[-1].config == a.config and out[-1].derate == a.derate:
            prev = out.pop()
            out.append(
                Alloc(
                    a.config,
                    prev.machines + a.machines,
                    prev.rate + a.rate,
                    prev.dummy + a.dummy,
                    derate=a.derate,
                )
            )
        else:
            out.append(a)
    return out


def generate_config(
    T: float,
    L: float,
    profile: ModuleProfile,
    policy: Policy = Policy.TC,
    *,
    headroom: float = 0.0,
    burst: float = 0.0,
    vectorized: bool = True,
) -> tuple[bool, list[Alloc]]:
    """Paper Algorithm 1: greedy multi-tuple configuration generation.

    ``headroom`` provisions machines at ``throughput * (1 - headroom)``: the
    same real workload is spread over proportionally more machines, so each
    machine's batch run period carries slack for timeout-flushed partial
    batches (the paper's zero-slack pacing permanently loses throughput to
    any partial flush).  Feasibility is still checked against the *real*
    collection rates, so the WCL model stays honest.

    ``burst`` (seconds) applies the burst-aware tail correction: a fractional
    tail machine's feasibility is checked at ``d + b/w + burst``, so modules
    fed by upstream batch completions don't get tails whose realized
    collection straddles an upstream inter-batch gap past their budget.

    ``vectorized`` advances past infeasible configurations with one batched
    WCL evaluation over the remaining table (`_first_feasible`) instead of
    the one-config-at-a-time scalar walk; allocations are bit-identical
    either way (the remaining workload does not change while skipping).
    """
    if not 0.0 <= headroom < 1.0:
        raise ValueError(f"headroom must be in [0, 1), got {headroom}")
    if T <= _EPS:
        return True, []
    derate = 1.0 - headroom
    rw = T
    allocs: list[Alloc] = []
    k = 0
    configs = profile.configs  # ratio-descending
    if not configs:
        return False, []
    arrs = config_arrays(configs) if vectorized else None
    c = configs[k]
    while rw > _EPS:
        cap = c.throughput * derate
        n = rw / cap
        full = n >= 1.0 - 1e-12
        if get_wcl(c, policy, rw, full=full, headroom=headroom, burst=burst) <= L + _EPS:
            if full:
                nfull = math.floor(n + 1e-12)
                allocs.append(Alloc(c, float(nfull), nfull * cap, derate=derate))
                rw -= nfull * cap
                if rw < _EPS:
                    rw = 0.0
                # loop re-checks the same c against the smaller rw
            else:
                allocs.append(Alloc(c, n, rw, derate=derate))
                rw = 0.0
        else:
            if vectorized:
                nxt = _first_feasible(
                    arrs, k + 1, rw, L, policy, derate, headroom, burst
                )
                k = len(configs) if nxt is None else nxt
            else:
                k += 1
            if k >= len(configs):
                # No configuration can serve the residual fractionally (a tiny
                # rate cannot even fill a batch of 1 within the budget).  Fall
                # back to DUMMY-FILLING one machine: the frontend pads the
                # residual to a full machine's throughput, so the batch
                # collects at rate t (L_wc = 2d) at the price of one machine.
                fill = _dummy_fill(
                    rw, L, configs, policy, headroom=headroom, burst=burst,
                    vectorized=vectorized,
                )
                if fill is None:
                    return False, []
                allocs.append(fill)
                rw = 0.0
                break
            c = configs[k]
    return True, _merge(allocs)


def _dummy_fill(
    rw: float, L: float, configs, policy: Policy, *, headroom: float = 0.0,
    burst: float = 0.0, vectorized: bool = True,
) -> Alloc | None:
    """Cheapest single machine that can carry ``rw`` when padded with dummies.

    The burst correction applies here too: the padding phantoms are injected
    at the frontend's rate-limited pace, so a bursty upstream still leaves
    the dummy-filled machine's collection quantized by its real arrivals.
    """
    derate = 1.0 - headroom
    best = None
    if vectorized and configs:
        arrs = config_arrays(tuple(configs))
        caps = arrs.throughput * derate
        wcl = get_wcl_batch(arrs, policy, caps, full=True, headroom=headroom)
        ok = ~(caps < rw - _EPS) & ~(wcl + burst > L + _EPS)
        if bool(ok.any()):
            # np.argmin's first-min tie matches the scalar strict-< first-wins
            best = configs[int(np.argmin(np.where(ok, arrs.unit_price, math.inf)))]
    elif not vectorized:
        for c in configs:
            if c.throughput * derate < rw - _EPS:
                continue
            wcl = get_wcl(c, policy, c.throughput * derate, full=True, headroom=headroom)
            if wcl + burst > L + _EPS:
                continue
            if best is None or c.unit_price < best.unit_price:
                best = c
    if best is None:
        return None
    return Alloc(best, 1.0, rw, dummy=best.throughput * derate - rw, derate=derate)


def _cover_with_config(
    c: Config,
    rate: float,
    L: float,
    policy: Policy,
    *,
    collect_rate: float,
    allow_dummy: bool,
) -> list[Alloc] | None:
    """Serve ``rate`` entirely with machines at ``c`` within ``L``, or None.

    With ``allow_dummy`` the fractional tail machine may be dummy-filled when
    its own rate cannot collect a batch in time (prior systems' early-exec /
    over-provisioned residual machine — still one machine's price).
    """
    nfull = math.floor(rate / c.throughput + 1e-12)
    frac_rate = rate - nfull * c.throughput
    if nfull > 0 and get_wcl(c, policy, collect_rate, full=True) > L + _EPS:
        return None
    out = []
    if nfull > 0:
        out.append(Alloc(c, float(nfull), nfull * c.throughput))
    if frac_rate > _EPS:
        if get_wcl(c, policy, frac_rate, full=False) <= L + _EPS:
            out.append(Alloc(c, frac_rate / c.throughput, frac_rate))
        elif allow_dummy and get_wcl(c, policy, c.throughput, full=True) <= L + _EPS:
            out.append(Alloc(c, 1.0, frac_rate, dummy=c.throughput - frac_rate))
        else:
            return None
    return out


def _cover_residual(
    configs, rate: float, L: float, policy: Policy, *, collect_rate: float
) -> list[Alloc] | None:
    """Fractional coverage by the best-ratio config first; dummy-fill last."""
    for allow_dummy in (False, True):
        for c in configs:
            cover = _cover_with_config(
                c, rate, L, policy, collect_rate=collect_rate, allow_dummy=allow_dummy
            )
            if cover is not None:
                return cover
    return None


def _cover_index(
    arrs: ConfigArrays, rate: float, L: float, policy: Policy, *, collect_rate: float
) -> tuple[int, bool] | None:
    """Batched `_cover_residual` screen: the first config (and whether its
    tail needs dummy-filling) that can cover ``rate``, from three WCL
    batches instead of up to ``2 * |configs|`` scalar cover attempts.  The
    winner is then constructed by the scalar `_cover_with_config` (which
    cannot fail for a screened index)."""
    t = arrs.throughput
    nfull = np.floor(rate / t + 1e-12)
    frac = rate - nfull * t
    head_ok = (nfull <= 0) | (
        get_wcl_batch(arrs, policy, collect_rate, full=True) <= L + _EPS
    )
    part_ok = get_wcl_batch(arrs, policy, frac, full=False) <= L + _EPS
    dummy_ok = get_wcl_batch(arrs, policy, t, full=True) <= L + _EPS
    no_frac = frac <= _EPS
    for allow_dummy, tail_ok in (
        (False, no_frac | part_ok),
        (True, no_frac | part_ok | dummy_ok),
    ):
        mask = head_ok & tail_ok
        if bool(mask.any()):
            return int(np.argmax(mask)), allow_dummy
    return None


def generate_config_ktuple(
    T: float,
    L: float,
    profile: ModuleProfile,
    policy: Policy,
    k_tuples: int,
    *,
    vectorized: bool = True,
) -> tuple[bool, list[Alloc]]:
    """K-restricted scheduling used by prior systems.

    K=1: one configuration must carry the whole workload (incl. its fractional
    tail machine).  K=2: best-ratio feasible config for the majority
    (``floor(T/t)`` full machines), then ONE further config for the residual.

    ``vectorized`` screens cover feasibility with batched WCL calls
    (`_cover_index`) and constructs only the winning cover; the scalar
    double loop is the bit-exactness oracle.
    """
    if T <= _EPS:
        return True, []
    configs = profile.configs
    if not configs:
        return False, []
    arrs = config_arrays(configs) if vectorized else None
    if k_tuples <= 1:
        if vectorized:
            hit = _cover_index(arrs, T, L, policy, collect_rate=T)
            if hit is None:
                return False, []
            idx, allow_dummy = hit
            cover = _cover_with_config(
                configs[idx], T, L, policy, collect_rate=T, allow_dummy=allow_dummy
            )
            return True, _merge(cover)
        for allow_dummy in (False, True):
            for c in configs:
                cover = _cover_with_config(
                    c, T, L, policy, collect_rate=T, allow_dummy=allow_dummy
                )
                if cover is not None:
                    return True, _merge(cover)
        return False, []
    # K == 2 (the paper's two-tuple <c_opt, c_res>): greedy two-round heuristic
    # of prior systems — first feasible (max-ratio) majority config, then the
    # first config that can carry the residual including its tail machine.
    if vectorized:
        majorities = np.nonzero(
            get_wcl_batch(arrs, policy, T, full=True) <= L + _EPS
        )[0]
    else:
        majorities = [
            j for j, c in enumerate(configs)
            if get_wcl(c, policy, T, full=True) <= L + _EPS
        ]
    for j in majorities:
        c = configs[int(j)]
        nfull = math.floor(T / c.throughput + 1e-12)
        allocs = []
        res = T
        if nfull >= 1:
            allocs.append(Alloc(c, float(nfull), nfull * c.throughput))
            res = T - nfull * c.throughput
        if res <= _EPS:
            return True, _merge(allocs)
        if vectorized:
            hit = _cover_index(arrs, res, L, policy, collect_rate=res)
            cover = None
            if hit is not None:
                cover = _cover_with_config(
                    configs[hit[0]], res, L, policy, collect_rate=res,
                    allow_dummy=hit[1],
                )
        else:
            cover = _cover_residual(configs, res, L, policy, collect_rate=res)
        if cover is not None:
            return True, _merge(allocs + cover)
        # greedy majority left an infeasible residual: try next majority config
    return False, []
