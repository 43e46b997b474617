# Verbatim copy of repro/serving/arrivals.py (the JAX package's original); only import paths may differ.
"""Pluggable request arrival processes for the serving simulator.

Every generator returns a sorted ``float64`` numpy array of ``n`` absolute
arrival times (seconds, starting near 0) with long-run mean rate ``rate``
req/s, and is deterministic under ``seed``.  Processes:

* ``uniform``  — evenly spaced arrivals ``i / rate`` (streaming-video regime,
  the paper's steady-state assumption behind Theorem 1).
* ``poisson``  — homogeneous Poisson process (exponential inter-arrivals).
* ``mmpp`` / ``bursty`` — 2-state Markov-modulated Poisson process: a calm
  state and a burst state whose intensity is ``burst``x higher, with
  exponentially distributed dwell times.  Long-run mean rate is ``rate``.
* ``diurnal`` — inhomogeneous Poisson with a sinusoidal day/night intensity
  profile (``trace_arrivals`` accepts any intensity profile, e.g. one read
  from a production trace).

The non-uniform processes are realized by time-rescaling a unit-rate Poisson
process through the inverse integrated intensity Λ⁻¹ — the standard
construction, vectorized with ``np.interp`` over the piecewise-linear Λ.
"""
from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np


def uniform_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """Evenly spaced arrivals at exactly ``rate`` req/s (seed ignored)."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    return np.arange(n, dtype=np.float64) / rate


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """Homogeneous Poisson process: i.i.d. Exp(rate) inter-arrival times."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def _rescale(unit_times: np.ndarray, seg_t: np.ndarray, seg_lam: np.ndarray) -> np.ndarray:
    """Map unit-rate Poisson event times through Λ⁻¹ of a piecewise-linear
    integrated intensity given by knots ``(seg_t, seg_lam)`` (both sorted)."""
    return np.interp(unit_times, seg_lam, seg_t)


def mmpp_arrivals(
    n: int,
    rate: float,
    seed: int = 0,
    *,
    burst: float = 8.0,
    frac_burst: float = 0.15,
    mean_dwell: float = 2.0,
) -> np.ndarray:
    """2-state MMPP: calm intensity ``r0`` and burst intensity ``burst * r0``.

    ``frac_burst`` is the long-run fraction of time spent in the burst state
    (so the stationary mean rate is exactly ``rate``); ``mean_dwell`` is the
    mean sojourn (seconds) of one calm+burst cycle.
    """
    if rate <= 0 or burst < 1.0 or not (0.0 < frac_burst < 1.0):
        raise ValueError("need rate>0, burst>=1, 0<frac_burst<1")
    if n == 0:
        return np.zeros(0)
    r0 = rate / (1.0 - frac_burst + frac_burst * burst)
    r1 = burst * r0
    t_calm = mean_dwell * (1.0 - frac_burst)
    t_burst = mean_dwell * frac_burst
    rng = np.random.default_rng(seed)
    unit = np.cumsum(rng.exponential(1.0, size=n))
    target = unit[-1]
    # build Λ knots over alternating calm/burst sojourns until Λ covers target
    knots_t = [0.0]
    knots_lam = [0.0]
    state = 0
    while knots_lam[-1] < target:
        dwell = rng.exponential(t_calm if state == 0 else t_burst)
        lam = r0 if state == 0 else r1
        knots_t.append(knots_t[-1] + dwell)
        knots_lam.append(knots_lam[-1] + dwell * lam)
        state ^= 1
    return _rescale(unit, np.asarray(knots_t), np.asarray(knots_lam))


def trace_arrivals(
    n: int,
    rate: float,
    seed: int = 0,
    *,
    profile: Callable[[np.ndarray], np.ndarray] | Sequence[float] | None = None,
    period: float = 60.0,
    grid: int = 4096,
) -> np.ndarray:
    """Inhomogeneous Poisson driven by a periodic relative-intensity profile.

    ``profile`` maps time (array, seconds) to relative intensity >= 0 — e.g.
    a diurnal curve or a replayed production trace; a sequence is treated as
    evenly spaced samples over one ``period`` and normalized to mean 1 so the
    long-run rate stays ``rate`` (a callable is trusted to have mean ~1; the
    default is a day/night sinusoid with mean exactly 1).
    """
    if n == 0:
        return np.zeros(0)
    if profile is None:
        profile = lambda t: 1.0 + 0.8 * np.sin(2.0 * np.pi * t / period)
    if not callable(profile):
        samples = np.asarray(profile, dtype=np.float64)
        if samples.size == 0 or np.any(samples < 0) or samples.mean() <= 0:
            raise ValueError("profile samples must be non-negative with positive mean")
        samples = samples / samples.mean()
        xs = np.linspace(0.0, period, samples.size, endpoint=False)
        profile = lambda t: np.interp(np.mod(t, period), xs, samples, period=period)
    rng = np.random.default_rng(seed)
    unit = np.cumsum(rng.exponential(1.0, size=n))
    target = unit[-1]
    # integrate rate * profile(t) on a fixed grid, extend until Λ covers target
    dt = period / grid
    knots_t = np.array([0.0])
    knots_lam = np.array([0.0])
    while knots_lam[-1] < target:
        t0 = knots_t[-1]
        ts = t0 + dt * np.arange(1, grid + 1)
        lam = rate * np.clip(profile(ts - 0.5 * dt), 0.0, None)
        knots_t = np.concatenate([knots_t, ts])
        knots_lam = np.concatenate([knots_lam, knots_lam[-1] + np.cumsum(lam * dt)])
    return _rescale(unit, knots_t, knots_lam)


ARRIVALS: Mapping[str, Callable[..., np.ndarray]] = {
    "uniform": uniform_arrivals,
    "poisson": poisson_arrivals,
    "mmpp": mmpp_arrivals,
    "bursty": mmpp_arrivals,
    "diurnal": trace_arrivals,
    "trace": trace_arrivals,
}


def make_arrivals(
    kind: "str | np.ndarray | Sequence[float]",
    n: int,
    rate: float,
    seed: int = 0,
    **kwargs,
) -> np.ndarray:
    """Resolve an arrival spec: a process name, or an explicit time array.

    An explicit array is validated (sorted, length ``n``) and passed through,
    letting callers replay recorded traces directly.
    """
    if isinstance(kind, str):
        try:
            fn = ARRIVALS[kind]
        except KeyError:
            raise ValueError(f"unknown arrival process {kind!r}; have {sorted(ARRIVALS)}")
        return fn(n, rate, seed, **kwargs)
    arr = np.asarray(kind, dtype=np.float64)
    if arr.ndim != 1 or arr.size != n:
        raise ValueError(f"explicit arrivals must be 1-D of length {n}")
    if np.any(np.diff(arr) < 0):
        raise ValueError("explicit arrivals must be sorted")
    return arr
