# Verbatim copy of repro/serving/replay.py (the JAX package's original); only import paths may differ.
"""Vectorized per-machine batch-replay kernel — the simulator hot path.

Replays the same batch-formation/service semantics as the event-driven core
(`repro.serving.events`) in O(batches) numpy work instead of a per-event
Python loop, so replaying 10^6 requests across the 1131-workload suite takes
seconds.  The two key identities:

* batch boundaries under a deadline are *usually* the plain ``batch``-sized
  reshape — one vectorized check confirms no deadline fires mid-stream and
  falls back to a per-batch greedy scan (still O(batches)) when traffic is
  bursty enough that it does;
* the FIFO service chain ``end_g = max(ready_g, end_{g-1}) + d`` runs as one
  short loop per *batch* in exactly the event core's operation order, so the
  kernel's finish times are BIT-identical to the event-driven cores (the
  prefix-max closed form is the same value only to float association) —
  which is what lets the pipelined co-simulation's segment fast-path
  (`repro.serving.pipeline.fastpath`) delegate to this kernel without
  perturbing a single bit.

**Causal arrival order.**  The pipelined event loop is the authoritative
semantics: end-of-stream tail flushes (``timeout=None``) happen only once
everything upstream has drained, so their downstream cascades deliver
*strictly after* all normal completions — round by round — even though the
flush itself backdates ``batch_ready`` to the tail's last real arrival.  A
module's replay stream must therefore be ordered by ``(quiescence depth,
ready, frame id)`` (:func:`causal_order`), not by ready time alone: at a DAG
join a backdated tail completion on one branch may carry an *earlier* time
than a sibling's normal completions, yet it still arrives *later*.  The
stream handed to :func:`replay_machine` is non-decreasing in time *within*
each depth level only; batch closure uses the causally-last member's ready
(what the event core's ``now`` is at close), and the end-of-stream tail
flushes at the max ready over its members (the event loop's quiescence
``t_last``).  :func:`propagate_depth` carries the depth bookkeeping through
a module's service so downstream joins can re-establish the order.

Property tests (tests/test_event_core.py) pin this kernel to the event core,
and golden tests pin both to the frozen seed loops in
`repro.serving.reference` on uniform arrivals (the causal tail order
deviates from the seed loops only on the rare join corner the seed got
wrong — see tests/test_golden_equivalence.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from ..core.dispatch import Machine
from .events import simulate_module_events


@dataclass
class ModuleReplay:
    """Result of replaying one module over a request stream."""

    finish: np.ndarray  # absolute completion time per request (NaN = dropped)
    assignment: np.ndarray  # serving machine id per request
    batches: dict[int, int]  # executed batches per machine
    phantom: np.ndarray | None = None  # frontend dummy-request mask (None = none)

    @property
    def done(self) -> np.ndarray:
        return ~np.isnan(self.finish)

    @property
    def real(self) -> np.ndarray:
        """Mask of real (non-phantom) requests — the only ones stats count."""
        if self.phantom is None:
            return np.ones(self.finish.size, dtype=bool)
        return ~self.phantom

    @property
    def n_batches(self) -> int:
        return sum(self.batches.values())


def runs_to_assignment(runs: Sequence[tuple[int, int]], n: int) -> np.ndarray:
    """Expand ``dispatch_runs`` run-length pairs to a per-request mid array."""
    if not runs:
        return np.zeros(0, dtype=np.int64)
    mids = np.fromiter((mid for mid, _ in runs), np.int64, len(runs))
    counts = np.fromiter((c for _, c in runs), np.int64, len(runs))
    out = np.repeat(mids, counts)
    if out.size != n:
        raise ValueError(f"runs cover {out.size} requests, expected {n}")
    return out


def causal_order(
    ready: np.ndarray,
    depth: np.ndarray | None = None,
    emit: np.ndarray | None = None,
) -> np.ndarray:
    """Delivery order of the pipelined event loop at a DAG join.

    Normal completions (depth 0) deliver in time order; end-of-stream
    tail-flush cascades (depth ``r`` >= 1) deliver strictly after every
    normal event, round by round, each round processing in event-time
    order.  A join frame's delivery *instant* (``emit``) is the processing
    time of its last-resolving parent — the lexicographic ``(depth, time)``
    max over parent completions — which can be EARLIER than its ``ready``
    value (the max parent finish) when a backdated cascade completion joins
    a normal completion from the sibling branch.  So arrivals order by
    ``(quiescence depth, emit, frame id)``; with no positive depth
    ``emit == ready`` everywhere and this is exactly the stable ready-sort
    the flat engine always used.
    """
    if depth is None or not depth.any():
        return np.argsort(ready, kind="stable")
    # lexsort: last key is primary; stable, so equal (depth, emit) pairs
    # keep ascending id — matching the event loop's same-instant delivery
    return np.lexsort((ready if emit is None else emit, depth))


def lexmax_fold(
    frames: np.ndarray,
    depth_i: np.ndarray,
    emit_i: np.ndarray,
    out_depth: np.ndarray,
    out_emit: np.ndarray,
) -> None:
    """Per-frame resolve key at one module: the lexicographic
    ``(depth, emit)`` max over the frame's completed instances — a frame
    resolves when its last instance's completion event processes, which is
    the deepest round's latest event, not necessarily the max finish value.
    Writes into the per-frame output columns in place.
    """
    if frames.size == 0:
        return
    ordk = np.lexsort((emit_i, depth_i, frames))
    fs = frames[ordk]
    last = np.flatnonzero(np.r_[fs[1:] != fs[:-1], True])
    sel = ordk[last]
    out_depth[frames[sel]] = depth_i[sel]
    out_emit[frames[sel]] = emit_i[sel]


def lexmax_parents(
    depths: Sequence[np.ndarray], emits: Sequence[np.ndarray]
) -> tuple[np.ndarray, np.ndarray]:
    """A join frame's delivery key: the lexicographic ``(depth, emit)`` max
    over its parents' per-frame resolve keys (it is delivered when the last
    parent resolves in the event loop's processing order)."""
    d = depths[0].copy()
    e = emits[0].copy()
    for dp, ep in zip(depths[1:], emits[1:]):
        take = (dp > d) | ((dp == d) & (ep > e))
        d = np.where(take, dp, d)
        e = np.where(take, ep, e)
    return d, e


def propagate_depth(
    in_depth: np.ndarray,
    assignment: np.ndarray,
    finish: np.ndarray,
    machines: Sequence[Machine],
    timeout: "float | None | Mapping[int, float]",
    tail: str,
    anc_round: int,
) -> tuple[np.ndarray, int]:
    """Quiescence-depth bookkeeping through one module's service.

    A batch is ONE completion event: every member inherits the batch's
    depth — the max over member arrival depths (a round-``r`` cascade
    arrival that fills a batch carries its depth-0 members into round
    ``r`` with it).  FIFO service serializes a machine's batches, so depth
    also accumulates batch-to-batch (a batch cannot complete before
    earlier-queued work that includes a round-``r`` member).  Batch
    boundaries are recovered from ``finish``: the FIFO chain is strictly
    increasing per machine, so members share a batch iff they share a
    finish value.  A machine whose stream leaves a flushed partial tail
    (``timeout=None``, ``tail="flush"``) holds it until the module's own
    quiescence round — one past the deepest round any ancestor flushes in
    (``anc_round``) — and the tail's completions carry that depth
    downstream.

    Returns ``(out_depth, tail_round)`` where ``out_depth`` is per-instance
    (aligned with ``assignment``) and ``tail_round`` is the module's own
    flush round (0 when no machine flushes a partial tail).
    """
    out = in_depth.astype(np.int64, copy=True)
    if not machines:
        return out, 0

    def _w(mid: int):
        return timeout.get(mid) if isinstance(timeout, Mapping) else timeout

    order = np.argsort(assignment, kind="stable")
    sorted_mid = assignment[order]
    has_tail = False
    spans: list[tuple[Machine, np.ndarray]] = []
    for mm in machines:
        lo = int(np.searchsorted(sorted_mid, mm.mid, side="left"))
        hi = int(np.searchsorted(sorted_mid, mm.mid, side="right"))
        if lo == hi:
            continue
        idx = order[lo:hi]
        spans.append((mm, idx))
        if (
            tail == "flush"
            and _w(mm.mid) is None
            and idx.size % mm.config.batch != 0
        ):
            has_tail = True
    tail_round = anc_round + 1 if has_tail else 0
    if tail_round == 0 and not in_depth.any():
        return out, 0  # fully normal-phase module: nothing to propagate
    for mm, idx in spans:
        d = in_depth[idx]
        f = finish[idx]
        gid = np.cumsum(np.r_[True, f[1:] != f[:-1]]) - 1
        gmax = np.zeros(int(gid[-1]) + 1, dtype=np.int64)
        np.maximum.at(gmax, gid, d)
        rem = idx.size % mm.config.batch
        if rem and tail == "flush" and _w(mm.mid) is None:
            gmax[-1] = max(gmax[-1], tail_round)
        out[idx] = np.maximum.accumulate(gmax)[gid]
    return out, tail_round


def _batch_bounds(
    ready: np.ndarray,
    batch: int,
    timeout: float | None,
    tail: str,
    phantom: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Group a machine's sorted ready times into batches.

    Returns ``(sizes, g_ready)``: per-batch request counts (consecutive,
    starting at request 0; a dropped tail is simply not covered) and the time
    each batch is handed to the machine.

    ``phantom`` marks frontend dummy requests.  They fill batch slots like
    real traffic, but a flush deadline is armed only by the batch's first
    *real* request (the deadline exists to bound real latency), and a
    leftover batch containing only phantoms is discarded at end of stream
    instead of executed (the frontend stops injecting when the stream ends).
    """
    n = ready.size
    has_phantom = phantom is not None and bool(phantom.any())
    if timeout is None:
        n_full, tail_sz = divmod(n, batch)
        flush_tail = bool(tail_sz) and tail == "flush"
        if flush_tail and has_phantom and bool(phantom[n_full * batch:].all()):
            flush_tail = False  # phantom-only tail: nothing real to flush for
        ng = n_full + (1 if flush_tail else 0)
        if ng == 0:
            return np.zeros(0, np.int64), np.zeros(0)
        last = np.minimum(np.arange(1, ng + 1) * batch, n) - 1
        sizes = np.diff(np.concatenate([[0], last + 1]))
        g_ready = ready[last]
        if flush_tail:
            # the end-of-stream flush happens at the tail's last arrival in
            # TIME, not in stream position: the quiescence flush reads
            # ``t_last = max(member ready)``, and under causal order a
            # backdated cascade member may sit after the time-max one.  For
            # sorted streams the max IS the last element — bit-identical.
            g_ready = g_ready.astype(np.float64, copy=True)
            if has_phantom:
                # ... and only REAL arrivals count (the frontend stops
                # injecting once the stream ends) — trailing phantoms must
                # not inflate real tail latency
                tail_real = np.flatnonzero(~phantom[n_full * batch:])
                g_ready[-1] = ready[n_full * batch + tail_real].max()
            else:
                g_ready[-1] = ready[n_full * batch:].max()
        return sizes, g_ready
    if has_phantom:
        # greedy scan with real-opener deadlines (phantom streams are rare
        # and short — engine runs — so the O(batches) loop is fine)
        real_idx = np.flatnonzero(~phantom)
        sizes_l: list[int] = []
        gr_l: list[float] = []
        i = 0
        ri = 0
        while i < n:
            while ri < real_idx.size and real_idx[ri] < i:
                ri += 1
            if ri >= real_idx.size:
                # only phantoms remain: full batches still close by fill
                # (the machine cannot know), the partial remainder is never
                # time-flushed and drops at end of stream
                while i + batch <= n:
                    sizes_l.append(batch)
                    gr_l.append(float(ready[i + batch - 1]))
                    i += batch
                break
            deadline = float(ready[real_idx[ri]]) + timeout
            j = i + batch
            j_dl = int(np.searchsorted(ready, deadline, side="right"))
            if j <= j_dl:  # fills before the first real request's deadline
                r = float(ready[j - 1])
            else:
                j = j_dl
                r = deadline
            sizes_l.append(j - i)
            gr_l.append(r)
            i = j
        return np.asarray(sizes_l, np.int64), np.asarray(gr_l)
    # deadline semantics: tentative reshape boundaries are valid iff every
    # group's opener deadline covers the group's last member (and the tail's
    # covers the end of stream)
    nb = math.ceil(n / batch)
    starts = np.arange(nb) * batch
    ends = np.minimum(starts + batch, n)
    if np.all(ready[ends - 1] <= ready[starts] + timeout):
        g_ready = ready[ends - 1].astype(np.float64, copy=True)
        if ends[-1] - starts[-1] < batch:  # partial tail flushes at deadline
            g_ready[-1] = ready[starts[-1]] + timeout
        return ends - starts, g_ready
    # bursty fallback: greedy scan, one iteration per *batch* (not request)
    sizes_l = []
    gr_l = []
    i = 0
    while i < n:
        deadline = ready[i] + timeout
        j = i + batch
        j_dl = int(np.searchsorted(ready, deadline, side="right"))
        if j <= j_dl:  # fills before the deadline
            r = float(ready[j - 1])
        else:  # deadline flush: everything arrived by then (>= the opener)
            j = j_dl
            r = deadline
        sizes_l.append(j - i)
        gr_l.append(r)
        i = j
    return np.asarray(sizes_l, np.int64), np.asarray(gr_l)


def replay_machine(
    ready: np.ndarray,
    batch: int,
    duration: float,
    *,
    timeout: float | None = None,
    tail: str = "flush",
    phantom: np.ndarray | None = None,
) -> tuple[np.ndarray, int]:
    """Replay one machine; returns ``(finish, n_batches)``.

    ``ready`` must be in causal order (sorted by time within each quiescence
    depth level — plain sorted when no tail cascades are present; see the
    module docstring).  ``finish[i]`` is the absolute completion time
    of request ``i`` (NaN when the tail is dropped).  ``phantom`` marks
    frontend dummy requests (see `_batch_bounds` for their semantics).
    """
    if tail not in ("flush", "drop"):
        raise ValueError(f"unknown tail policy {tail!r}")
    ready = np.asarray(ready, dtype=np.float64)
    n = ready.size
    finish = np.full(n, np.nan)
    if n == 0:
        return finish, 0
    sizes, g_ready = _batch_bounds(ready, batch, timeout, tail, phantom)
    ng = sizes.size
    if ng == 0:
        return finish, 0
    # FIFO service chain: end_g = max(ready_g, end_{g-1}) + d, evaluated
    # with exactly the event core's operation order so the kernel is
    # BIT-identical to `simulate_module_events` (and to the pipelined
    # co-simulation's MachineCore chain), not merely equal to ~1e-15 — the
    # prefix-max closed form `d*(g+1) + cummax(ready_g - d*g)` is the same
    # number algebraically but associates the additions differently.  One
    # Python iteration per *batch* keeps this O(n / batch), a rounding
    # error on the kernel's total runtime.
    end_l: list[float] = []
    append = end_l.append
    prev = -math.inf
    for r in g_ready.tolist():
        if prev > r:
            r = prev
        prev = r + duration
        append(prev)
    end = np.asarray(end_l)
    covered = int(sizes.sum())
    finish[:covered] = np.repeat(end, sizes)
    return finish, ng


def replay_module(
    machines: Sequence[Machine],
    ready: np.ndarray,
    runs: Sequence[tuple[int, int]],
    *,
    timeout: "float | None | Mapping[int, float]" = None,
    tail: str = "flush",
    method: str = "vectorized",
    phantom: np.ndarray | None = None,
) -> ModuleReplay:
    """Replay one module's machines over a sorted request-ready stream.

    ``runs`` is the dispatcher's run-length assignment (`dispatch_runs`).
    ``timeout`` may be one deadline for all machines or a per-machine-id
    mapping (machines with longer service need shorter collection windows to
    meet the same budget).  ``method="events"`` routes through the reference
    event core instead of the vectorized kernel (identical results; used for
    cross-validation and whenever real executors are involved).  ``phantom``
    marks frontend dummy requests: they fill batch slots but never arm flush
    deadlines or force end-of-stream flushes, and callers exclude them from
    latency statistics via ``ModuleReplay.real``.
    """
    ready = np.asarray(ready, dtype=np.float64)
    n = ready.size
    assignment = runs_to_assignment(runs, n)
    if phantom is not None:
        phantom = np.asarray(phantom, dtype=bool)
        if phantom.shape != ready.shape:
            raise ValueError("phantom mask must match the request stream")
    if method == "events":
        finish, batches = simulate_module_events(
            machines, ready, assignment, timeout=timeout, tail=tail, phantom=phantom
        )
        return ModuleReplay(finish, assignment, batches, phantom)
    if method != "vectorized":
        raise ValueError(f"unknown method {method!r}")
    finish = np.full(n, np.nan)
    batches: dict[int, int] = {}
    # one stable argsort groups requests by machine while preserving arrival
    # order within each group (much cheaper than a per-machine == scan)
    order = np.argsort(assignment, kind="stable")
    sorted_mid = assignment[order]
    for m in machines:
        lo = int(np.searchsorted(sorted_mid, m.mid, side="left"))
        hi = int(np.searchsorted(sorted_mid, m.mid, side="right"))
        if lo == hi:
            batches[m.mid] = 0
            continue
        idx = order[lo:hi]
        w = timeout.get(m.mid) if isinstance(timeout, Mapping) else timeout
        f, nb = replay_machine(
            ready[idx], m.config.batch, m.config.duration, timeout=w, tail=tail,
            phantom=None if phantom is None else phantom[idx],
        )
        finish[idx] = f
        batches[m.mid] = nb
    return ModuleReplay(finish, assignment, batches, phantom)


def fanout_counts(n: int, fanout: float) -> np.ndarray:
    """Per-position instance counts of the seed fractional accumulator.

    Position ``i`` (0-based, in stream order) contributes
    ``floor(S_i) - floor(S_{i-1})`` instances where ``S_i = fanout *
    (i+1)``.  Fanouts that are multiples of 0.5 (every seed app) are exact
    in binary floating point, so the vectorized floor-difference is
    bit-identical to the accumulator loop; other fanouts take the loop to
    preserve its exact rounding drift (`pipeline.fanout.AccumulatorFanout`
    realizes the same semantics one frame at a time).
    """
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if float(2.0 * fanout).is_integer():
        cum = np.floor(fanout * np.arange(1, n + 1))
        return np.diff(np.concatenate([[0.0], cum])).astype(np.int64)
    counts_l = []
    acc = 0.0
    for _ in range(n):
        acc += fanout
        k = int(acc)
        acc -= k
        counts_l.append(k)
    return np.asarray(counts_l, np.int64)


def expand_fanout(frames: np.ndarray, fanout: float) -> np.ndarray:
    """Expand ready-ordered frame ids into module-level request instances
    (see `fanout_counts` for the accumulator semantics)."""
    if frames.size == 0:
        return frames[:0]
    return np.repeat(frames, fanout_counts(frames.size, fanout))
