# Verbatim copy of repro/serving/events.py (the JAX package's original); only import paths may differ.
"""Discrete-event core of the serving simulator (reference semantics).

One module = a set of machines fed by a dispatcher.  The dispatcher's static
request->machine assignment is computed up front (`core.dispatch`); what this
core simulates is *batch formation and service* with real deadline semantics:

* a machine's batch **opens** when a request lands in its empty formation
  buffer, **closes** when it reaches the configured batch size — or, with a
  finite ``timeout``, when the opener has waited ``timeout`` seconds (partial
  flush, exactly what a real frontend does because it cannot know whether
  more requests are coming);
* closed batches queue FIFO at the machine; service takes the profiled
  duration (or a real measured executor call) and the machine frees.

The per-machine mechanics live in :class:`MachineCore` — a composable stage
brick with no event loop of its own.  Two owners drive it: the single-module
reference loop below (`simulate_module_events`, one priority queue over
arrival / batch-flush / machine-free events) and the multi-module pipelined
co-simulation (`repro.serving.pipeline`), where many cores across DAG stages
share one global event loop and upstream batch completions feed downstream
formation buffers.

This is the *reference* implementation: it supports real executors and
arbitrary arrival patterns, and the vectorized hot path
(`repro.serving.replay`) is property-tested to agree with it.  End-of-stream
handling when ``timeout is None`` is governed by ``tail``:

* ``"flush"`` — execute the partial tail batch as soon as its last request
  has arrived (the seed engine's behavior);
* ``"drop"``  — discard tail requests (the seed simulator's behavior, i.e.
  steady-state-only accounting).
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Callable, Mapping, Sequence

import numpy as np

from ..core.dispatch import Machine

_ARRIVE, _FLUSH, _FREE = 0, 1, 2


class MachineCore:
    """Batch formation + FIFO service state of ONE machine.

    The owner's event loop calls into it; the core never touches a heap
    itself, which is what makes it composable across stages:

    * :meth:`add` appends a member to the open formation buffer and returns
      a flush deadline to arm when this member is the batch's first *real*
      request (phantoms fill slots but never arm deadlines — the deadline
      exists to bound real latency);
    * :meth:`close` moves the buffer to the FIFO service queue and bumps
      ``token`` so stale flush events become void;
    * :meth:`start` pops the next queued batch when the machine is idle and
      returns its completion time — the owner schedules the free event;
    * :meth:`free` / :meth:`discard` complete the lifecycle.

    Members are opaque to the core (request ids here, per-frame instance
    entities in the pipelined co-simulation).

    A core can be marked ``draining`` (control-plane hot swap): the owner
    stops dispatching new members to it, its already-queued batches run to
    completion, and once :attr:`drained` it holds no work and can be
    retired — no in-flight member is ever dropped by a drain.
    """

    __slots__ = (
        "machine", "timeout", "buf", "token", "armed", "armed_at", "queue",
        "free_at", "busy", "draining", "failed", "n_closed", "n_done",
    )

    def __init__(self, machine: Machine, timeout: "float | None" = None):
        self.machine = machine
        self.timeout = timeout
        self.buf: list = []          # open formation buffer
        self.token = 0               # bumped on close; voids stale flush events
        self.armed = False           # a flush deadline exists for the open batch
        self.armed_at = 0.0          # when it was armed (deadline re-anchor)
        self.queue: deque = deque()  # closed batches: (batch_ready, members)
        self.free_at = 0.0
        self.busy = False
        self.draining = False        # excluded from dispatch; finishes its work
        self.failed = False          # fenced dead (fault injection); never serves
        self.n_closed = 0            # batches closed — watchdog heartbeat seq
        self.n_done = 0              # batches whose service completed

    @property
    def drained(self) -> bool:
        """True when the core holds no work at any lifecycle stage."""
        return not self.buf and not self.queue and not self.busy

    def add(self, member, t: float, is_real: bool) -> "float | None":
        """Append one member at time ``t``; returns a deadline to arm (the
        first REAL member of an un-armed batch under a finite timeout)."""
        self.buf.append(member)
        if is_real and not self.armed and self.timeout is not None:
            self.armed = True
            self.armed_at = t
            return t + self.timeout
        return None

    @property
    def full(self) -> bool:
        return len(self.buf) >= self.machine.config.batch

    def close(self, batch_ready: float) -> None:
        """Move the open buffer to the service queue (fill or flush)."""
        self.queue.append((batch_ready, self.buf))
        self.buf = []
        self.token += 1
        self.armed = False
        self.n_closed += 1

    def retime(self, timeout: "float | None") -> "float | None":
        """Change the open batch's flush deadline in place (control-plane
        deadline relaxation).  The token bump voids any pending flush event;
        returns the new deadline re-anchored at ``armed_at`` for the owner
        to push (None: nothing armed, or deadlines now disabled)."""
        self.timeout = timeout
        if not self.armed:
            return None
        self.token += 1
        if timeout is None:
            self.armed = False
            return None
        return self.armed_at + timeout

    def discard(self) -> list:
        """Drop the open buffer (end-of-stream leftovers); returns it."""
        dropped, self.buf = self.buf, []
        self.token += 1
        self.armed = False
        return dropped

    def start(self, now: float, duration: Callable[[list], float]) -> "tuple[float, list] | None":
        """Start the next queued batch if idle; returns ``(end, members)``.

        ``duration(members)`` supplies the service time (profiled constant or
        a real measured executor call); the owner schedules the free event at
        ``end`` and records per-member completion.
        """
        if self.busy or self.failed or not self.queue:
            return None
        batch_ready, members = self.queue.popleft()
        start = max(batch_ready, self.free_at, now)
        end = start + duration(members)
        self.busy = True
        return end, members

    def free(self, t: float) -> None:
        self.busy = False
        self.free_at = t

    def fail(self) -> list:
        """Machine death: fence the core and surrender its unfinished work.

        Returns every member held in the open formation buffer and the
        queued (closed, not yet started) batches — the in-service batch is
        the owner's to reclaim, since the owner tracks started members
        against its own free event.  The token bump voids pending flush
        events; ``failed`` voids pending free events (the owner checks it)
        and refuses any future start.  A failed core reads as
        ``draining`` + ``drained`` so the next plan hot-swap retires it
        without ever reviving it.
        """
        members = list(self.buf)
        self.buf = []
        for _, batch in self.queue:
            members.extend(batch)
        self.queue.clear()
        self.token += 1
        self.armed = False
        self.busy = False
        self.failed = True
        self.draining = True
        return members


def simulate_module_events(
    machines: Sequence[Machine],
    ready: np.ndarray,
    assignment: np.ndarray,
    *,
    timeout: "float | None | Mapping[int, float]" = None,
    tail: str = "flush",
    executor: Callable[[Machine, int], float] | None = None,
    phantom: np.ndarray | None = None,
    on_batch: "Callable[[Machine, float, float, list], None] | None" = None,
) -> tuple[np.ndarray, dict[int, int]]:
    """Simulate one module; returns ``(finish, batches_per_machine)``.

    ``ready`` is the per-request ready time in causal order (plain sorted
    when no upstream tail cascades are present); ``assignment[i]`` the
    machine id serving request ``i``.  ``timeout`` may be a single deadline
    or a per-machine-id mapping.  ``finish[i]`` is the absolute completion
    time (``np.nan`` for dropped tail requests).  ``executor`` (when given)
    is called at each batch start with ``(machine, group_size)`` and must
    return the measured service duration in seconds.

    ``phantom`` marks frontend dummy requests.  They occupy batch slots and
    are executed with the batch (an executor sees the full batch size), but
    a flush deadline is armed only when a *real* request lands in the
    formation buffer, and a leftover buffer holding only phantoms is
    discarded at end of stream instead of flushed.

    ``on_batch`` (when given) is a passive observer called at every batch
    start with ``(machine, start, end, members)`` — the observability
    layer's per-batch span feed; it never influences the simulation.
    """
    if tail not in ("flush", "drop"):
        raise ValueError(f"unknown tail policy {tail!r}")
    if isinstance(timeout, Mapping):
        timeouts = {m.mid: timeout.get(m.mid) for m in machines}
    else:
        timeouts = {m.mid: timeout for m in machines}
    ready = np.asarray(ready, dtype=np.float64)
    n = ready.size
    real = np.ones(n, dtype=bool) if phantom is None else ~np.asarray(phantom, bool)
    finish = np.full(n, np.nan)
    cores = {m.mid: MachineCore(m, timeouts[m.mid]) for m in machines}
    batches = {m.mid: 0 for m in machines}
    heap: list[tuple[float, int, int, int]] = []  # (time, kind, mid, payload)

    def start_next(mid: int, now: float) -> None:
        core = cores[mid]
        m = core.machine
        if on_batch is None:
            dur = (
                (lambda rids: executor(m, len(rids)))
                if executor is not None
                else (lambda rids: m.config.duration)
            )
        else:
            drawn: list[float] = []

            def dur(rids, _d=drawn) -> float:
                d = (
                    executor(m, len(rids))
                    if executor is not None
                    else m.config.duration
                )
                _d.append(d)
                return d

        started = core.start(now, dur)
        if started is None:
            return
        end, rids = started
        batches[mid] += 1
        finish[rids] = end
        if on_batch is not None:
            on_batch(m, end - drawn[0], end, rids)
        heapq.heappush(heap, (end, _FREE, mid, 0))

    def close_batch(mid: int, batch_ready: float, now: float) -> None:
        cores[mid].close(batch_ready)
        start_next(mid, now)

    ai = 0  # pointer into the (sorted) arrival stream
    tails_done = False
    while True:
        # merge the sorted arrival stream with the flush/free heap; arrivals
        # win ties (a request landing exactly at a deadline joins the batch)
        if ai < n and (not heap or (ready[ai], _ARRIVE) <= heap[0][:2]):
            t, rid = float(ready[ai]), ai
            ai += 1
            mid = int(assignment[rid])
            core = cores[mid]
            deadline = core.add(rid, t, bool(real[rid]))
            if deadline is not None:
                heapq.heappush(heap, (deadline, _FLUSH, mid, core.token))
            if core.full:
                close_batch(mid, batch_ready=t, now=t)
            continue
        if heap:
            t, kind, mid, payload = heapq.heappop(heap)
            if kind == _FLUSH:
                if payload == cores[mid].token and cores[mid].buf:
                    close_batch(mid, batch_ready=t, now=t)
            else:  # _FREE
                cores[mid].free(t)
                start_next(mid, now=t)
            continue
        if not tails_done:
            # stream over, queues drained: resolve leftover partial batches
            tails_done = True
            for mid, core in cores.items():
                buf = core.buf
                has_real = any(real[r] for r in buf)
                if buf and has_real and timeouts[mid] is None and tail == "flush":
                    # flush at the last REAL member's arrival: the frontend
                    # stops injecting phantoms once the stream ends, so
                    # trailing phantoms must not inflate real tail latency
                    # max over VALUES, not stream positions: under causal
                    # order a backdated cascade member may sit after the
                    # time-max one (identical for sorted streams)
                    t_last = max(float(ready[r]) for r in buf if real[r])
                    close_batch(mid, batch_ready=t_last, now=t_last)
                elif buf:
                    core.discard()  # drop (finish stays NaN)
            continue
        break
    return finish, batches
