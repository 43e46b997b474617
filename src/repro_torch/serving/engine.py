# Flat path of repro/serving/engine.py (the JAX package's original), copied:
# ServingEngine.run without the frontend, observability, pipeline, control,
# fault, service-time and tenancy paths, which later slices port.
"""Serving engine: executes a Harpagon Plan over a request stream.

Arrival processes come from `arrivals` (uniform / poisson / bursty MMPP /
diurnal trace).  Per-module batch replay runs on the numpy-vectorized kernel
(`replay`) in virtual time, and on the discrete-event core (`events`) when
real executors are attached: each batch then calls
``executors[module](batch)`` under a wall clock.

Requests flow through the app DAG in topological order with per-module
fanout: module m sees ``rates[m] / frame_rate`` instances per frame, the
rates the plan provisioned for.  With ``timeout`` set (seconds, or
``"budget"`` to derive a per-machine collection deadline from the plan),
partial batches flush when their opener has waited that long.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import numpy as np

from ..core.dag import Workload, topo_sort
from ..core.dispatch import (
    Machine,
    Policy,
    dispatch_runs,
    expand_machines,
    remaining_workloads,
)
from ..core.harpagon import Plan
from .arrivals import make_arrivals
from .events import simulate_module_events
from .replay import (
    ModuleReplay,
    causal_order,
    expand_fanout,
    lexmax_fold,
    lexmax_parents,
    propagate_depth,
    replay_module,
    runs_to_assignment,
)


@dataclass
class ModuleStats:
    latencies: list[float] = field(default_factory=list)
    batches: int = 0
    dropped: int = 0

    @property
    def max_latency(self) -> float:
        return max(self.latencies) if self.latencies else 0.0


@dataclass
class ServeResult:
    e2e_latencies: list[float]
    module_stats: dict[str, ModuleStats]
    slo: float
    dropped: int = 0   # frames lost mid-pipeline (tail drops etc.)

    @property
    def offered(self) -> int:
        """Total frames offered to the system: completed + dropped."""
        return len(self.e2e_latencies) + self.dropped

    @property
    def attainment(self) -> float:
        """SLO attainment over *offered* frames: a dropped frame is a miss."""
        total = self.offered
        if total == 0:
            return 1.0
        ok = sum(1 for l in self.e2e_latencies if l <= self.slo + 1e-9)
        return ok / total

    @property
    def p99(self) -> float:
        if not self.e2e_latencies:
            return 0.0
        return float(np.quantile(np.asarray(self.e2e_latencies), 0.99))


def resolve_module_timeout(
    schedule,
    machines: "list[Machine]",
    timeout: "float | str | None",
    policy: Policy,
) -> "float | None | dict[int, float]":
    """Resolve the batch-collection deadline for one module schedule.

    ``"budget"`` derives a per-machine deadline from the plan: each machine
    must flush early enough that collection + its own service duration still
    fits the module's latency budget, floored at the time real traffic takes
    to fill its batch.  Under TC machine i fills at the *remaining* workload
    w_i (Theorem 1); under RR/DT at its own share of the traffic.
    """
    if timeout is None or isinstance(timeout, (int, float)):
        return timeout
    if timeout == "budget":
        s = schedule
        if policy is Policy.TC:
            w_of = remaining_workloads(list(s.allocs))
            def fill(mm: Machine) -> float:
                return mm.config.batch / max(w_of.get(mm.mid, s.rate), 1e-12)
        else:
            tot = sum(mm.rate for mm in machines)
            def fill(mm: Machine) -> float:
                rate = s.rate
                if tot > 0:
                    rate *= mm.rate / tot
                return mm.config.batch / max(rate, 1e-12)
        return {
            mm.mid: max(s.budget - mm.config.duration, fill(mm))
            for mm in machines
        }
    raise ValueError(f"unknown timeout spec {timeout!r}")


class ServingEngine:
    def __init__(
        self,
        plan: Plan,
        *,
        executors: Mapping[str, Callable[[int], None]] | None = None,
        policy: Policy = Policy.TC,
    ):
        """``executors[module](batch_size)`` runs a real batched forward; when
        None the profiled config duration is used (virtual time)."""
        self.plan = plan
        self.executors = executors or {}
        self.policy = policy

    def run(
        self,
        n_frames: int,
        frame_rate: float,
        *,
        arrivals: "str | np.ndarray | Sequence[float]" = "uniform",
        seed: int = 0,
        timeout: "float | str | None" = None,
        tail: str = "flush",
        offered_rate: float | None = None,
    ) -> ServeResult:
        """Serve ``n_frames`` frames arriving at ``offered_rate`` (default:
        the provisioned ``frame_rate``) through the planned DAG.

        ``frame_rate`` stays the *provisioned* rate: it fixes the per-module
        fanout, so ``offered_rate > frame_rate`` drives the plan into
        overload without rescaling the workload shape.
        """
        if offered_rate is not None and offered_rate <= 0:
            raise ValueError("offered_rate must be positive")
        arrival = make_arrivals(
            arrivals, n_frames,
            offered_rate if offered_rate is not None else frame_rate,
            seed=seed,
        )
        return self._serve(arrival, frame_rate, timeout=timeout, tail=tail)

    def _serve(
        self,
        arrival: np.ndarray,
        frame_rate: float,
        *,
        timeout: "float | str | None",
        tail: str,
    ) -> ServeResult:
        """Replay the DAG over the frames arriving at ``arrival``."""
        wl: Workload = self.plan.workload
        arrival = np.asarray(arrival, dtype=np.float64)
        n_frames = arrival.size
        # finish time of frame i at module m (0.0 = not processed / dropped)
        finish_at = {m: np.zeros(n_frames) for m in wl.app.modules}
        stats = {m: ModuleStats() for m in wl.app.modules}
        # a frame is *lost* when some module materialized instances for it
        # but completed none (tail drop / deadline overrun) — as opposed to a
        # frame a fanout < 1 module legitimately skipped, which the seed
        # semantics exclude from the statistics entirely
        lost = np.zeros(n_frames, dtype=bool)
        # quiescence-depth tracking (causal tail order): end-of-stream tail
        # flushes happen in the event loop's quiescence rounds, strictly
        # after all normal completions — their backdated cascades must be
        # *delivered* last at DAG joins even when their times are earlier.
        # Only the timeout=None flush path produces tails.
        track_depth = timeout is None and tail == "flush"
        depth = (
            {m: np.zeros(n_frames, dtype=np.int64) for m in wl.app.modules}
            if track_depth
            else {}
        )
        emit = (
            {m: np.zeros(n_frames) for m in wl.app.modules}
            if track_depth
            else {}
        )
        tail_rounds: dict[str, int] = {}
        anc = wl.app.ancestor_closure() if track_depth else {}
        for m in topo_sort(wl.app.modules, wl.app.edges):
            parents = wl.app.parents(m)
            in_depth = in_emit = None
            if parents:
                pf = np.stack([finish_at[p] for p in parents])
                ready = np.maximum(arrival, pf.max(axis=0))
                drop = (pf <= 0.0).any(axis=0)
                if track_depth:
                    in_depth, in_emit = lexmax_parents(
                        [depth[p] for p in parents],
                        [emit[p] for p in parents],
                    )
            else:
                ready = arrival
                drop = np.zeros(n_frames, dtype=bool)
            fanout = wl.rates[m] / frame_rate
            anc_round = (
                max((tail_rounds.get(a, 0) for a in anc.get(m, ())), default=0)
                if track_depth
                else 0
            )
            tail_rounds[m] = self._run_module(
                m, ready, drop, fanout, finish_at[m], stats[m], lost,
                timeout=timeout, tail=tail,
                in_depth=in_depth,
                in_emit=in_emit,
                out_depth=depth[m] if track_depth else None,
                out_emit=emit[m] if track_depth else None,
                anc_round=anc_round,
            )
        sinks = [m for m in wl.app.modules if not wl.app.children(m)]
        sf = np.stack([finish_at[s] for s in sinks])
        ok = (sf > 0).all(axis=0)
        e2e = sf.max(axis=0)[ok] - arrival[ok]
        dropped = int((lost & ~ok).sum())
        return ServeResult(e2e.tolist(), stats, wl.slo, dropped=dropped)

    def _module_timeout(
        self,
        m: str,
        machines: "list[Machine]",
        timeout: "float | str | None",
    ) -> "float | None | dict[int, float]":
        return resolve_module_timeout(
            self.plan.schedules[m], machines, timeout, self.policy
        )

    def _run_module(
        self,
        m: str,
        ready: np.ndarray,
        drop: np.ndarray,
        fanout: float,
        finish_frame: np.ndarray,
        stats: ModuleStats,
        lost: np.ndarray,
        *,
        timeout: "float | str | None",
        tail: str,
        in_depth: "np.ndarray | None" = None,
        in_emit: "np.ndarray | None" = None,
        out_depth: "np.ndarray | None" = None,
        out_emit: "np.ndarray | None" = None,
        anc_round: int = 0,
    ) -> int:
        sched = self.plan.schedules[m]
        machines = expand_machines(list(sched.allocs))
        # expand frames into module-level request instances by fanout, in
        # causal order — (quiescence depth, emit, id); plain stable
        # ready-sort when no upstream tail cascades exist — skipping frames
        # dropped upstream
        order = causal_order(ready, in_depth, in_emit)
        frames = order[~drop[order]]
        instances = expand_fanout(frames, fanout)
        n = instances.size
        if n == 0:
            return 0
        ready_inst = ready[instances]
        runs = dispatch_runs(machines, n, self.policy)
        w = self._module_timeout(m, machines, timeout)
        ex = self.executors.get(m)
        if ex is None:
            rep = replay_module(machines, ready_inst, runs, timeout=w, tail=tail)
        else:
            def _measured(machine: Machine, _group: int) -> float:
                t0 = time.perf_counter()
                ex(machine.config.batch)
                return time.perf_counter() - t0

            finish, batches = simulate_module_events(
                machines,
                ready_inst,
                runs_to_assignment(runs, n),
                timeout=w,
                tail=tail,
                executor=_measured,
            )
            rep = ModuleReplay(finish, runs_to_assignment(runs, n), batches)
        tail_round = 0
        if out_depth is not None:
            # thread the quiescence depth through service: completions
            # inherit their machine's running-max arrival depth, this
            # module's own flushed tail (if any) fires one round past the
            # deepest ancestor flush, and each frame's resolve key is the
            # lexicographic (depth, finish) max over its instances — the
            # processing instant of its last completion event
            inst_depth = (
                in_depth[instances]
                if in_depth is not None
                else np.zeros(n, dtype=np.int64)
            )
            out_inst, tail_round = propagate_depth(
                inst_depth, rep.assignment, rep.finish, machines, w, tail,
                anc_round,
            )
            done_i = ~np.isnan(rep.finish)
            lexmax_fold(
                instances[done_i], out_inst[done_i], rep.finish[done_i],
                out_depth, out_emit,
            )
        finish_real = rep.finish
        done = ~np.isnan(finish_real)
        stats.batches += rep.n_batches
        stats.dropped += int(n - done.sum())
        stats.latencies.extend((finish_real[done] - ready_inst[done]).tolist())
        # frame finish = max over its instances (dropped instances contribute 0)
        np.maximum.at(finish_frame, instances[done], finish_real[done])
        # frames that had instances here but completed none are lost, not
        # merely skipped by fanout — they count as pipeline drops
        if not done.all():
            had = np.zeros(finish_frame.size, dtype=bool)
            had[instances] = True
            lost |= had & (finish_frame <= 0.0)
        return tail_round
