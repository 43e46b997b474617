# Verbatim copy of repro/core/dag.py (the JAX package's original); only import paths may differ.
"""Application DAGs (series-parallel) and sessions/workloads.

Paper Sec. III-A terminology: a *session* = one DNN-based application
registration = (DAG of modules, per-module request rate, end-to-end latency
objective).  We represent DAGs as series-parallel (SP) trees — every paper
workload (traffic/face/pose/caption/actdet pipelines) is series-parallel —
which both the latency-splitting heuristics and the exact Pareto-DP brute
force exploit.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping, Union

SP = Union["Leaf", "Series", "Par"]


@dataclass(frozen=True)
class Leaf:
    name: str


@dataclass(frozen=True)
class Series:
    parts: tuple[SP, ...]


@dataclass(frozen=True)
class Par:
    parts: tuple[SP, ...]


def series(*parts: SP) -> Series:
    return Series(tuple(parts))


def par(*parts: SP) -> Par:
    return Par(tuple(parts))


def _leaves(sp: SP) -> list[str]:
    if isinstance(sp, Leaf):
        return [sp.name]
    out: list[str] = []
    for p in sp.parts:
        out.extend(_leaves(p))
    return out


def _sources(sp: SP) -> list[str]:
    if isinstance(sp, Leaf):
        return [sp.name]
    if isinstance(sp, Series):
        return _sources(sp.parts[0])
    return [s for p in sp.parts for s in _sources(p)]


def _sinks(sp: SP) -> list[str]:
    if isinstance(sp, Leaf):
        return [sp.name]
    if isinstance(sp, Series):
        return _sinks(sp.parts[-1])
    return [s for p in sp.parts for s in _sinks(p)]


def _edges(sp: SP) -> list[tuple[str, str]]:
    if isinstance(sp, Leaf):
        return []
    out: list[tuple[str, str]] = []
    for p in sp.parts:
        out.extend(_edges(p))
    if isinstance(sp, Series):
        for a, b in zip(sp.parts, sp.parts[1:]):
            for u in _sinks(a):
                for v in _sources(b):
                    out.append((u, v))
    return out


def sp_latency(sp: SP, weight: Mapping[str, float] | Callable[[str], float]) -> float:
    """End-to-end (longest-path) latency with per-module weights.

    The recursive reference; `AppDAG.latency` evaluates the same tree via a
    precompiled postorder program (`compile_sp`, bit-equal by construction)
    so hot callers pay no per-call recursion or isinstance dispatch.
    """
    w = weight if callable(weight) else weight.__getitem__
    if isinstance(sp, Leaf):
        return w(sp.name)
    if isinstance(sp, Series):
        return sum(sp_latency(p, weight) for p in sp.parts)
    return max(sp_latency(p, weight) for p in sp.parts)


# postorder program opcodes (`compile_sp` / `sp_latency_program`)
_OP_LEAF, _OP_SERIES, _OP_PAR = 0, 1, 2


def compile_sp(sp: SP) -> "tuple[tuple[int, object], ...]":
    """Flatten an SP tree into a postorder evaluation program.

    The program is a tuple of ``(opcode, arg)`` pairs: ``LEAF`` pushes the
    module's weight, ``SERIES``/``PAR`` pop their ``arg`` most recent child
    values and push the sum/max.  Children appear left-to-right, so an
    explicit-stack evaluation performs float additions and max-comparisons
    in exactly the order `sp_latency`'s recursion does — the two are
    bit-equal, not merely close (pinned by ``tests/test_dag``).
    """
    prog: list[tuple[int, object]] = []
    stack: list[tuple[SP, bool]] = [(sp, False)]
    while stack:
        node, visited = stack.pop()
        if isinstance(node, Leaf):
            prog.append((_OP_LEAF, node.name))
        elif visited:
            op = _OP_SERIES if isinstance(node, Series) else _OP_PAR
            prog.append((op, len(node.parts)))
        else:
            stack.append((node, True))
            for p in reversed(node.parts):
                stack.append((p, False))
    return tuple(prog)


def sp_latency_program(
    prog: "tuple[tuple[int, object], ...]",
    weight: Mapping[str, float] | Callable[[str], float],
) -> float:
    """Evaluate a `compile_sp` program (see there for the bit-equality
    contract with `sp_latency`)."""
    w = weight if callable(weight) else weight.__getitem__
    vals: list[float] = []
    for op, arg in prog:
        if op == _OP_LEAF:
            vals.append(w(arg))
        else:
            i = len(vals) - arg
            combined = sum(vals[i:]) if op == _OP_SERIES else max(vals[i:])
            del vals[i:]
            vals.append(combined)
    return vals[0]


def sp_critical_masks(
    sp: SP, sojourn: Mapping[str, "np.ndarray"]
) -> tuple["np.ndarray", dict[str, "np.ndarray"]]:
    """Vectorized per-sample longest-path decomposition over the SP tree.

    ``sojourn[m]`` is an array of per-sample latency contributions (one entry
    per frame; NaN where the frame never traversed ``m``).  Returns
    ``(latency, masks)``: the realized critical-path latency per sample and a
    per-module boolean mask marking membership on that sample's critical path
    — the per-frame traversal state the pipelined co-simulation attributes
    budget overruns with.  Identity: ``latency == sum_m sojourn[m] * masks[m]``
    (NaN-traversal entries excluded), because a Series keeps every member on
    the path while a Par keeps only the argmax branch.
    """
    import numpy as np

    if isinstance(sp, Leaf):
        s = np.asarray(sojourn[sp.name], dtype=np.float64)
        return s, {sp.name: ~np.isnan(s)}
    if isinstance(sp, Series):
        parts = [sp_critical_masks(p, sojourn) for p in sp.parts]
        lat = parts[0][0].copy()
        masks: dict[str, "np.ndarray"] = dict(parts[0][1])
        for p_lat, p_masks in parts[1:]:
            lat = lat + p_lat
            masks.update(p_masks)
        return lat, masks
    # Par: the argmax branch carries the path; ties go to the earliest part
    # (matching `sp_latency`'s max). NaN branches (never traversed) lose.
    parts = [sp_critical_masks(p, sojourn) for p in sp.parts]
    stack = np.stack([np.where(np.isnan(p[0]), -np.inf, p[0]) for p in parts])
    arg = np.argmax(stack, axis=0)
    lat = np.max(stack, axis=0)
    lat = np.where(np.isinf(lat), np.nan, lat)
    masks = {}
    for i, (_, p_masks) in enumerate(parts):
        on = arg == i
        for m, pm in p_masks.items():
            masks[m] = pm & on
    return lat, masks


def sp_depth(sp: SP) -> int:
    """Number of modules on the longest chain (for Clipper's even split)."""
    if isinstance(sp, Leaf):
        return 1
    if isinstance(sp, Series):
        return sum(sp_depth(p) for p in sp.parts)
    return max(sp_depth(p) for p in sp.parts)


def topo_sort(
    nodes: Iterable[str], edges: Iterable[tuple[str, str]]
) -> list[str]:
    """Kahn's algorithm over an explicit edge list, O(V + E).

    Deterministic: among ready nodes the one earliest in ``nodes`` order is
    emitted first (matching the legacy first-fit scan of the serving engine).
    Raises ``ValueError`` on a cycle, naming the nodes left unordered.
    """
    order = list(nodes)
    index = {m: i for i, m in enumerate(order)}
    indeg = {m: 0 for m in order}
    children: dict[str, list[str]] = {m: [] for m in order}
    for u, v in edges:
        if u not in indeg or v not in indeg:
            raise ValueError(f"edge ({u}, {v}) references unknown node")
        indeg[v] += 1
        children[u].append(v)
    ready = [index[m] for m in order if indeg[m] == 0]
    heapq.heapify(ready)
    out: list[str] = []
    while ready:
        m = order[heapq.heappop(ready)]
        out.append(m)
        for c in children[m]:
            indeg[c] -= 1
            if indeg[c] == 0:
                heapq.heappush(ready, index[c])
    if len(out) != len(order):
        stuck = sorted(set(order) - set(out))
        raise ValueError(f"cycle in DAG: unordered nodes {stuck}")
    return out


@dataclass(frozen=True)
class AppDAG:
    name: str
    sp: SP
    modules: tuple[str, ...] = field(default=())

    def __post_init__(self):
        object.__setattr__(self, "modules", tuple(_leaves(self.sp)))
        # latency() runs in allocator/control hot loops: evaluate the SP
        # tree through a precompiled postorder program instead of per-call
        # recursion (bit-equal to `sp_latency` — see `compile_sp`)
        object.__setattr__(self, "_latency_prog", compile_sp(self.sp))

    @property
    def edges(self) -> list[tuple[str, str]]:
        return _edges(self.sp)

    def parents(self, m: str) -> frozenset[str]:
        return frozenset(u for u, v in self.edges if v == m)

    def children(self, m: str) -> frozenset[str]:
        return frozenset(v for u, v in self.edges if u == m)

    def sibling_groups(self) -> list[tuple[str, ...]]:
        """Module groups sharing the same parents AND children (node merger)."""
        buckets: dict[tuple[frozenset, frozenset], list[str]] = {}
        for m in self.modules:
            buckets.setdefault((self.parents(m), self.children(m)), []).append(m)
        return [tuple(v) for v in buckets.values() if len(v) > 1]

    def topo_order(self) -> list[str]:
        return topo_sort(self.modules, self.edges)

    def ancestor_closure(self) -> dict[str, set[str]]:
        """Per-module transitive ancestor sets, built in one topo pass.

        Shared by the pipelined core's quiescence gating and the segment
        fast-path's causal-boundary check — both must agree on what counts
        as "upstream" or their tail-flush orderings desynchronize.
        """
        out: dict[str, set[str]] = {}
        for m in self.topo_order():
            anc: set[str] = set()
            for p in self.parents(m):
                anc.add(p)
                anc |= out[p]
            out[m] = anc
        return out

    def latency(self, weights: Mapping[str, float]) -> float:
        return sp_latency_program(self._latency_prog, weights)

    @property
    def depth(self) -> int:
        return sp_depth(self.sp)


@dataclass(frozen=True)
class Workload:
    """One session: an app DAG, per-module request rates, and a latency SLO."""

    app: AppDAG
    rates: Mapping[str, float]
    slo: float
    tag: str = ""

    def __post_init__(self):
        missing = set(self.app.modules) - set(self.rates)
        if missing:
            raise ValueError(f"rates missing for modules {missing}")
