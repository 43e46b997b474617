"""Serving launcher: plan with Harpagon, then serve batched requests.

Plans a (possibly multi-module) session over the analytic H100 profiles and
runs the flat serving engine.  With --real, module executors are real
forwards of the full-width model on the device (weights made from a seed;
--smoke for the reduced config); otherwise profiled durations drive an
event simulation.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --rate 200 --slo 0.5 --requests 2000
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --real --rate 100 --slo 0.5 --requests 200     # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --real --smoke --device cpu --requests 20      # reduced, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
      --real --smoke --device cpu --requests 20      # xLSTM, reduced, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
      --real --smoke --device cpu --requests 20      # Mamba + MoE, reduced, on the CPU

jamba-v0.1-52b at full width (32 layers, 103 GB in bf16) does not fit one
80 GB card; ``chip_smoke.py`` serves its 16-layer cut through
``profile_model(model=...)``.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable

import torch

from ..configs import get_config
from ..configs.base import InputShape
from ..core import Leaf, Workload, series
from ..core.dag import AppDAG
from ..core.harpagon import Planner
from ..core.profiles import Config, ModuleProfile
from ..kernels import KERNELS
from ..models import Model
from ..profiling import H100_SXM, arch_profile
from ..serving import ServingEngine
from .specs import make_decode_fn, make_prefill_fn


def make_executor(model: Model, seq: int) -> Callable[[int], None]:
    """``executor(b)`` runs the forward on (b, seq) tokens and returns when
    the device is done, so a wall clock around it measures the batch."""
    device = model.device

    def executor(b: int) -> None:
        model(torch.zeros((b, seq), dtype=torch.long, device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    return executor


def make_decode_executor(model: Model, ctx: int, max_batch: int) -> Callable[[int], None]:
    """``executor(b)`` runs one decode step at fill level ``ctx - 1`` for the
    first ``b`` sequences of a cache of ``max_batch`` x ``ctx`` and returns when
    the device is done.

    The cache is allocated once and filled once, here, by a prefill of
    ``ctx - 1`` tokens, outside any timed window.  On a KV cache every step
    writes the same slot with the same values.  A recurrent state (xLSTM's
    C, n, m; Mamba's conv tail and h) has no length: the fill leaves it at a
    known point, and each step advances it in place, but a step's work does
    not depend on the state's values, so repeated steps still time the same
    work.  The batch
    slices of a cache tensor (batch first) are contiguous views, and the step
    writes through them into the one cache.
    """
    device = model.device
    prefill = make_prefill_fn(model, InputShape("decode_fill", ctx, max_batch, "prefill"))
    _, cache = prefill({"tokens": torch.zeros((max_batch, ctx - 1), dtype=torch.long, device=device)})
    decode = make_decode_fn(model)

    def executor(b: int) -> None:
        if not 1 <= b <= max_batch:
            raise ValueError(f"decode batch {b} outside 1..{max_batch}")
        view = [{name: t[:b] for name, t in layer.items()} for layer in cache]
        decode({"tokens": torch.zeros((b, 1), dtype=torch.long, device=device), "cache": view, "idx": ctx - 1})
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    return executor


def profile_model(
    arch: str,
    *,
    batches=(1, 2, 4, 8, 16, 32),
    seq: int = 128,
    smoke: bool = False,
    device: str = "cuda",
    seed: int = 0,
    reps: int = 3,
    model: Model | None = None,
    mode: str = "prefill",
    ctx: int = 1024,
) -> tuple[ModuleProfile, Callable[[int], None]]:
    """Offline profiling pass: time the real step at each batch size.

    ``mode="prefill"`` times the forward on (b, seq) tokens; ``mode="decode"``
    times one decode step against a cache filled to ``ctx - 1`` tokens, the
    measured counterpart of ``arch_profile(mode="decode")``.  On the card the
    profile's hardware is ``h100-sxm`` (the spec the analytic profiles use);
    on the CPU it is ``cpu``.
    """
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    if model is None:
        model = Model(get_config(arch, smoke=smoke), seed=seed, device=device)
    if mode == "decode":
        ex = make_decode_executor(model, ctx, max(batches))
    else:
        ex = make_executor(model, seq)
    hw = H100_SXM.name if model.device.type == "cuda" else "cpu"
    rows = []
    for b in batches:
        ex(b)  # warm up
        t0 = time.perf_counter()
        for _ in range(reps):
            ex(b)
        d = (time.perf_counter() - t0) / reps
        rows.append(Config(b, round(d, 6), hw, H100_SXM.unit_price))
    return ModuleProfile(arch, tuple(rows)), ex


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="comma-separated chain of archs")
    ap.add_argument("--rate", type=float, default=100.0)
    ap.add_argument("--slo", type=float, default=1.0)
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--real", action="store_true", help="execute the models on --device")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--smoke", action="store_true", help="reduced configs instead of full width")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)

    archs = args.arch.split(",")
    profiles = {
        a: arch_profile(get_config(a, smoke=args.smoke), seq=args.seq) for a in archs
    }
    dag = AppDAG("session", series(*[Leaf(a) for a in archs]))
    wl = Workload(dag, {a: args.rate for a in archs}, args.slo)
    plan = Planner().plan(wl, profiles)
    print(plan.summary())
    if not plan.feasible:
        raise SystemExit("infeasible workload")

    executors = {}
    if args.real:
        for a in archs:
            model = Model(get_config(a, smoke=args.smoke), seed=0, device=args.device)
            ex = make_executor(model, args.seq)
            ex(1)  # warm up (kernel builds happen here)
            executors[a] = ex

    res = ServingEngine(plan, executors=executors).run(args.requests, args.rate)
    print(
        f"served {len(res.e2e_latencies)} requests: SLO attainment "
        f"{100 * res.attainment:.2f}%  p99={res.p99:.4f}s  slo={args.slo}s"
    )
    for m, st in res.module_stats.items():
        print(f"  {m}: batches={st.batches} max_latency={st.max_latency:.4f}s")
    if args.real:
        print("  kernel launches: " + " ".join(f"{k.__name__}={k.launches}" for k in KERNELS))


if __name__ == "__main__":
    main()
