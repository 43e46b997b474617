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
"""
from __future__ import annotations

import argparse
import time
from typing import Callable

import torch

from ..configs import get_config
from ..core import Leaf, Workload, series
from ..core.dag import AppDAG
from ..core.harpagon import Planner
from ..core.profiles import Config, ModuleProfile
from ..kernels import KERNELS
from ..models import Model
from ..profiling import H100_SXM, arch_profile
from ..serving import ServingEngine


def make_executor(model: Model, seq: int) -> Callable[[int], None]:
    """``executor(b)`` runs the forward on (b, seq) tokens and returns when
    the device is done, so a wall clock around it measures the batch."""
    device = model.device

    def executor(b: int) -> None:
        model(torch.zeros((b, seq), dtype=torch.long, device=device))
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
) -> tuple[ModuleProfile, Callable[[int], None]]:
    """Offline profiling pass: time the real forward at each batch size.

    On the card the profile's hardware is ``h100-sxm`` (the spec the
    analytic profiles use); on the CPU it is ``cpu``.
    """
    if model is None:
        model = Model(get_config(arch, smoke=smoke), seed=seed, device=device)
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
