#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure (so the script exits non-zero and prints no
result line):

1. card name and power limit; build every kernel from the sources in the
   checkout (CUDA C++ with nvcc, Triton at its first launch);
2. every kernel against its plain PyTorch version on the card, over ragged
   shapes in f32 and bf16, then timed at the serving path's shapes beside
   the plain version, one library call and the card's bound;
3. smollm-360m at full width from a seed: f32 logits through the kernels on
   the card against the same weights through the plain path on the CPU, and
   the bf16 run against the same reference;
4. profile -> plan -> serve: the forward timed at each batch size, a plan
   from that measured profile, and 200 requests through the flat serving
   engine with real forwards, with every kernel's launch count read across
   the serving run.

It ends with the kernels' JSON record, the card's name and power limit as
nvidia-smi prints them, and ``{"ok": true, "device": {...}}`` as the last
line.  Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEQ = 128          # the serving executor's tokens per request
BATCHES = (1, 2, 4, 8, 16, 32)
N_REQUESTS = 200
ARCH = "smollm-360m"
# rel err max|a - b| / max|b| of a kernel against its plain version, as the
# JAX package holds its own kernels (tests/test_kernels.py)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MODEL_TOL_F32 = 1e-3   # full-width f32 logits, card vs CPU plain path
MODEL_TOL_BF16 = 5e-2  # full-width bf16 logits vs the f32 CPU reference
# card peaks for bound_ms (NVIDIA H100 SXM data sheet, 700 W): bytes/s, and
# FLOP/s for bf16/f16 on the tensor cores and f32 on the CUDA cores
HBM_BPS = 3.35e12
L2_BYTES = 50e6
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def timed_ms(fn, n_sets: int, reps: int = 5) -> float:
    """Device time of one call ``fn(i)``, cold: the calls cycle through
    ``n_sets`` input sets that together exceed the 50 MB L2 cache, so each
    call reads its inputs from device memory, as the bound assumes.  Calls
    are captured in a CUDA graph and replayed between two events, so the
    host's launch cost is not in the number."""
    import torch

    iters = 4 * n_sets
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n_sets):  # compile / allocate outside the capture
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_sets)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def input_sets(nbytes: float) -> int:
    """Input sets whose total size is at least twice the L2 cache."""
    return max(2, math.ceil(2 * L2_BYTES / nbytes))


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phase 1
def phase_card_and_build() -> str:
    import torch

    from repro_torch.kernels import _build, fused_rmsnorm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    nvcc_s = _build.build()
    x = torch.ones((2, 64), device="cuda")
    fused_rmsnorm(x, x[0])
    torch.cuda.synchronize()
    log(f"build: nvcc {nvcc_s:.1f}s, all kernels ready in {time.perf_counter() - t0:.1f}s")
    return smi


# ------------------------------------------------------------------ phase 2
def phase_kernels() -> list[dict]:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, fused_rmsnorm, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    dev = "cuda"

    def arr(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, getattr(torch, dtype))

    n = 0
    for dtype in ("float32", "bfloat16"):
        for D in (64, 960, 2048):
            for rows in (1, 37, 4096):
                for gemma in (False, True):
                    x, w = arr((rows, D), dtype), arr((D,), dtype)
                    err = rel_err(fused_rmsnorm(x, w, gemma=gemma), ref.rmsnorm(x, w, gemma=gemma))
                    if not err <= TOL[dtype]:
                        raise AssertionError(f"fused_rmsnorm {dtype} rows={rows} D={D} gemma={gemma}: rel err {err:.3g}")
                    n += 1
    log(f"fused_rmsnorm: {n} cases within tolerance")

    attn_cases = [
        # (B, Sq, Sk, Hq, Hkv, Dk, Dv, causal, window)
        *[(B, S, S, 5 * g, 5, 64, 64, True, None)
          for (B, S) in ((1, 1), (2, 32), (1, 100), (32, 128), (2, 300)) for g in (1, 3)],
        (2, 300, 300, 15, 5, 64, 64, True, 64),   # sliding window
        (1, 200, 200, 4, 1, 256, 256, True, 100), # gemma3 head_dim, > 48 KB shared memory
        (2, 77, 77, 6, 2, 128, 64, False, None),  # not causal, Dk != Dv
        (1, 40, 90, 4, 2, 64, 64, True, None),    # Sq != Sk
        (2, 130, 130, 8, 2, 128, 128, True, None),  # head_dim 128 on the tensor cores
    ]
    n = 0
    for dtype in ("float32", "bfloat16"):
        for B, Sq, Sk, Hq, Hkv, Dk, Dv, causal, window in attn_cases:
            q, k, v = arr((B, Sq, Hq, Dk), dtype), arr((B, Sk, Hkv, Dk), dtype), arr((B, Sk, Hkv, Dv), dtype)
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = ref.attention(q, k, v, causal=causal, window=window)
            err = rel_err(got, want)
            if not err <= TOL[dtype]:
                raise AssertionError(
                    f"flash_attention {dtype} B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} "
                    f"Dk={Dk} Dv={Dv} causal={causal} window={window}: rel err {err:.3g}")
            n += 1
    q, k, v = (arr(s, "float16") for s in ((2, 50, 6, 64), (2, 50, 3, 64), (2, 50, 3, 64)))
    err = rel_err(flash_attention(q, k, v), ref.attention(q, k, v))
    if not err <= TOL["bfloat16"]:
        raise AssertionError(f"flash_attention float16: rel err {err:.3g}")
    # an input 8 bytes off 16-byte alignment takes the CUDA-core path
    q = arr((2 * 50 * 6 * 64 + 4,), "bfloat16")[4:].view(2, 50, 6, 64)
    k, v = arr((2, 50, 3, 64), "bfloat16"), arr((2, 50, 3, 64), "bfloat16")
    err = rel_err(flash_attention(q, k, v), ref.attention(q, k, v))
    if not err <= TOL["bfloat16"]:
        raise AssertionError(f"flash_attention misaligned bfloat16: rel err {err:.3g}")
    log(f"flash_attention: {n + 2} cases within tolerance")
    torch.cuda.synchronize()

    # timing at the serving path's shapes: bf16, batch 32 x 128 tokens
    B, S, d, Hq, Hkv, Dh = 32, SEQ, 960, 15, 5, 64
    x, w = arr((B, S, d), "bfloat16"), arr((d,), "bfloat16")
    nb = 2 * x.numel() * 2 + d * 2
    b_ms, b_by = bound_ms(nb, 4.0 * x.numel(), "float32")  # the arithmetic is f32, off the tensor cores
    n = input_sets(nb)
    xs = [x] + [x.clone() for _ in range(n - 1)]
    rms = {
        "name": "fused_rmsnorm", "route": "triton",
        "source": "src/repro_torch/kernels/rmsnorm.py",
        "replaces": "src/repro/kernels/rmsnorm.py:49",
        "max_abs_err": float((fused_rmsnorm(x, w).float() - ref.rmsnorm(x, w).float()).abs().max()),
        "ms": timed_ms(lambda i: fused_rmsnorm(xs[i], w), n),
        "plain_ms": timed_ms(lambda i: ref.rmsnorm(xs[i], w), n),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timed_ms(lambda i: F.rms_norm(xs[i], (d,), w, 1e-6), n),
        "shape": f"x ({B}, {S}, {d}) bf16",
    }
    del xs
    q, k, v = arr((B, S, Hq, Dh), "bfloat16"), arr((B, S, Hkv, Dh), "bfloat16"), arr((B, S, Hkv, Dh), "bfloat16")
    pairs = S * (S + 1) // 2  # causal (query, key) pairs per head
    nb = (q.numel() * 2 + k.numel() + v.numel()) * 2  # q, k, v read, o written
    b_ms, b_by = bound_ms(nb, 2.0 * pairs * (Dh + Dh) * B * Hq, "bfloat16")
    n = input_sets(nb)
    qkv = [(q, k, v)] + [tuple(t.clone() for t in (q, k, v)) for _ in range(n - 1)]
    qkv_t = [tuple(t.transpose(1, 2) for t in s) for s in qkv]  # SDPA's (B, H, S, D) view
    attn = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:123",
        "max_abs_err": float((flash_attention(q, k, v).float() - ref.attention(q, k, v).float()).abs().max()),
        "ms": timed_ms(lambda i: flash_attention(*qkv[i]), n),
        "plain_ms": timed_ms(lambda i: ref.attention(*qkv[i]), n),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timed_ms(
            lambda i: F.scaled_dot_product_attention(*qkv_t[i], is_causal=True, enable_gqa=True), n),
        "shape": f"q ({B}, {S}, {Hq}, {Dh}), k/v ({B}, {S}, {Hkv}, {Dh}) bf16 causal",
    }
    # the CUDA-core path at the same shape: the same inputs placed 8 bytes off
    # a 16-byte boundary, which the tensor-core path does not take
    def unaligned(t):
        return torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)[4:].view(t.shape).copy_(t)

    qkv_u = [tuple(unaligned(t) for t in s) for s in qkv]
    log(f"flash_attention CUDA-core path at the same shape (unaligned inputs): "
        f"kernel_ms={timed_ms(lambda i: flash_attention(*qkv_u[i]), n):.5f}")
    del qkv, qkv_t, qkv_u
    for r in (rms, attn):
        log(f"{r['name']}: kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
            f"library_ms={r['library_ms']:.5f} bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
            f"max_abs_err={r['max_abs_err']:.3g} at {r['shape']}")
    return [rms, attn]


# ------------------------------------------------------------------ phase 3
def phase_model():
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config(ARCH)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32)))
    m32 = Model(cfg32, seed=0, device="cuda")
    logits32 = m32(toks.cuda()).logits
    m16 = Model(cfg, seed=0, device="cuda")
    m16.load_state_dict(m32.state_dict())  # the same weights, rounded to bf16
    logits16 = m16(toks.cuda()).logits
    m32.to("cpu")
    want = m32(toks).logits
    for name, got in (("f32", logits32), ("bf16", logits16)):
        if got.shape != (2, 32, cfg.vocab_size) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} logits: shape {tuple(got.shape)} or non-finite values")
    e32, e16 = rel_err(logits32.cpu(), want), rel_err(logits16.cpu(), want)
    log(f"model {ARCH} full width (2, 32) tokens: card f32 vs CPU plain rel err {e32:.3g} "
        f"(limit {MODEL_TOL_F32}); card bf16 vs CPU f32 rel err {e16:.3g} (limit {MODEL_TOL_BF16})")
    if not e32 <= MODEL_TOL_F32:
        raise AssertionError(f"f32 logits rel err {e32:.3g} > {MODEL_TOL_F32}")
    if not e16 <= MODEL_TOL_BF16:
        raise AssertionError(f"bf16 logits rel err {e16:.3g} > {MODEL_TOL_BF16}")
    del m32
    return m16


# ------------------------------------------------------------------ phase 4
def forward_breakdown(executor, batch: int, top: int = 8) -> None:
    """Device time by kernel over one forward, from torch.profiler, and the
    share of the forward's wall time the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    executor(batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        executor(batch)
        wall = time.perf_counter() - t0
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3  # the kernel's own interval, us -> ms
            row[1] += 1
    busy = sum(ms for ms, _ in by_name.values())
    log(f"forward b={batch} seq={SEQ}: wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / (wall * 1e3):.1f}%), {sum(n for _, n in by_name.values())} kernels")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {ms:9.3f} ms {n:5d}x  {name[:90]}")


def phase_serve(model) -> dict[str, int]:
    from repro_torch.configs import get_config
    from repro_torch.core import Leaf, Planner, Workload, series
    from repro_torch.core.dag import AppDAG
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.launch.serve import profile_model
    from repro_torch.profiling import H100_SXM, module_duration
    from repro_torch.serving import ServingEngine

    cfg = get_config(ARCH)
    profile, executor = profile_model(ARCH, batches=BATCHES, seq=SEQ, model=model)
    forward_breakdown(executor, max(BATCHES))
    for c in sorted(profile.configs, key=lambda c: c.batch):
        analytic = module_duration(cfg, c.batch, SEQ, H100_SXM)
        log(f"profile b={c.batch}: measured {c.duration * 1e3:.3f} ms, analytic-h100 "
            f"{analytic * 1e3:.3f} ms, ratio {c.duration / analytic:.3f}")
    big = max(profile.configs, key=lambda c: c.batch)
    rate = 0.5 * big.batch / big.duration          # half one card's throughput
    slo = 2.0 * (big.batch / rate + big.duration)  # room to collect and run a full batch
    wl = Workload(AppDAG(ARCH, series(Leaf(ARCH))), {ARCH: rate}, slo)
    plan = Planner().plan(wl, {ARCH: profile})
    log(plan.summary())
    if not plan.feasible:
        raise AssertionError("plan infeasible on the measured profile")
    engine = ServingEngine(plan, executors={ARCH: executor})
    reset_launch_counts()
    res = engine.run(N_REQUESTS, rate)
    launches = {k.__name__: k.launches for k in KERNELS}
    st = res.module_stats[ARCH]
    log(f"served {len(res.e2e_latencies)}/{N_REQUESTS} requests at {rate:.1f}/s: attainment "
        f"{res.attainment:.4f} p99 {res.p99 * 1e3:.3f} ms (slo {slo * 1e3:.3f} ms) "
        f"batches {st.batches}; launches while serving {launches}")
    if len(res.e2e_latencies) != N_REQUESTS:
        raise AssertionError(f"{len(res.e2e_latencies)} of {N_REQUESTS} requests completed")
    idle = [name for name, n in launches.items() if n <= 0]
    if idle:
        raise AssertionError(f"kernels not launched while serving: {idle}")
    return launches


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside the script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    smi = phase_card_and_build()
    kernels = phase_kernels()
    model = phase_model()
    launches = phase_serve(model)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        del k["shape"]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
