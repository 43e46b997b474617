#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure (so the script exits non-zero and prints no
result line):

1. card name and power limit; build every kernel from the sources in the
   checkout (CUDA C++ with nvcc, Triton at its first launch);
2. every kernel against its plain PyTorch version on the card, over ragged
   shapes in f32 and bf16 (and f16), then timed at the serving path's shapes
   beside the plain version, one library call (where one exists) and the
   card's bound;
3. smollm-360m at full width from a seed: f32 logits through the kernels on
   the card against the same weights through the plain path on the CPU, and
   the bf16 run against the same reference;
3b. cached decode at full width: smollm-360m (f32 and bf16) and gemma3-1b
   (f32, its 512-slot local rings wrapped) prefill a KV cache and decode
   through it, each step against the uncached forward at the same positions,
   and smollm's first f32 step against the CPU plain path;
3c. xlstm-125m at full width from a seed: f32 logits at (2, XLSTM_SEQ) tokens
   (several mLSTM chunks) against the CPU plain path, each bf16 block on the
   card against the f32 block on the CPU fed the same input, and its
   recurrent cache: prefill XLSTM_SEQ tokens, then 4 decode steps, each
   against the uncached forward;
3d. jamba-v0.1-52b at full width from a seed: each block kind (Mamba + dense
   MLP, Mamba + MoE, attention + dense MLP) at (2, JAMBA_SEQ) tokens in f32
   on the card against the CPU plain path and in bf16 against that; its
   one-macro-block cut (JAMBA_CHECK_LAYERS, 53.2 GB in f32): cached decode,
   prefill JAMBA_SEQ tokens then 4 steps, against the uncached forward, and
   the whole model in bf16 against f32;
4. profile -> plan -> serve prefill: the forward timed at each batch size, a
   plan from that measured profile, and 200 requests through the flat
   serving engine with real forwards;
5. the same for decode: one decode step against a cache of CTX tokens timed
   at each batch size beside the analytic decode profile, a plan, and 200
   requests served by decode steps.

Phases 4 and 5 run for smollm-360m, xlstm-125m and then jamba-v0.1-52b's
serving cut (JAMBA_SERVE_LAYERS, bf16, 52.1 GB; the full 32 layers do not
fit the card).  Each sets the launch counts to 0 just before serving, reads
them just after, and fails unless every kernel of its path (PATH_KERNELS)
was launched.

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
SEQ = 128          # the prefill executor's tokens per request
CTX = 1024         # the decode executor's cache fill: a step attends over CTX tokens
BATCHES = (1, 2, 4, 8, 16, 32)
N_REQUESTS = 200
ARCH = "smollm-360m"
XLSTM = "xlstm-125m"
XLSTM_SEQ = 300    # xlstm model checks: crosses the mLSTM kernel's chunk boundaries
JAMBA = "jamba-v0.1-52b"
# jamba's depth cuts, in whole 8-layer macro-blocks at the published widths:
# the full 32 layers (51.6B parameters, 103 GB in bf16) do not fit one 80 GB
# card; 16 layers (26.05B, 52.1 GB in bf16) are the deepest that leave room
# for the decode fill's activations beside them, and serve; 8 layers (13.3B,
# 53.2 GB in f32) are the f32 checks
JAMBA_SERVE_LAYERS = 16
JAMBA_CHECK_LAYERS = 8
JAMBA_SEQ = 300    # jamba block and model checks: crosses the scan's chunk boundaries
# rel err max|a - b| / max|b| of a kernel against its plain version, as the
# JAX package holds its own kernels (tests/test_kernels.py)
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-2}
# chunked_mlstm, as the JAX package holds its Pallas mLSTM (tests/test_kernels.py:176):
# looser than TOL because the weights are exponentials of long cumulative sums
MLSTM_TOL = {"float32": 2e-4, "bfloat16": 3e-2, "float16": 3e-2}
MODEL_TOL_F32 = 1e-3   # full-width f32 logits, card vs CPU plain path
MODEL_TOL_BF16 = 5e-2  # full-width bf16 logits (xlstm, jamba: each bf16 block) vs the f32 reference
# xlstm-125m's whole bf16 model: rounding the same weights to bf16 moves its
# logits far past MODEL_TOL_BF16, in the JAX package too.  Its own distance
# at full width on the same tokens (tools/xlstm_bf16_drift.py, the largest
# over seeds 0, 1 and 2 on the CPU), and the factor within which the port's
# distance on the card must stay (as tests/test_torch_xlstm.py holds it at
# the smoke config).
XLSTM_BF16_REPRO = 0.584967
XLSTM_BF16_FACTOR = 2.0
# jamba's one-macro-block cut in bf16, the same way: `repro`'s own distance
# at that config on the same tokens (tools/jamba_bf16_drift.py, the largest
# over seeds 0, 1 and 2, JAX on the CPU), and the factor for the port's
JAMBA_BF16_REPRO = 0.843555
JAMBA_BF16_FACTOR = 2.0
DECODE_TOL_F32 = 5e-3  # cached decode vs the uncached forward, f32 (tests/test_models.py)
# the kernels each serving path must launch; the xLSTM and Mamba decode
# steps' single-token recurrent updates are plain tensor code, as in JAX
PATH_KERNELS = {
    (ARCH, "prefill"): ("fused_rmsnorm", "flash_attention"),
    (ARCH, "decode"): ("fused_rmsnorm", "flash_decode"),
    (XLSTM, "prefill"): ("fused_rmsnorm", "chunked_mlstm"),
    (XLSTM, "decode"): ("fused_rmsnorm",),
    (JAMBA, "prefill"): ("fused_rmsnorm", "flash_attention", "chunked_selective_scan"),
    (JAMBA, "decode"): ("fused_rmsnorm", "flash_decode"),
}
# card peaks for bound_ms (NVIDIA H100 SXM data sheet, 700 W): bytes/s, and
# FLOP/s for bf16/f16 on the tensor cores and f32 outside them: the best the
# card does for the inputs' type, whatever units a kernel uses
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


def phase_decode_kernel() -> dict:
    """flash_decode against its plain version over ragged cases, then timed at
    the serving decode shape (b = 32, ctx = CTX) and at b = 1."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode, ref

    rng = np.random.default_rng(5)
    dev = "cuda"

    def arr(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, getattr(torch, dtype))

    def lengths(B, S):  # ragged, with 1 and S among them
        lens = rng.integers(1, S + 1, B)
        lens[0] = S if B == 1 else 1
        lens[-1] = S
        return torch.from_numpy(lens.astype(np.int32)).to(dev)

    cases = [
        # (B, S, Hq, Hkv, Dk, Dv, window)
        (1, 77, 5, 5, 64, 64, None),          # g = 1
        (3, 1000, 15, 5, 64, 64, None),       # g = 3 (smollm)
        (32, 1024, 15, 5, 64, 64, None),      # smollm's serving shape
        (3, 1024, 4, 1, 256, 256, None),      # g = 4, MQA, head_dim 256 (gemma3)
        (1, 1000, 16, 1, 128, 128, None),     # g = 16
        (3, 77, 8, 2, 192, 128, None),        # Dk != Dv
        (3, 1000, 9, 3, 128, 128, 300),       # window
        (32, 77, 12, 4, 64, 64, 50),          # window, B = 32
        (2, 100, 4, 2, 40, 40, None),         # rows that are not a multiple of 16 bytes
        (2, 40, 128, 1, 576, 512, None),      # MLA's absorbed decode: g = 128, Dk 576 / Dv 512
    ]
    n = 0
    for dtype in ("float32", "bfloat16", "float16"):
        for B, S, Hq, Hkv, Dk, Dv, window in cases:
            q, k, v = arr((B, Hq, Dk), dtype), arr((B, S, Hkv, Dk), dtype), arr((B, S, Hkv, Dv), dtype)
            lens = lengths(B, S)
            err = rel_err(flash_decode(q, k, v, lens, window=window),
                          ref.decode_attention(q, k, v, lens, window=window))
            if not err <= TOL[dtype]:
                raise AssertionError(f"flash_decode {dtype} B={B} S={S} Hq={Hq} Hkv={Hkv} Dk={Dk} Dv={Dv} "
                                     f"window={window}: rel err {err:.3g}")
            n += 1
    for dtype in ("float32", "bfloat16"):  # inputs 8 bytes off a 16-byte boundary: element-wise staging
        def unaligned(shape):
            flat = arr((int(np.prod(shape)) + 4,), dtype)
            return flat[8 // flat.element_size():][: int(np.prod(shape))].view(shape)

        q, k, v = unaligned((3, 15, 64)), unaligned((3, 300, 5, 64)), unaligned((3, 300, 5, 64))
        lens = lengths(3, 300)
        err = rel_err(flash_decode(q, k, v, lens), ref.decode_attention(q, k, v, lens))
        if not err <= TOL[dtype]:
            raise AssertionError(f"flash_decode misaligned {dtype}: rel err {err:.3g}")
        n += 1
    torch.cuda.synchronize()
    log(f"flash_decode: {n} cases within tolerance")

    recs = {}
    for B in (32, 1):  # the serving decode shape, then one sequence
        S, Hq, Hkv, Dh = CTX, 15, 5, 64
        q, k, v = arr((B, Hq, Dh), "bfloat16"), arr((B, S, Hkv, Dh), "bfloat16"), arr((B, S, Hkv, Dh), "bfloat16")
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
        # every slot is live: K and V read once, q read and o written once
        nb = (k.numel() + v.numel() + 2 * q.numel()) * 2 + lens.numel() * 4
        b_ms, b_by = bound_ms(nb, 2.0 * B * Hq * S * (Dh + Dh), "bfloat16")
        n = input_sets(nb)
        sets = [(q, k, v)] + [tuple(x.clone() for x in (q, k, v)) for _ in range(n - 1)]
        mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]  # (B, 1, 1, S)
        sdpa = [(x[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2)) for x, kk, vv in sets]
        r = {
            "name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/decode_attention.py:122",
            "max_abs_err": float((flash_decode(q, k, v, lens).float()
                                  - ref.decode_attention(q, k, v, lens).float()).abs().max()),
            "ms": timed_ms(lambda i: flash_decode(*sets[i], lens), n),
            "plain_ms": timed_ms(lambda i: ref.decode_attention(*sets[i], lens), n),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timed_ms(
                lambda i: F.scaled_dot_product_attention(*sdpa[i], attn_mask=mask, enable_gqa=True), n),
            "shape": f"q ({B}, {Hq}, {Dh}), k/v ({B}, {S}, {Hkv}, {Dh}) bf16, lengths {S}",
        }
        del sets, sdpa
        log(f"{r['name']}: kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
            f"library_ms={r['library_ms']:.5f} bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
            f"max_abs_err={r['max_abs_err']:.3g} at {r['shape']}")
        recs[B] = r
    return recs[32]


def mlstm_flops(B: int, L: int, H: int, D: int, chunk: int = 128) -> float:
    """FLOPs of the chunkwise mLSTM at the JAX package's chunk of 128: per
    (b, h, chunk of c rows) 2 D for each of q k^T and P V over the chunk's
    c (c + 1) / 2 causal pairs s <= t; 2 c D^2 for q C_in in every chunk after
    the first, and as many for the state update in every chunk before the
    last."""
    full, rest = divmod(L, chunk)
    sizes = [chunk] * full + ([rest] if rest else [])
    per_bh = (sum(2.0 * D * c * (c + 1) for c in sizes)
              + sum(2.0 * c * D * D for c in sizes[1:]) + sum(2.0 * c * D * D for c in sizes[:-1]))
    return B * H * per_bh


def phase_mlstm_kernel() -> dict:
    """chunked_mlstm against its plain version over ragged cases, then timed
    at the serving prefill shape (b = 32, SEQ tokens) and at the decode fill
    (b = 32, CTX - 1 tokens) of xlstm-125m (H 4, D 384)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import chunked_mlstm, ref

    rng = np.random.default_rng(6)
    dev = "cuda"

    def inputs(B, L, H, D, dtype, gates):
        """q, k, v ~ N(0, 1) in ``dtype``; f32 gates: "normal" li ~ N(0, 0.5)
        and lf = logsigmoid(N(0, 1) + 1); "steep" lf = logsigmoid(N(0, 1) - 20),
        about -20; "big" and "big-signed" li ~ U(-10, 10), so the stabilizer
        m reaches ~10.  With "big", q and k are |N(0, 1)|; with "big-signed"
        they keep their signs, and the scores can cancel in the denominator
        down toward its floor exp(-m) ~ e^-10 (see the signed cases below)."""
        q, k, v = (torch.from_numpy(rng.standard_normal((B, L, H, D), dtype=np.float32)).to(dev) for _ in range(3))
        if gates in ("big", "big-signed"):
            if gates == "big":
                q, k = q.abs(), k.abs()
            li = torch.from_numpy(rng.uniform(-10.0, 10.0, (B, L, H)).astype(np.float32)).to(dev)
        else:
            li = 0.5 * torch.from_numpy(rng.standard_normal((B, L, H), dtype=np.float32)).to(dev)
        shift = -20.0 if gates == "steep" else 1.0
        lf = F.logsigmoid(torch.from_numpy(rng.standard_normal((B, L, H), dtype=np.float32)).to(dev) + shift)
        dt = getattr(torch, dtype)
        return q.to(dt), k.to(dt), v.to(dt), li, lf

    cases = [
        # (B, L, H, D, gates)
        (1, 1, 1, 64, "normal"),       # L = 1: a one-token forward without a cache
        (3, 37, 4, 100, "normal"),     # one ragged chunk, D not a multiple of 16
        (1, 128, 4, 384, "normal"),    # xlstm's head dim, two chunks
        (32, 128, 4, 384, "normal"),   # the serving prefill shape
        (3, 300, 1, 64, "normal"),     # ragged last chunk, H = 1
        (32, 1023, 4, 384, "normal"),  # the decode fill at b = 32
        (3, 1024, 4, 100, "normal"),   # many whole chunks
        (32, 1024, 1, 64, "normal"),
        (1, 300, 4, 384, "big"),       # the stabilizer up to ~10
        (3, 1024, 1, 64, "big"),
        (3, 300, 4, 100, "steep"),     # forget gates near -20
        (1, 1024, 4, 384, "steep"),
    ]
    n = 0
    for dtype in ("float32", "bfloat16", "float16"):
        for B, L, H, D, gates in cases:
            args = inputs(B, L, H, D, dtype, gates)
            got = chunked_mlstm(*args)
            want = ref.mlstm_chunked(*args)
            if got.shape != want.shape or got.dtype != want.dtype or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"chunked_mlstm {dtype} B={B} L={L} H={H} D={D} {gates}: "
                                     f"{tuple(got.shape)} {got.dtype} or non-finite values")
            err = rel_err(got, want)
            if not err <= MLSTM_TOL[dtype]:
                raise AssertionError(f"chunked_mlstm {dtype} B={B} L={L} H={H} D={D} {gates}: rel err {err:.3g}")
            n += 1
            del args, got, want
    # Signed q and k with the big input gates.  The denominator's sum of
    # weighted scores cancels, and on some draws the plain f32 version
    # itself strays from an f64 evaluation of the same inputs by more than
    # MLSTM_TOL (the lines below print both errors).  So here the kernel is
    # held against the f64 evaluation, to within twice the plain f32
    # version's own error there, or MLSTM_TOL where that is larger.
    for dtype in ("float32", "bfloat16", "float16"):
        for B, L, H, D in ((1, 300, 4, 384), (3, 1024, 1, 64)):
            args = inputs(B, L, H, D, dtype, "big-signed")
            got, plain = chunked_mlstm(*args), ref.mlstm_chunked(*args)
            exact = ref.mlstm_chunked(*(a.double() for a in args))
            e_kp, e_pe, e_ke = rel_err(got, plain), rel_err(plain, exact), rel_err(got, exact)
            limit = max(MLSTM_TOL[dtype], 2.0 * e_pe)
            log(f"chunked_mlstm {dtype} B={B} L={L} H={H} D={D} big-signed: kernel vs plain rel err {e_kp:.3g}, "
                f"plain vs f64 {e_pe:.3g}, kernel vs f64 {e_ke:.3g} (limit {limit:.3g})")
            if not bool(torch.isfinite(got).all()) or not e_ke <= limit:
                raise AssertionError(f"chunked_mlstm {dtype} B={B} L={L} H={H} D={D} big-signed: "
                                     f"rel err vs f64 {e_ke:.3g} > {limit:.3g} or non-finite values")
            n += 1
            del args, got, plain, exact
    torch.cuda.synchronize()
    log(f"chunked_mlstm: {n} cases within tolerance")

    B, L, H, D = 32, SEQ, 4, 384
    args = inputs(B, L, H, D, "bfloat16", "normal")
    nb = 4 * args[0].numel() * 2 + 2 * args[3].numel() * 4  # q, k, v read, o written; two f32 gates
    b_ms, b_by = bound_ms(nb, mlstm_flops(B, L, H, D), "bfloat16")
    n = input_sets(nb)
    sets = [args] + [tuple(x.clone() for x in args) for _ in range(n - 1)]
    r = {
        "name": "chunked_mlstm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
        "replaces": "src/repro/kernels/mlstm_chunk.py:115",
        "max_abs_err": float((chunked_mlstm(*args).float() - ref.mlstm_chunked(*args).float()).abs().max()),
        "ms": timed_ms(lambda i: chunked_mlstm(*sets[i]), n),
        "plain_ms": timed_ms(lambda i: ref.mlstm_chunked(*sets[i]), n),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,  # no single PyTorch call computes an mLSTM
        "shape": f"q/k/v ({B}, {L}, {H}, {D}) bf16, f32 gates",
    }
    del sets
    log(f"{r['name']}: kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} library_ms=none "
        f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) max_abs_err={r['max_abs_err']:.3g} at {r['shape']}")
    L = CTX - 1
    args = inputs(B, L, H, D, "bfloat16", "normal")
    nb = 4 * args[0].numel() * 2 + 2 * args[3].numel() * 4
    b_ms, b_by = bound_ms(nb, mlstm_flops(B, L, H, D), "bfloat16")
    log(f"chunked_mlstm at the decode fill q/k/v ({B}, {L}, {H}, {D}) bf16: "
        f"kernel_ms={timed_ms(lambda i: chunked_mlstm(*args), 1, reps=2):.5f} "
        f"plain_ms={timed_ms(lambda i: ref.mlstm_chunked(*args), 1, reps=2):.5f} "
        f"bound_ms={b_ms:.5f} ({b_by})")
    del args
    torch.cuda.empty_cache()
    return r


def scan_bytes(B: int, L: int, D: int, N: int, x_bytes: int, p_bytes: int, h0: bool) -> float:
    """Bytes the selective scan must move: x, dt, B, C and A read once, y and
    h_last written once, h0 read once if given."""
    return (B * L * D * (2 * x_bytes + p_bytes) + 2 * B * L * N * p_bytes + D * N * 4
            + B * N * D * 4 * (2 if h0 else 1))


def phase_scan_kernel() -> dict:
    """chunked_selective_scan against its plain version over ragged cases in
    f32 / bf16 / f16 (dt, B and C in f32, as Mamba passes them, and in x's
    type, as the JAX package's kernel test does), one scan split in two with
    the state carried against the whole, then timed at jamba's serving
    prefill shape (b = 32, SEQ tokens, D 8192, N 16) and at its decode fill
    (b = 32, CTX - 1 tokens, h0 read), beside the plain version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import chunked_selective_scan, ref

    gen = torch.Generator(device="cuda").manual_seed(7)
    dev = "cuda"

    def inputs(B, L, D, N, dtype, pdtype, h0):
        """As tests/test_kernels.py draws them: x ~ 0.5 N(0, 1), dt =
        softplus(N(0, 1)), A = -exp(0.3 N(0, 1)), B, C ~ N(0, 1); h0 ~ 0.5
        N(0, 1).  Drawn on the card (the largest cases hold 268M values)."""
        def arr(shape, dt):
            return torch.randn(shape, generator=gen, device=dev).to(dt)

        x = (0.5 * arr((B, L, D), torch.float32)).to(dtype)
        dt = F.softplus(arr((B, L, D), torch.float32)).to(pdtype)
        A = -torch.exp(0.3 * arr((D, N), torch.float32))
        return (x, dt, A, arr((B, L, N), pdtype), arr((B, L, N), pdtype),
                0.5 * arr((B, N, D), torch.float32) if h0 else None)

    def check(label, got, want, tol):
        (y, h), (y_ref, h_ref) = got, want
        if y.shape != y_ref.shape or y.dtype != y_ref.dtype or h.shape != h_ref.shape or h.dtype != torch.float32:
            raise AssertionError(f"chunked_selective_scan {label}: y {tuple(y.shape)} {y.dtype}, "
                                 f"h_last {tuple(h.shape)} {h.dtype}")
        if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())):
            raise AssertionError(f"chunked_selective_scan {label}: non-finite values")
        ey, eh = rel_err(y, y_ref), rel_err(h, h_ref)
        if not (ey <= tol and eh <= tol):
            raise AssertionError(f"chunked_selective_scan {label}: rel err y {ey:.3g}, h_last {eh:.3g} (limit {tol})")

    cases = [
        # (B, L, D, N, h0)
        (1, 1, 64, 16, False),      # L = 1
        (32, 1, 8192, 16, True),    # L = 1 from a state (jamba width)
        (3, 37, 100, 8, True),      # ragged L and D, N 8 (the smoke config's)
        (3, 37, 64, 16, False),
        (1, 128, 8192, 16, False),  # b = 1: the narrowest tiles
        (32, 128, 8192, 16, False), # the serving prefill shape
        (3, 300, 100, 16, True),
        (2, 300, 8192, 16, True),   # the jamba block checks' shape
        (3, 1023, 64, 8, True),
        (1, 1023, 100, 16, False),
        (32, 1023, 8192, 16, True), # the decode fill
    ]
    n = 0
    for dtype in ("float32", "bfloat16", "float16"):
        tdt = getattr(torch, dtype)
        for pdtype in (torch.float32,) if dtype == "float32" else (torch.float32, tdt):
            for B, L, D, N, h0 in cases:
                args = inputs(B, L, D, N, tdt, pdtype, h0)
                check(f"{dtype} (params {str(pdtype)[6:]}) B={B} L={L} D={D} N={N} h0={h0}",
                      chunked_selective_scan(*args), ref.selective_scan(*args), TOL[dtype])
                n += 1
                del args
    # Bm and Cm as column slices of one projection (Mamba's layout), and a
    # scan split at a step that is no multiple of the kernel's 8 with the
    # state carried, against the whole
    x, dt, A, Bm, Cm, _ = inputs(2, 300, 8192, 16, torch.float32, torch.float32, False)
    proj = torch.cat([dt[..., :256], Bm, Cm], dim=-1)
    Bs, Cs = proj[..., 256:272], proj[..., 272:]
    check("f32 strided B, C", chunked_selective_scan(x, dt, A, Bs, Cs), ref.selective_scan(x, dt, A, Bm, Cm),
          TOL["float32"])
    y_all, h_all = chunked_selective_scan(x, dt, A, Bm, Cm)
    x1, dt1, B1, C1 = (t[:, :141].contiguous() for t in (x, dt, Bm, Cm))
    x2, dt2, B2, C2 = (t[:, 141:].contiguous() for t in (x, dt, Bm, Cm))
    y1, h1 = chunked_selective_scan(x1, dt1, A, B1, C1)
    y2, h2 = chunked_selective_scan(x2, dt2, A, B2, C2, h1)
    check("f32 two halves, state carried, vs the whole", (torch.cat([y1, y2], 1), h2), (y_all, h_all),
          TOL["float32"])
    torch.cuda.synchronize()
    log(f"chunked_selective_scan: {n + 2} cases within tolerance")

    def record(B, L, h0):
        D, N = 8192, 16
        args = inputs(B, L, D, N, torch.bfloat16, torch.float32, h0)
        nb = scan_bytes(B, L, D, N, 2, 4, h0)
        b_ms, b_by = bound_ms(nb, 8.0 * B * L * D * N, "float32")
        n_sets = input_sets(nb)
        sets = [args] + [tuple(None if a is None else a.clone() for a in args) for _ in range(n_sets - 1)]
        y, h = chunked_selective_scan(*args)
        y_ref, h_ref = ref.selective_scan(*args)
        return {
            "name": "chunked_selective_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:86",
            "max_abs_err": max(float((y.float() - y_ref.float()).abs().max()), float((h - h_ref).abs().max())),
            "ms": timed_ms(lambda i: chunked_selective_scan(*sets[i]), n_sets),
            "plain_ms": timed_ms(lambda i: ref.selective_scan(*sets[i]), n_sets, reps=2),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,  # no single PyTorch call computes a selective scan
            "shape": f"x ({B}, {L}, {D}) bf16, dt/B/C f32, N {N}{', h0' if h0 else ''}",
            "exp_count": B * L * D * N,
        }

    recs = [record(32, SEQ, False), record(1, SEQ, False), record(32, CTX - 1, True)]
    for r in recs:
        log(f"{r['name']}: kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} library_ms=none "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}; {r.pop('exp_count') / 1e6:.1f}M exponentials) "
            f"max_abs_err={r['max_abs_err']:.3g} at {r['shape']}")
    torch.cuda.empty_cache()
    return recs[0]


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


# ----------------------------------------------------------------- phase 3b
def cached_decode_errs(model, toks, n_prefill: int, max_seq: int):
    """Prefill ``n_prefill`` tokens into a fresh cache, decode the rest one
    by one; the rel err of each step's logits against the uncached forward
    at the same position, and the first step's logits."""
    import torch

    full = model(toks).logits
    cache = model.init_cache(toks.shape[0], max_seq)
    model(toks[:, :n_prefill], cache=cache, idx=0, compute_logits=False)
    errs, first = [], None
    for i in range(n_prefill, toks.shape[1]):
        out = model(toks[:, i:i + 1], cache=cache, idx=i)
        got = out.logits[:, 0]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{model.cfg.name}: non-finite decode logits at position {i}")
        errs.append(rel_err(got, full[:, i]))
        first = got if first is None else first
    return errs, first


def phase_cached_decode(m16) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config(ARCH)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 36))).cuda()
    m32 = Model(cfg32, seed=0, device="cuda")
    errs, first = cached_decode_errs(m32, toks, 32, 64)
    log(f"cached decode {ARCH} f32: prefill 32 into 64 slots, 4 steps vs uncached forward "
        f"rel err {max(errs):.3g} (limit {DECODE_TOL_F32})")
    if not max(errs) <= DECODE_TOL_F32:
        raise AssertionError(f"{ARCH} f32 cached decode rel err {errs}")
    errs16, _ = cached_decode_errs(m16, toks, 32, 64)
    log(f"cached decode {ARCH} bf16: 4 steps vs the uncached bf16 forward rel err {max(errs16):.3g} "
        f"(limit {MODEL_TOL_BF16})")
    if not max(errs16) <= MODEL_TOL_BF16:
        raise AssertionError(f"{ARCH} bf16 cached decode rel err {errs16}")
    m32.to("cpu")  # the same weights through the plain path
    cache = m32.init_cache(2, 64)
    m32(toks[:, :32].cpu(), cache=cache, idx=0, compute_logits=False)
    want = m32(toks[:, 32:33].cpu(), cache=cache, idx=32).logits[:, 0]
    e = rel_err(first.cpu(), want)
    log(f"cached decode {ARCH} f32 first step: card vs CPU plain rel err {e:.3g} (limit {MODEL_TOL_F32})")
    if not e <= MODEL_TOL_F32:
        raise AssertionError(f"{ARCH} f32 first decode step, card vs CPU: rel err {e:.3g}")
    del m32, cache

    g = get_config("gemma3-1b").replace(param_dtype="float32", compute_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, g.vocab_size, (1, 604))).cuda()
    mg = Model(g, seed=0, device="cuda")
    errs, _ = cached_decode_errs(mg, toks, 600, 604)  # local rings of 512 slots wrap by 600 % 512 = 88
    log(f"cached decode gemma3-1b f32: prefill 600 (512-slot rings wrapped by 88), 4 steps vs uncached "
        f"forward rel err {max(errs):.3g} (limit {DECODE_TOL_F32})")
    if not max(errs) <= DECODE_TOL_F32:
        raise AssertionError(f"gemma3-1b f32 cached decode rel err {errs}")
    del mg
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 3c
def phase_xlstm_model():
    """xlstm-125m at full width: f32 logits on the card against the CPU plain
    path at (2, XLSTM_SEQ) tokens; f32 prefill of XLSTM_SEQ tokens into its
    recurrent cache and 4 decode steps, each against the uncached forward;
    and the bf16 path block by block: each block in bf16 on the card, fed the
    f32 reference's input to that block, against the f32 block on the CPU.

    The whole bf16 model is not held to MODEL_TOL_BF16: rounding the same
    weights to bf16 moves xlstm's logits far from the f32 ones, because the
    exponential gates amplify the rounding from block to block, and `repro`
    moves as far.  Its logits must be finite, and their distance from the
    f32 reference must stay within XLSTM_BF16_FACTOR of `repro`'s own at
    full width (XLSTM_BF16_REPRO).  Returns the bf16 model."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model, layers
    from repro_torch.models.model import _block_apply

    cfg = get_config(XLSTM)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, XLSTM_SEQ + 4))).cuda()
    m32 = Model(cfg32, seed=0, device="cuda")
    logits32 = m32(toks[:, :XLSTM_SEQ]).logits
    errs, _ = cached_decode_errs(m32, toks, XLSTM_SEQ, XLSTM_SEQ + 4)
    m16 = Model(cfg, seed=0, device="cuda")
    m16.load_state_dict(m32.state_dict())  # the same weights, rounded to bf16
    logits16 = m16(toks[:, :XLSTM_SEQ]).logits
    m32.to("cpu")
    cpu_toks = toks[:, :XLSTM_SEQ].cpu()
    want = m32(cpu_toks).logits
    for name, got in (("f32", logits32), ("bf16", logits16)):
        if got.shape != (2, XLSTM_SEQ, cfg.vocab_size) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{XLSTM} {name} logits: shape {tuple(got.shape)} or non-finite values")
    x = layers.embed(m32.embed, cfg32, cpu_toks, torch.float32)
    pos = torch.arange(XLSTM_SEQ)[None].expand(2, XLSTM_SEQ)
    block_errs = []
    for spec, b32, b16 in zip(m32.specs, m32.layers, m16.layers):
        y, _ = _block_apply(b32, cfg32, spec, x, pos)
        y16, _ = _block_apply(b16, cfg, spec, x.to(torch.bfloat16).cuda(), pos.cuda())
        block_errs.append(rel_err(y16.cpu(), y))
        x = y
    e32, e16 = rel_err(logits32.cpu(), want), rel_err(logits16.cpu(), want)
    bf16_limit = XLSTM_BF16_FACTOR * XLSTM_BF16_REPRO
    log(f"model {XLSTM} full width (2, {XLSTM_SEQ}) tokens: card f32 vs CPU plain rel err {e32:.3g} "
        f"(limit {MODEL_TOL_F32}); bf16 blocks on the card vs f32 blocks on the CPU, same inputs: rel err "
        f"{' '.join(f'{e:.3g}' for e in block_errs)} (limit {MODEL_TOL_BF16}); whole bf16 model vs CPU f32 "
        f"rel err {e16:.6g} (limit {bf16_limit:.6g}: {XLSTM_BF16_FACTOR} x repro's own {XLSTM_BF16_REPRO})")
    log(f"cached decode {XLSTM} f32: prefill {XLSTM_SEQ} into the recurrent cache, 4 steps vs uncached "
        f"forward rel err {max(errs):.3g} (limit {DECODE_TOL_F32})")
    if not e32 <= MODEL_TOL_F32:
        raise AssertionError(f"{XLSTM} f32 logits rel err {e32:.3g} > {MODEL_TOL_F32}")
    if not max(block_errs) <= MODEL_TOL_BF16:
        raise AssertionError(f"{XLSTM} bf16 blocks rel err {block_errs} > {MODEL_TOL_BF16}")
    if not e16 <= bf16_limit:
        raise AssertionError(f"{XLSTM} whole bf16 model rel err {e16:.6g} > {bf16_limit:.6g}")
    if not max(errs) <= DECODE_TOL_F32:
        raise AssertionError(f"{XLSTM} f32 cached decode rel err {errs}")
    del m32, logits32, logits16
    torch.cuda.empty_cache()
    return m16


# ----------------------------------------------------------------- phase 3d
def jamba_config(n_layers: int, dtype: str):
    """jamba-v0.1-52b at its published widths, cut to ``n_layers`` (whole
    8-layer macro-blocks, so every layer kind keeps its published order)."""
    from repro_torch.configs import get_config

    return get_config(JAMBA).replace(n_layers=n_layers, param_dtype=dtype, compute_dtype=dtype)


def with_routes(fn, replay=None):
    """``fn()``'s result and, for each MoE layer in call order, the expert
    ids it took and its router probabilities.  With ``replay`` (such a list
    from another run) each layer takes its ids from it instead of its own
    top-k, and its gates from its own probabilities at those ids (its aux
    loss stays its own): the same expert choices, computed in this run's
    precision.  `moe.route` is wrapped for the call."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.layers import dense

    seen, route, given = [], moe.route, iter(replay or ())

    def recording(p, cfg, x):
        ids, gates, aux = route(p, cfg, x)
        probs = torch.softmax(dense(p["router"], x).float()[..., :cfg.n_experts], dim=-1)
        if replay is not None:
            ids = next(given)[0].to(x.device)
            gates = probs.gather(-1, ids)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        seen.append((ids, probs))
        return ids, gates, aux

    moe.route = recording
    try:
        return fn(), seen
    finally:
        moe.route = route


def rerouted(routes_a, routes_b) -> int:
    """Tokens whose set of experts differs, summed over the MoE layers."""
    return sum(int((ia.sort(-1).values.cpu() != ib.sort(-1).values.cpu()).any(-1).sum())
               for (ia, _), (ib, _) in zip(routes_a, routes_b))


def tie_ratio(routes_16, routes_32, k: int) -> float:
    """The largest, over the tokens that bf16 routed to another expert set
    than f32, of that token's f32 top-k margin (its k-th minus its (k+1)-th
    probability) over twice the layer's largest change of any router
    probability between the two runs.  A set can change only where the
    margin is at most that (an expert leaves it and another joins only if
    each moves toward the other by the margin between them), so a ratio
    above 1 is a routing fault, not rounding; 0 when nothing moved."""
    worst = 0.0
    for (i16, p16), (i32, p32) in zip(routes_16, routes_32):
        i16, p16, i32, p32 = (t.cpu() for t in (i16, p16, i32, p32))
        moved = (i16.sort(-1).values != i32.sort(-1).values).any(-1)
        if bool(moved.any()):
            top = p32.topk(k + 1, dim=-1).values
            margin = top[:, k - 1] - top[:, k]
            worst = max(worst, float(margin[moved].max() / (2 * (p16 - p32).abs().max())))
    return worst


def phase_jamba_blocks() -> None:
    """Each jamba block kind at full width (Mamba + dense MLP, Mamba + MoE,
    attention + dense MLP), fed one (2, JAMBA_SEQ) input drawn with numpy:
    the f32 block on the card against the same weights on the CPU's plain
    path, and the same weights in bf16 on the card against that f32 CPU
    block.  The weights are made on the card from a seed and moved to the
    host (the MoE block's f32 experts are 11.3 GB).

    bf16 rounding sends a few tokens of the MoE block to another expert
    pair, where two of the router's probabilities are within rounding of
    each other: top-2 routing is not continuous there, in `repro` too, and
    no tolerance holds across the jump.  So the bf16 MoE block is held at
    MODEL_TOL_BF16 against the f32 CPU block given the bf16 run's expert
    choices, and every token it moved must be such a near-tie (`tie_ratio`
    at most 1).  Its distance from the f32 block's own choices is printed."""
    import numpy as np
    import torch

    from repro_torch.models.model import _block_apply, _block_init

    cfg32, cfg16 = jamba_config(JAMBA_CHECK_LAYERS, "float32"), jamba_config(JAMBA_CHECK_LAYERS, "bfloat16")
    specs = cfg32.layer_specs()
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, JAMBA_SEQ, cfg32.d_model), dtype=np.float32))
    pos = torch.arange(JAMBA_SEQ)[None].expand(2, JAMBA_SEQ)
    for spec in (specs[0], specs[1], specs[4]):
        name = f"{spec.mixer} + {spec.ffn}"
        b32 = _block_init(torch.Generator(device="cuda").manual_seed(0), cfg32, spec, torch.float32)
        b16 = _block_init(torch.Generator(device="cuda").manual_seed(0), cfg16, spec, torch.bfloat16)
        b16.load_state_dict(b32.state_dict())  # the same weights, rounded to bf16 (A_log and D stay f32)
        (y32, a32), r32 = with_routes(lambda: _block_apply(b32, cfg32, spec, x.cuda(), pos.cuda()))
        (y16, _), r16 = with_routes(lambda: _block_apply(b16, cfg16, spec, x.cuda().bfloat16(), pos.cuda()))
        del b16
        torch.cuda.empty_cache()
        b32.to("cpu")
        (want, a_cpu), r_cpu = with_routes(lambda: _block_apply(b32, cfg32, spec, x, pos))
        for label, got in (("f32", y32), ("bf16", y16)):
            if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{JAMBA} {name} {label} block: shape {tuple(got.shape)} or non-finite values")
        e32, e16 = rel_err(y32.cpu(), want), rel_err(y16.cpu(), want)
        extra, ratio = "", 0.0
        if spec.ffn == "moe":
            (matched, _), _ = with_routes(lambda: _block_apply(b32, cfg32, spec, x, pos), replay=r16)
            e16_own, e16 = e16, rel_err(y16.cpu(), matched)
            ratio = tie_ratio(r16, r_cpu, cfg32.top_k)
            extra = (f"; aux card {float(a32):.6f} CPU {float(a_cpu):.6f}; tokens routed to another expert pair: "
                     f"f32 card {rerouted(r32, r_cpu)}, bf16 card {rerouted(r16, r_cpu)} of {2 * JAMBA_SEQ} "
                     f"(largest f32 margin over twice the bf16 change {ratio:.3g}, limit 1); bf16 vs the f32 "
                     f"block on its own expert choices rel err {e16_own:.3g}, printed only")
        del b32
        log(f"{JAMBA} {name} block, full width, (2, {JAMBA_SEQ}) tokens: card f32 vs CPU plain rel err "
            f"{e32:.3g} (limit {MODEL_TOL_F32}); card bf16 vs CPU f32 rel err {e16:.3g} (limit {MODEL_TOL_BF16}"
            f"{', on the bf16 expert choices' if spec.ffn == 'moe' else ''})" + extra)
        if not e32 <= MODEL_TOL_F32:
            raise AssertionError(f"{JAMBA} {name} f32 block rel err {e32:.3g} > {MODEL_TOL_F32}")
        if not e16 <= MODEL_TOL_BF16:
            raise AssertionError(f"{JAMBA} {name} bf16 block rel err {e16:.3g} > {MODEL_TOL_BF16}")
        if not ratio <= 1.0:
            raise AssertionError(f"{JAMBA} {name} bf16 block moved a token that was no near-tie: ratio {ratio:.3g}")
        del y32, y16, want
    torch.cuda.empty_cache()


def phase_jamba_model() -> None:
    """The one-macro-block cut of jamba (JAMBA_CHECK_LAYERS layers) at full
    width from seed 0: in f32 (53.2 GB) its cached decode, prefill of
    JAMBA_SEQ tokens then 4 steps, each against the uncached forward; then
    the same weights in bf16 (built anew from the seed once the f32 model
    is freed: both do not fit) against the f32 logits.

    The whole bf16 model is not held to MODEL_TOL_BF16: over its 4 MoE
    layers bf16 rounding moves a few percent of the tokens to other experts
    (each a near-tie, checked with `tie_ratio`), and the attention and the
    Mamba recurrence carry those tokens' change to later ones; `repro`
    moves as far.  Its logits must be finite, and their distance from the
    f32 logits must stay within JAMBA_BF16_FACTOR of `repro`'s own at the
    same config (JAMBA_BF16_REPRO).  Given the bf16 run's expert choices
    (the f32 model built a second time), the f32 model must come within
    MODEL_TOL_BF16 of the bf16 logits."""
    import numpy as np
    import torch

    from repro_torch.models import Model

    cfg32, cfg16 = jamba_config(JAMBA_CHECK_LAYERS, "float32"), jamba_config(JAMBA_CHECK_LAYERS, "bfloat16")
    toks = torch.from_numpy(np.random.default_rng(10).integers(0, cfg32.vocab_size, (2, JAMBA_SEQ + 4))).cuda()
    m32 = Model(cfg32, seed=0, device="cuda")
    out32, r32 = with_routes(lambda: m32(toks[:, :JAMBA_SEQ]))
    errs, _ = cached_decode_errs(m32, toks, JAMBA_SEQ, JAMBA_SEQ + 4)
    del m32
    torch.cuda.empty_cache()
    m16 = Model(cfg16, seed=0, device="cuda")
    out16, r16 = with_routes(lambda: m16(toks[:, :JAMBA_SEQ]))
    del m16
    torch.cuda.empty_cache()
    m32 = Model(cfg32, seed=0, device="cuda")
    matched, _ = with_routes(lambda: m32(toks[:, :JAMBA_SEQ]), replay=r16)
    del m32
    torch.cuda.empty_cache()
    for label, out in (("f32", out32), ("bf16", out16)):
        if out.logits.shape != (2, JAMBA_SEQ, cfg32.vocab_size) or not bool(torch.isfinite(out.logits).all()):
            raise AssertionError(f"{JAMBA} {label} logits: shape {tuple(out.logits.shape)} or non-finite values")
    e16, e_matched = rel_err(out16.logits, out32.logits), rel_err(out16.logits, matched.logits)
    ratio = tie_ratio(r16, r32, cfg32.top_k)
    bf16_limit = JAMBA_BF16_FACTOR * JAMBA_BF16_REPRO
    log(f"cached decode {JAMBA} {JAMBA_CHECK_LAYERS} layers f32: prefill {JAMBA_SEQ}, 4 steps vs uncached forward "
        f"rel err {max(errs):.3g} (limit {DECODE_TOL_F32})")
    log(f"model {JAMBA} {JAMBA_CHECK_LAYERS} layers, full width, (2, {JAMBA_SEQ}) tokens: bf16 vs f32 on the card "
        f"rel err {e16:.6g} (limit {bf16_limit:.6g}: {JAMBA_BF16_FACTOR} x repro's own {JAMBA_BF16_REPRO}); tokens "
        f"routed to another expert pair in bf16 {rerouted(r16, r32)} of {len(r32)} x {2 * JAMBA_SEQ} (largest f32 "
        f"margin over twice the bf16 change {ratio:.3g}, limit 1); bf16 vs f32 on the bf16 expert choices rel err "
        f"{e_matched:.6g} (limit {MODEL_TOL_BF16}); aux f32 {float(out32.aux_loss):.6f} "
        f"bf16 {float(out16.aux_loss):.6f}")
    if not max(errs) <= DECODE_TOL_F32:
        raise AssertionError(f"{JAMBA} f32 cached decode rel err {errs}")
    if not e16 <= bf16_limit:
        raise AssertionError(f"{JAMBA} whole bf16 model rel err {e16:.6g} > {bf16_limit:.6g}")
    if not e_matched <= MODEL_TOL_BF16:
        raise AssertionError(f"{JAMBA} whole bf16 model on its own expert choices rel err {e_matched:.6g} "
                             f"> {MODEL_TOL_BF16}")
    if not ratio <= 1.0:
        raise AssertionError(f"{JAMBA} bf16 model moved a token that was no near-tie: ratio {ratio:.3g}")


def jamba_serving_model():
    """The serving cut of jamba (JAMBA_SERVE_LAYERS layers, bf16, seed 0)."""
    import torch

    from repro_torch.models import Model
    from repro_torch.profiling import param_count

    cfg = jamba_config(JAMBA_SERVE_LAYERS, "bfloat16")
    model = Model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"{JAMBA} serving cut: {cfg.n_layers} of 32 layers, {param_count(cfg) / 1e9:.3f}B parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card")
    return model


# ------------------------------------------------------------------ phase 4
def forward_breakdown(executor, batch: int, label: str, top: int = 8) -> None:
    """Device time by kernel over one executor call (a forward or a decode
    step), from torch.profiler, and the share of its wall time the device
    was busy."""
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
    log(f"{label} b={batch}: wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / (wall * 1e3):.1f}%), {sum(n for _, n in by_name.values())} kernels")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {ms:9.3f} ms {n:5d}x  {name[:90]}")


def phase_serve(model, arch: str, mode: str) -> dict[str, int]:
    """Profile ``arch``'s ``mode`` step ("prefill": a forward on SEQ tokens,
    "decode": one step against CTX cached tokens), plan from that profile,
    serve N_REQUESTS, and return the launch counts of the serving run.  The
    analytic profile beside it is of the model's own config (jamba's depth
    cut, not the full 32 layers)."""
    from repro_torch.core import Leaf, Planner, Workload, series
    from repro_torch.core.dag import AppDAG
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.launch.serve import profile_model
    from repro_torch.profiling import H100_SXM, module_duration
    from repro_torch.serving import ServingEngine

    cfg = model.cfg
    seq = SEQ if mode == "prefill" else CTX
    profile, executor = profile_model(arch, batches=BATCHES, seq=SEQ, model=model, mode=mode, ctx=CTX)
    label = f"forward seq={SEQ}" if mode == "prefill" else f"decode step ctx={CTX}"
    forward_breakdown(executor, max(BATCHES), f"{arch} {label}")
    for c in sorted(profile.configs, key=lambda c: c.batch):
        analytic = module_duration(cfg, c.batch, seq, H100_SXM, mode=mode)
        log(f"{arch} {mode} profile b={c.batch}: measured {c.duration * 1e3:.3f} ms, analytic-h100 "
            f"{analytic * 1e3:.3f} ms, ratio {c.duration / analytic:.3f}")
    big = max(profile.configs, key=lambda c: c.batch)
    rate = 0.5 * big.batch / big.duration          # half one card's throughput
    slo = 2.0 * (big.batch / rate + big.duration)  # room to collect and run a full batch
    wl = Workload(AppDAG(arch, series(Leaf(arch))), {arch: rate}, slo)
    plan = Planner().plan(wl, {arch: profile})
    log(plan.summary())
    if not plan.feasible:
        raise AssertionError("plan infeasible on the measured profile")
    engine = ServingEngine(plan, executors={arch: executor})
    reset_launch_counts()
    res = engine.run(N_REQUESTS, rate)
    launches = {k.__name__: k.launches for k in KERNELS}
    st = res.module_stats[arch]
    log(f"{arch} {mode}: served {len(res.e2e_latencies)}/{N_REQUESTS} requests at {rate:.1f}/s: attainment "
        f"{res.attainment:.4f} p99 {res.p99 * 1e3:.3f} ms (slo {slo * 1e3:.3f} ms) "
        f"batches {st.batches}; launches while serving {launches}")
    if len(res.e2e_latencies) != N_REQUESTS:
        raise AssertionError(f"{len(res.e2e_latencies)} of {N_REQUESTS} requests completed")
    idle = [name for name in PATH_KERNELS[arch, mode] if launches[name] <= 0]
    if idle:
        raise AssertionError(f"{arch} {mode} path: kernels not launched while serving: {idle}")
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
    kernels = phase_kernels() + [phase_decode_kernel(), phase_mlstm_kernel(), phase_scan_kernel()]
    model = phase_model()
    phase_cached_decode(model)
    xmodel = phase_xlstm_model()
    phase_jamba_blocks()
    phase_jamba_model()
    by_path = {}
    for arch, m in ((ARCH, model), (XLSTM, xmodel)):
        for mode in ("prefill", "decode"):
            by_path[f"{arch} {mode}"] = phase_serve(m, arch, mode)
    del model, xmodel, m
    jmodel = jamba_serving_model()
    for mode in ("prefill", "decode"):
        by_path[f"{JAMBA} {mode}"] = phase_serve(jmodel, JAMBA, mode)
    del jmodel
    torch.cuda.empty_cache()
    for k in kernels:
        k["launches_by_path"] = {path: n[k["name"]] for path, n in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        del k["shape"]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
