"""The selective-scan kernel built with each register cap, timed side by side on the card.

    python3 tools/scan_launch_bounds.py [--caps 1 2 3 4]

Builds a copy of ``src/repro_torch/kernels/csrc/ssm_scan.cu`` for each
value of its ``kBlocksPerSM`` (the ``__launch_bounds__`` minimum of
resident 128-thread blocks: 4, the committed value, caps registers at 128 a
thread; 1 leaves the compiler its choice), prints what ptxas reports
(registers and spills of each instantiation), prints how far each build's
output is from the committed build's (0 expected: the arithmetic is the
same), and times each with ``chip_smoke.py``'s
``timed_ms`` (CUDA-graph replay, inputs cold in L2) at jamba's shapes: the
serving prefill (b = 32 and b = 1, 128 tokens), b = 4, and the decode fill
(b = 32, 1023 tokens, h0 read).  The builds run in the order given and then
in reverse, and both times print.  Needs the card and nvcc; the libraries go
to ``build/repro_torch/scan_caps/``.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ssm_scan  # noqa: E402

SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "ssm_scan.cu"
OUT = _build.BUILD_DIR / "scan_caps"
CAP_LINE = "constexpr int kBlocksPerSM = 4;"


def build(cap: int) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    if text.count(CAP_LINE) != 1:
        raise RuntimeError(f"{SRC} no longer declares `{CAP_LINE}`")
    src, lib_path = OUT / f"ssm_scan_cap{cap}.cu", OUT / f"ssm_scan_cap{cap}.so"
    src.write_text(text.replace(CAP_LINE, f"constexpr int kBlocksPerSM = {cap};"))
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib_path), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    report = [line.split(":", 1)[-1].strip() for line in proc.stderr.splitlines()
              if "Used" in line or "spill" in line or "Compiling entry" in line]
    print(f"cap {cap}: " + " | ".join(r.replace("Compiling entry function", "") for r in report), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.selective_scan_fwd.argtypes = [p] * 8 + [i] * 6 + [ll] * 4 + [p]
    lib.selective_scan_fwd.restype = ctypes.c_int
    return lib


def inputs(B: int, L: int, h0: bool, D: int = 8192, N: int = 16):
    """jamba's Mamba inputs: x bf16, dt = softplus(N(0, 1)), A = -(1 .. N), B, C ~ N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (0.5 * torch.randn((B, L, D), device="cuda", generator=g)).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn((B, L, D), device="cuda", generator=g))
    A = -torch.arange(1, N + 1, device="cuda", dtype=torch.float32).repeat(D, 1)
    Bm, Cm = (torch.randn((B, L, N), device="cuda", generator=g) for _ in range(2))
    return x, dt, A, Bm, Cm, torch.randn((B, N, D), device="cuda", generator=g) if h0 else None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--caps", type=int, nargs="+", default=[1, 2, 3, 4])
    args = ap.parse_args()
    libs = {cap: build(cap) for cap in args.caps}
    default = ssm_scan._lib()
    for B, L, h0 in ((32, 128, False), (1, 128, False), (4, 128, False), (32, 1023, True)):
        a = inputs(B, L, h0)
        sets = [a, tuple(None if t is None else t.clone() for t in a)]
        y_ref, h_ref = ssm_scan.chunked_selective_scan(*a)
        times: dict[int, list[float]] = {}
        diffs: dict[int, float] = {}
        for cap in [*args.caps, *reversed(args.caps)]:
            ssm_scan._lib = lambda lib=libs[cap]: lib
            y, h = ssm_scan.chunked_selective_scan(*a)
            diffs[cap] = max(float((y.float() - y_ref.float()).abs().max()), float((h - h_ref).abs().max()))
            times.setdefault(cap, []).append(
                chip_smoke.timed_ms(lambda i: ssm_scan.chunked_selective_scan(*sets[i]), 2))
        ssm_scan._lib = lambda: default
        print(f"x ({B}, {L}, 8192) bf16{', h0' if h0 else ''}: " + "; ".join(
            f"cap {cap} {' / '.join(f'{t:.5f}' for t in ts)} ms (max |diff| {diffs[cap]:.3g})"
            for cap, ts in times.items()), flush=True)
        del a, sets
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
