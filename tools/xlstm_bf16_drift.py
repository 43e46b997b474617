"""How far the JAX package's own xlstm-125m moves when its weights are rounded to bf16.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xlstm_bf16_drift.py [--seeds 0 1 2] [--seq 300]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xlstm_bf16_drift.py --smoke   # a quick check

For each seed it initialises `repro`'s xlstm-125m at full width (12 layers,
d 768, vocab 50304) with ``Model.init(jax.random.key(seed))``, rounds the
same weights to bf16, runs both on (2, seq) tokens drawn as
``chip_smoke.py``'s xlstm phase draws them, and prints the relative error
max|l_bf16 - l_f32| / max|l_f32| of the logits.  ``chip_smoke.py`` holds the
port's whole-model bf16 distance on the card against this reading
(``XLSTM_BF16_REPRO`` there).  Runs on the CPU; at full width it peaks at
about 7 GiB resident (it prints its peak).
"""
from __future__ import annotations

import argparse
import resource
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import SMOKE_ARCHS, get_config
from repro.models import Model

ARCH = "xlstm-125m"


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--seq", type=int, default=300)
    ap.add_argument("--smoke", action="store_true", help="the smoke config instead of full width")
    args = ap.parse_args()

    cfg = SMOKE_ARCHS[ARCH] if args.smoke else get_config(ARCH)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    cfg16 = cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    m32, m16 = Model(cfg32), Model(cfg16)
    init = jax.jit(m32.init)
    logits32 = jax.jit(lambda p, x: m32.forward(p, x).logits)
    logits16 = jax.jit(lambda p, x: m16.forward(p, x).logits.astype(jnp.float32))
    # chip_smoke.py's xlstm tokens: rng 4, (2, XLSTM_SEQ + 4), the first XLSTM_SEQ of them
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, args.seq + 4))[:, : args.seq]
    toks = jnp.asarray(toks.astype(np.int32))
    errs = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        p32 = init(jax.random.key(seed))
        p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if jnp.issubdtype(a.dtype, jnp.floating) else a, p32)
        l32, l16 = logits32(p32, toks), logits16(p16, toks)
        finite = bool(jnp.isfinite(l16).all())
        errs.append(rel_err(l16, l32))
        print(f"{cfg.name} {'smoke' if args.smoke else 'full width'} seed {seed} tokens {tuple(toks.shape)}: "
              f"bf16 vs f32 logits rel err {errs[-1]:.6g} (bf16 finite: {finite}) "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"{ARCH}: bf16 vs f32 rel err over seeds {args.seeds}: min {min(errs):.6g} max {max(errs):.6g}; "
          f"peak resident {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")


if __name__ == "__main__":
    main()
