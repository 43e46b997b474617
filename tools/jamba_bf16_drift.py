"""How far the JAX package's own jamba-v0.1-52b moves when its weights are rounded to bf16.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jamba_bf16_drift.py [--seeds 0 1 2] [--layers 8] [--seq 300]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jamba_bf16_drift.py --smoke   # a quick check

For each seed it fills `repro`'s jamba-v0.1-52b parameter tree, at its
published widths cut to ``--layers`` layers (8: one macro-block, the cut
that ``chip_smoke.py`` checks in f32 and bf16), with numpy draws at the
scales of `Model.init` (dense and expert weights N(0, 1 / d_in), the conv
taps N(0, 0.1^2), the embedding N(0, 0.02^2), biases 0, norm scales 1,
A_log = log(1 .. N), D = 1), one leaf at a time.  It takes the f32 logits
of (2, seq) tokens drawn as ``chip_smoke.py``'s jamba model phase draws
them, rounds the same weights to bf16 one leaf at a time (A_log and D stay
f32, as in `Model.init` and the port), takes the bf16 logits, and prints
the relative error max|l_bf16 - l_f32| / max|l_f32|.  ``chip_smoke.py``
holds the port's whole-model bf16 distance on the card against this reading
(``JAMBA_BF16_REPRO`` there).  Runs on the CPU; at full width the f32
weights are 53.2 GB and the peak about one leaf more (it prints its peak),
so run it where memory is plentiful.
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

ARCH = "jamba-v0.1-52b"
F32_LEAVES = ("A_log", "D")  # f32 in a bf16 model too


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def numpy_params(model: Model, seed: int):
    """``model``'s parameter tree (f32) drawn with numpy at the scales of
    `Model.init`, one leaf at a time."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.key(0))

    def leaf(path, s):
        names = [getattr(p, "key", None) for p in path]
        if names[-1] == "A_log":
            return jnp.asarray(np.broadcast_to(np.log(np.arange(1, s.shape[-1] + 1, dtype=np.float32)), s.shape))
        if names[-1] in ("b", "conv_b"):
            return jnp.zeros(s.shape, jnp.float32)
        if names[-1] == "D" or {"mix_norm", "ffn_norm", "final_norm"} & set(names):
            return jnp.ones(s.shape, jnp.float32)
        a = rng.standard_normal(s.shape, dtype=np.float32)
        a *= 0.1 if names[-1] == "conv_w" else 0.02 if "embed" in names else s.shape[-2] ** -0.5
        return jnp.asarray(a)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def to_bf16(leaves: list, treedef):
    """The tree of ``leaves`` (from `tree_flatten_with_path`) rounded to bf16
    (but A_log and D), emptying ``leaves`` so that each f32 leaf is freed as
    its bf16 copy is made."""
    out = []
    while leaves:
        path, a = leaves.pop(0)
        out.append(a if path[-1].key in F32_LEAVES else a.astype(jnp.bfloat16))
        del a
    return jax.tree_util.tree_unflatten(treedef, out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--layers", type=int, default=8, help="depth cut, in whole 8-layer macro-blocks")
    ap.add_argument("--seq", type=int, default=300)
    ap.add_argument("--smoke", action="store_true", help="the smoke config (8 layers) instead of full width")
    args = ap.parse_args()

    cfg = SMOKE_ARCHS[ARCH] if args.smoke else get_config(ARCH).replace(n_layers=args.layers)
    models = {dt: Model(cfg.replace(param_dtype=dt, compute_dtype=dt)) for dt in ("float32", "bfloat16")}
    logits = {dt: jax.jit(lambda p, x, m=m: m.forward(p, x).logits.astype(jnp.float32)) for dt, m in models.items()}
    # chip_smoke.py's jamba tokens: rng 10, (2, JAMBA_SEQ + 4), the first JAMBA_SEQ of them
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, args.seq + 4))[:, : args.seq]
    toks = jnp.asarray(toks.astype(np.int32))
    errs = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        params = numpy_params(models["float32"], seed)
        l32 = np.asarray(logits["float32"](params, toks))
        leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
        del params
        params = to_bf16(leaves, treedef)
        l16 = np.asarray(logits["bfloat16"](params, toks))
        del params
        errs.append(rel_err(l16, l32))
        print(f"{cfg.name} {'smoke' if args.smoke else f'full width, {cfg.n_layers} layers'} seed {seed} "
              f"tokens {tuple(toks.shape)}: bf16 vs f32 logits rel err {errs[-1]:.6g} "
              f"(bf16 finite: {bool(np.isfinite(l16).all())}) in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"{ARCH}: bf16 vs f32 rel err over seeds {args.seeds}: min {min(errs):.6g} max {max(errs):.6g}; "
          f"peak resident {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")


if __name__ == "__main__":
    main()
