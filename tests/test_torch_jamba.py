"""The port's jamba path vs `repro` on the CPU: the selective-scan oracle,
the Mamba block with and without a cache, MoE routing and the local expert
FFN (jamba's and qwen2-moe's smoke configs, the latter with shared
experts), the jamba smoke model's logits and aux loss, cached prefill +
decode, the cache bridge and the serving profiles, fed the same numpy
inputs and parameters.

The scan is held against `repro.kernels.ref.selective_scan`, not against
the Pallas kernel: under this jax (0.9.0) `pl.store` is gone
(`src/repro/kernels/ssm_scan.py:53`), so the Pallas scan does not run even
in interpret mode.  On CPU tensors `chunked_selective_scan` runs its plain
version; the kernel itself is held against that on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SMOKE_ARCHS as JSMOKE  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import Model as JModel, moe as JMoe, ssm as JSsm  # noqa: E402
from repro_torch.configs import SMOKE_ARCHS  # noqa: E402
from repro_torch.kernels import chunked_selective_scan, ops, ref, reset_launch_counts  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model, load_jax_cache, load_jax_params, moe, ssm  # noqa: E402

ARCH = "jamba-v0.1-52b"
QWEN = "qwen2-moe-a2.7b"
F32_TOL = 2e-5     # per op, as tests/test_kernels.py
BF16_TOL = 2e-2
BLOCK_TOL = 1e-4   # one Mamba block: several GEMMs and the scan in a row
MODEL_TOL = 1e-4   # whole forward: GEMM summation order differs across layers
AUX_TOL = 1e-5     # the summed MoE load-balance losses, absolute
MULTISTEP_TOL = 5e-3  # as tests/test_models.py: multistep decode vs the uncached forward

_jax_scan = jax.jit(jref.selective_scan)
_jax_mamba = jax.jit(JSsm.mamba_forward, static_argnums=(1,))
_jax_ssm_inputs = jax.jit(JSsm._mamba_ssm_inputs, static_argnums=(1,))
_jax_route = jax.jit(JMoe.route, static_argnums=(1,))
_jax_expert_ffn = jax.jit(JMoe.expert_ffn_local, static_argnums=(1,))
_jax_moe = jax.jit(JMoe.moe_forward, static_argnums=(1,))


def rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9)


def t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return t(tree)


def _scan_inputs(B, L, D, N, seed):
    """As tests/test_kernels.py draws them: x ~ 0.5 N(0, 1), dt =
    softplus(N(0, 1)), A = -exp(0.3 N(0, 1)), B, C ~ N(0, 1), h0 ~ 0.5 N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((B, L, D))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, D)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal((D, N))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, L, N), dtype=np.float32) for _ in range(2))
    h0 = (0.5 * rng.standard_normal((B, N, D))).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


# -------------------------------------------------------------------- scan
@pytest.mark.parametrize("L", [1, 37, 130])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_matches_jax_oracle(dtype, with_h0, L):
    """y and h_last of the plain scan against `repro`'s oracle, at a (D, N)
    of (20, 5), aligned to nothing; x, dt, B and C in ``dtype`` (as the JAX
    package's kernel test passes them), A and h0 f32.  The oracle upcasts
    its inputs to f32 and rounds y to x's dtype at the end, so it gets the
    same values in f32 (and zeros for no h0): one compile per L."""
    x, dt, A, Bm, Cm, h0 = _scan_inputs(2, L, 20, 5, 0)
    tdt = getattr(torch, dtype)
    targs = [t(a).to(tdt) for a in (x, dt)] + [t(A)] + [t(a).to(tdt) for a in (Bm, Cm)]
    targs.append(t(h0) if with_h0 else None)
    jh0 = h0 if with_h0 else np.zeros_like(h0)
    y_exp, h_exp = _jax_scan(*(jnp.asarray(a.float().numpy()) for a in targs[:5]), jnp.asarray(jh0))
    y, h = ref.selective_scan(*targs)
    assert y.dtype == tdt and y.shape == (2, L, 20)
    assert h.dtype == torch.float32 and h.shape == (2, 5, 20) and h.is_contiguous()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert rel_err(y.float().numpy(), np.asarray(y_exp.astype(jnp.dtype(dtype)).astype(jnp.float32))) < tol
    assert rel_err(h.numpy(), h_exp) < tol
    y_op, h_op = ops.selective_scan(*targs)
    assert torch.equal(y_op, y) and torch.equal(h_op, h)


@pytest.mark.parametrize("split", [64, 50])
def test_selective_scan_carries_state(split):
    """Scanning two halves with the state carried == scanning the whole
    (tests/test_kernels.py:102), split at a chunk boundary and off one."""
    x, dt, A, Bm, Cm, _ = (t(a) for a in _scan_inputs(1, 128, 16, 8, 3))
    y_full, h_full = ref.selective_scan(x, dt, A, Bm, Cm)
    y1, h1 = ref.selective_scan(x[:, :split], dt[:, :split], A, Bm[:, :split], Cm[:, :split])
    y2, h2 = ref.selective_scan(x[:, split:], dt[:, split:], A, Bm[:, split:], Cm[:, split:], h1)
    assert rel_err(torch.cat([y1, y2], 1).numpy(), y_full.numpy()) < F32_TOL
    assert rel_err(h2.numpy(), h_full.numpy()) < F32_TOL


def test_chunked_selective_scan_on_cpu_takes_the_plain_version_and_launches_nothing():
    reset_launch_counts()
    x, dt, A, Bm, Cm, h0 = (t(a) for a in _scan_inputs(2, 9, 12, 4, 2))
    got, want = chunked_selective_scan(x, dt, A, Bm, Cm, h0), ref.selective_scan(x, dt, A, Bm, Cm, h0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert chunked_selective_scan.launches == 0


def test_chunked_selective_scan_never_falls_back_off_the_cpu():
    x, A, bc = (torch.empty(shape, device="meta") for shape in ((1, 4, 8), (8, 4), (1, 4, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        chunked_selective_scan(x, x, A, bc, bc)


# ------------------------------------------------------------------- Mamba
def _mamba_params(cfg, seed):
    """A Mamba parameter dict of `repro`'s layout drawn with numpy at the
    scales of `mamba_init`, but with a non-zero conv bias and dt bias, so
    the bias terms are exercised."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: JSsm.mamba_init(jax.random.key(0), cfg, jnp.float32))

    def leaf(path, s):
        name = path[-1].key
        if name == "A_log":
            return np.broadcast_to(np.log(np.arange(1, s.shape[1] + 1, dtype=np.float32)), s.shape).copy()
        if name == "D":
            return np.ones(s.shape, np.float32)
        scale = {"conv_w": 0.1, "conv_b": 0.1, "b": 0.5}.get(name, s.shape[0] ** -0.5)
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_mamba_ssm_inputs_match_jax():
    cfg = JSMOKE[ARCH]
    p = _mamba_params(cfg, 1)
    xc = np.random.default_rng(1).standard_normal((2, 11, cfg.ssm_expand * cfg.d_model), dtype=np.float32)
    exp = _jax_ssm_inputs(p, cfg, jnp.asarray(xc))
    got = ssm._mamba_ssm_inputs(_to_torch(p), SMOKE_ARCHS[ARCH], t(xc))
    for name, g, e in zip(("dt", "A", "B", "C"), got, exp):
        assert g.dtype == torch.float32 and tuple(g.shape) == e.shape, name
        assert rel_err(g.numpy(), e) < F32_TOL, name


@pytest.mark.parametrize("mode", ["no_cache", "prefill", "decode"])
def test_mamba_block_matches_jax(mode):
    """mamba_forward without a cache, prefilling a cache from a random state
    (the scan reads its h), and one decode step from a random state: the
    output, the conv tail and h, written in place."""
    cfg = JSMOKE[ARCH]
    rng = np.random.default_rng(3)
    p = _mamba_params(cfg, 3)
    L = 1 if mode == "decode" else 21
    x = rng.standard_normal((2, L, cfg.d_model), dtype=np.float32)
    cache = None
    if mode != "no_cache":
        shapes = jax.eval_shape(lambda: JSsm.mamba_cache_init(cfg, 2, jnp.float32))
        cache = {k: (0.5 * rng.standard_normal(s.shape)).astype(np.float32) for k, s in shapes.items()}
    exp, jnew = _jax_mamba(p, cfg, jnp.asarray(x), cache=None if cache is None else jax.tree.map(jnp.asarray, cache))
    tcache = None if cache is None else {k: t(v) for k, v in cache.items()}
    got, new = ssm.mamba_forward(_to_torch(p), SMOKE_ARCHS[ARCH], t(x), cache=tcache)
    assert got.shape == (2, L, cfg.d_model)
    assert rel_err(got.numpy(), exp) < BLOCK_TOL
    if cache is None:
        assert new is None and jnew is None
        return
    assert new is tcache and sorted(new) == sorted(jnew) == ["conv", "h"]  # written in place
    for name in jnew:
        assert rel_err(new[name].numpy(), jnew[name]) < BLOCK_TOL, name


# --------------------------------------------------------------------- MoE
_MOE_PARAMS: dict = {}


def _moe_params(arch):
    """`repro`'s moe_init layout (router, stacked w1 / w3 / w2, shared MLP),
    drawn with numpy at its scales: N(0, 1 / d_in)."""
    if arch not in _MOE_PARAMS:
        shapes = jax.eval_shape(lambda: JMoe.moe_init(jax.random.key(0), JSMOKE[arch], jnp.float32))
        rng = np.random.default_rng(5)
        p = jax.tree.map(lambda s: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])).astype(np.float32), shapes)
        _MOE_PARAMS[arch] = (p, _to_torch(p))
    return _MOE_PARAMS[arch]


@pytest.mark.parametrize("arch", [ARCH, QWEN])
def test_route_matches_jax(arch):
    cfg = JSMOKE[arch]
    jp, tp = _moe_params(arch)
    x = np.random.default_rng(6).standard_normal((40, cfg.d_model), dtype=np.float32)
    ids, gates, aux = _jax_route(jp, cfg, jnp.asarray(x))
    tids, tgates, taux = moe.route(tp, SMOKE_ARCHS[arch], t(x))
    assert tids.shape == (40, cfg.top_k) and np.array_equal(tids.numpy(), np.asarray(ids))
    assert rel_err(tgates.numpy(), gates) < F32_TOL
    np.testing.assert_allclose(tgates.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert abs(float(taux) - float(aux)) < F32_TOL * abs(float(aux))


@pytest.mark.parametrize("arch", [ARCH, QWEN])
def test_expert_ffn_local_matches_jax(arch):
    cfg = JSMOKE[arch]
    jp, tp = _moe_params(arch)
    x = (0.5 * np.random.default_rng(7).standard_normal((33, cfg.d_model))).astype(np.float32)
    exp, jaux = _jax_expert_ffn(jp, cfg, jnp.asarray(x))
    got, aux = moe.expert_ffn_local(tp, SMOKE_ARCHS[arch], t(x))
    assert got.shape == (33, cfg.d_model) and got.dtype == torch.float32
    assert rel_err(got.numpy(), exp) < F32_TOL
    assert abs(float(aux) - float(jaux)) < AUX_TOL


@pytest.mark.parametrize("arch", [ARCH, QWEN])
def test_moe_forward_matches_jax(arch):
    """(B, S, d) in, routed experts plus, for qwen2-moe, its shared experts."""
    cfg = JSMOKE[arch]
    jp, tp = _moe_params(arch)
    assert ("shared" in jp) == (arch == QWEN) == ("shared" in tp)
    x = (0.5 * np.random.default_rng(8).standard_normal((2, 9, cfg.d_model))).astype(np.float32)
    exp, jaux = _jax_moe(jp, cfg, jnp.asarray(x))
    got, aux = moe.moe_forward(tp, SMOKE_ARCHS[arch], t(x))
    assert got.shape == (2, 9, cfg.d_model)
    assert rel_err(got.numpy(), exp) < F32_TOL
    assert abs(float(aux) - float(jaux)) < AUX_TOL


def test_moe_init_stacks_the_experts():
    cfg = SMOKE_ARCHS[QWEN]
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    assert p["w1"].shape == p["w3"].shape == (E, d, f) and p["w2"].shape == (E, f, d)
    assert p["router"]["w"].shape == (d, E) and p["shared"]["w1"]["w"].shape == (d, f * cfg.n_shared_experts)
    assert {p[k].dtype for k in ("w1", "w2", "w3")} == {torch.bfloat16}


# ------------------------------------------------------------------ models
_MODEL: dict = {}


def _numpy_params(shapes, rng):
    """A parameter tree of the JAX model's layout drawn with numpy at the
    scales of its init: dense and expert weights N(0, 1 / d_in), biases 0,
    norm scales 1, the conv taps N(0, 0.1^2), the embedding N(0, 0.02^2),
    Mamba's A_log = log(1 .. N) and D = 1.  Compiling ``Model.init`` would
    cost more than the rest of the file."""
    def leaf(path, s):
        names = [getattr(p, "key", None) for p in path]
        normal = rng.standard_normal(s.shape, dtype=np.float32)
        if names[-1] in ("b", "conv_b"):
            return np.zeros(s.shape, np.float32)
        if names[-1] == "conv_w":
            return 0.1 * normal
        if names[-1] == "A_log":
            return np.broadcast_to(np.log(np.arange(1, s.shape[-1] + 1, dtype=np.float32)), s.shape).copy()
        if names[-1] == "D" or {"mix_norm", "ffn_norm", "final_norm"} & set(names):
            return np.ones(s.shape, np.float32)
        if "embed" in names:
            return 0.02 * normal
        return normal / np.sqrt(s.shape[-2], dtype=np.float32)  # (..., d_in, d_out)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _compiled(fn, *args):
    """``fn`` compiled for ``args`` at XLA's backend optimization level 0:
    the same f32 function (its sums in another order, within 1e-5 of the
    default build's logits here) at less than half the compile time."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})


def jax_model(arch=ARCH):
    """One JAX model and one parameter tree (numpy) per config for the file."""
    if arch not in _MODEL:
        jm = JModel(JSMOKE[arch])
        shapes = jax.eval_shape(jm.init, jax.random.key(0))
        _MODEL[arch] = (jm, _numpy_params(shapes, np.random.default_rng(0)))
    return _MODEL[arch]


def port_model(arch=ARCH):
    jm, tree = jax_model(arch)
    return load_jax_params(Model(SMOKE_ARCHS[arch], device="cpu"), tree)


SEQ, MAX_SEQ, N_DECODE = 70, 80, 5
_PREFILL: dict = {}


def jax_prefill(arch=ARCH):
    """`repro`'s cached prefill of (2, SEQ) tokens from an empty cache of
    MAX_SEQ slots: (tokens (2, SEQ + N_DECODE), logits, aux loss, cache),
    one compile per config for the file.  From an empty cache the prefill
    computes what the uncached forward does (attention over the SEQ tokens,
    the Mamba state from zero), so its logits and aux are the uncached
    forward's too."""
    if arch not in _PREFILL:
        jm, tree = jax_model(arch)

        def fwd(p, x, cache):
            out = jm.forward(p, x, cache=cache, idx=0)
            return out.logits, out.aux_loss, out.cache

        toks = np.random.default_rng(5).integers(0, jm.cfg.vocab_size, (2, SEQ + N_DECODE)).astype(np.int32)
        args = (tree, jnp.asarray(toks[:, :SEQ]), jm.init_cache(2, MAX_SEQ))
        logits, aux, cache = _compiled(fwd, *args)(*args)
        _PREFILL[arch] = (toks, np.asarray(logits), float(aux), jax.tree.map(np.asarray, cache))
    return _PREFILL[arch]


@pytest.mark.parametrize("arch", [ARCH, QWEN])
def test_model_logits_and_aux_match_jax(arch):
    """jamba's smoke macro-block (Mamba x7 + attention, dense and MoE FFNs
    alternating) and qwen2-moe's (attention + MoE with shared experts): the
    port's uncached forward against `repro`'s logits and summed aux loss."""
    model = port_model(arch)
    if arch == ARCH:
        assert [s.mixer for s in model.specs].count("mamba") == 7
        assert [s.ffn for s in model.specs] == ["dense", "moe"] * 4
    toks, exp, jaux, _ = jax_prefill(arch)
    out = model(t(toks[:, :SEQ]).long())
    assert out.logits.shape == exp.shape == (2, SEQ, model.cfg.vocab_size)
    assert rel_err(out.logits.numpy(), exp) < MODEL_TOL
    assert float(out.aux_loss) > 0 and abs(float(out.aux_loss) - jaux) < AUX_TOL


def test_bf16_deviation_matches_jax():
    """The same weights rounded to bf16 move jamba's logits far from the f32
    ones (beyond 5e-2 here): a few tokens' top-2 experts change under the
    rounding, and the attention and the Mamba recurrence carry the change
    to later tokens.  `repro` does the same; the port's deviation must be of
    the same size as `repro`'s, which is why ``chip_smoke.py`` holds jamba's
    bf16 path block by block at 5e-2 and the whole model within a factor of
    `repro`'s own distance at full width.  A_log and D stay f32 in both."""
    _, tree = jax_model()
    toks, j32, _, _ = jax_prefill()
    cfg16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jm16 = JModel(JSMOKE[ARCH].replace(**cfg16))
    tree16 = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in ("A_log", "D") else jnp.asarray(a, jnp.bfloat16), tree)
    args = (tree16, jnp.asarray(toks[:, :SEQ]))
    j16 = _compiled(lambda p, x: jm16.forward(p, x).logits.astype(jnp.float32), *args)(*args)
    model = port_model()
    m16 = Model(SMOKE_ARCHS[ARCH].replace(**cfg16), device="cpu")
    m16.load_state_dict(model.state_dict())
    x = t(toks[:, :SEQ]).long()
    ours = rel_err(m16(x).logits.float().numpy(), model(x).logits.numpy())
    theirs = rel_err(np.asarray(j16), j32)
    assert theirs > 0.05 and 0.5 < ours / theirs < 2.0, (ours, theirs)


def test_prefill_then_decode_matches_uncached_forward_and_jax():
    """Prefill SEQ tokens into the cache, decode N_DECODE more
    (tests/test_models.py:72-88): the prefill's logits and its caches
    (Mamba's conv tail and h, attention's K/V, carried over by
    `load_jax_cache`) against `repro`'s cached prefill, and each decode
    step against the port's uncached forward."""
    model = port_model()
    toks, exp, _, jcache = jax_prefill()
    full = model(t(toks).long()).logits
    cache = model.init_cache(2, MAX_SEQ)
    out = model(t(toks[:, :SEQ]).long(), cache=cache, idx=0)
    assert out.cache is cache
    assert rel_err(out.logits.numpy(), exp) < MODEL_TOL
    theirs = load_jax_cache(model, jcache)
    assert [sorted(c) for c in theirs] == [sorted(c) for c in cache]
    assert [sorted(c) for c in cache if "h" in c] == [["conv", "h"]] * 7
    for ours, their in zip(cache, theirs):
        for name, v in ours.items():
            assert their[name].dtype == v.dtype and their[name].shape == v.shape, name
            assert rel_err(v.numpy(), their[name].numpy()) < MODEL_TOL, name
    for i in range(SEQ, SEQ + N_DECODE):
        logits = model(t(toks[:, i : i + 1]).long(), cache=cache, idx=i).logits[:, 0]
        assert rel_err(logits.numpy(), full[:, i].numpy()) < MULTISTEP_TOL, i


def test_init_cache_and_load_jax_cache_keep_state_names_and_dtypes():
    cfg16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jm = JModel(JSMOKE[ARCH].replace(**cfg16))
    jcache = jm.init_cache(3, 40)
    model = Model(SMOKE_ARCHS[ARCH].replace(**cfg16), device="cpu")
    cache = model.init_cache(3, 40)
    loaded = load_jax_cache(model, jax.tree.map(np.asarray, jcache))
    names = [sorted(c) for c in cache]
    assert names == [sorted(c) for c in loaded] == [["conv", "h"]] * 4 + [["k", "v"]] + [["conv", "h"]] * 3
    di, N = 2 * 128, 8
    for ours, theirs in zip(cache, loaded):
        for name, v in ours.items():
            assert (v.shape, v.dtype) == (theirs[name].shape, theirs[name].dtype), name
            assert v.dtype == (torch.float32 if name == "h" else torch.bfloat16)
            assert not v.any()
        if "h" in ours:
            assert ours["h"].shape == (3, N, di) and ours["conv"].shape == (3, 3, di)
    assert model.layers[0]["mix"]["A_log"].dtype == model.layers[0]["mix"]["D"].dtype == torch.float32


# ------------------------------------------------------------------ profile
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_profile_model_on_cpu_smoke(mode):
    reset_launch_counts()
    profile, executor = serve.profile_model(ARCH, batches=(1, 2), seq=8, smoke=True, device="cpu",
                                            reps=1, mode=mode, ctx=12)
    assert sorted(c.batch for c in profile.configs) == [1, 2]
    assert {c.hardware for c in profile.configs} == {"cpu"} and all(c.duration > 0 for c in profile.configs)
    executor(1)
    assert chunked_selective_scan.launches == 0  # CPU tensors take the plain version
