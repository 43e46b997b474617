"""The port's KV-cache path vs `repro` on the CPU: the decode oracle, the
cache branches of `attn_forward`, `Model` prefill + decode, the serving step
functions and the decode profile, fed the same numpy inputs and parameters.

On CPU tensors `flash_decode` runs its plain version; the kernel itself is
held against that on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SMOKE_ARCHS as JSMOKE  # noqa: E402
from repro.configs.base import InputShape as JInputShape  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import Model as JModel, layers as JL  # noqa: E402
from repro_torch.configs import SMOKE_ARCHS  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.kernels import flash_decode, ops, ref, reset_launch_counts  # noqa: E402
from repro_torch.launch import serve, specs  # noqa: E402
from repro_torch.models import Model, layers as L, load_jax_cache, load_jax_params  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # as tests/test_kernels.py
PREFILL_DECODE_TOL = 2e-3  # as tests/test_models.py: prefill + one decode step
MULTISTEP_TOL = 5e-3       # as tests/test_models.py: multistep and ring decode
_jax_decode = jax.jit(jref.decode_attention, static_argnames=("window", "scale"))
_jax_attn = jax.jit(JL.attn_forward, static_argnums=(1, 2))


def rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ oracle
DECODE_CASES = [
    # (B, S, Hq, Hkv, Dk, Dv, window): tests/test_kernels.py's sweep ...
    (2, 256, 4, 2, 64, 64, None),
    (3, 512, 4, 1, 128, 128, None),   # MQA
    (2, 256, 8, 8, 64, 64, 100),      # window
    (1, 256, 4, 1, 192, 128, None),   # MLA-absorbed: Dk != Dv
    # ... plus ragged S and Dk != Dv
    (3, 77, 6, 2, 32, 32, None),
    (2, 77, 4, 1, 48, 24, 20),
]


def _lengths(B, S):
    """Ragged per-row lengths that include 1 and S."""
    lens = [(S * (i + 1)) // (B + 1) + 1 for i in range(B)]
    lens[0] = 1
    if B > 1:
        lens[-1] = S
    return np.asarray(lens, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,Dk,Dv,window", DECODE_CASES)
def test_decode_attention_matches_jax_oracle(B, S, Hq, Hkv, Dk, Dv, window, dtype):
    rng = np.random.default_rng(0)
    q, kc, vc = (rng.standard_normal(s, dtype=np.float32) for s in ((B, Hq, Dk), (B, S, Hkv, Dk), (B, S, Hkv, Dv)))
    lens = _lengths(B, S)
    got = ref.decode_attention(*(t(a).to(getattr(torch, dtype)) for a in (q, kc, vc)), t(lens), window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, Hq, Dv)
    exp = _jax_decode(*(jnp.asarray(a).astype(dtype) for a in (q, kc, vc)), jnp.asarray(lens), window=window)
    assert rel_err(got.float().numpy(), exp) < TOL[dtype]


@pytest.mark.parametrize("window", [None, 100])
def test_plain_decode_matches_pallas_flash_decode(window):
    """At an aligned shape, the Pallas kernel in interpret mode (as
    tests/test_kernels.py runs it) against the port's plain version."""
    from repro.kernels.decode_attention import flash_decode as pallas_flash_decode

    rng = np.random.default_rng(1)
    q, kc, vc = (rng.standard_normal(s, dtype=np.float32) for s in ((2, 6, 64), (2, 256, 2, 64), (2, 256, 2, 64)))
    lens = np.asarray([130, 256], np.int32)
    exp = pallas_flash_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
                              window=window, block_k=128, interpret=True)
    got = ref.decode_attention(t(q), t(kc), t(vc), t(lens), window=window)
    assert rel_err(got.numpy(), exp) < TOL["float32"]


def test_flash_decode_on_cpu_takes_the_plain_version_and_launches_nothing():
    reset_launch_counts()
    rng = np.random.default_rng(2)
    q, kc, vc = (t(rng.standard_normal(s, dtype=np.float32)) for s in ((2, 6, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    lens = t(np.asarray([4, 9], np.int32))
    assert torch.equal(ops.decode_attention(q, kc, vc, lens, window=3),
                       ref.decode_attention(q, kc, vc, lens, window=3))
    assert flash_decode.launches == 0


def test_flash_decode_never_falls_back_off_the_cpu():
    q, kc = torch.empty((1, 4, 8), device="meta"), torch.empty((1, 5, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q, kc, kc, torch.empty((1,), dtype=torch.int32, device="meta"))


# ------------------------------------------------------------------ layers
def _attn_params(cfg, seed):
    p = JL.attn_init(jax.random.key(seed), cfg, jnp.float32)
    if cfg.qk_norm:
        p["qn"] = {"w": p["qn"]["w"] + 0.3}
    return p


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return t(np.array(tree))


def _positions(cfg, B, S, idx):
    pos = np.broadcast_to(np.arange(S)[None] + idx, (B, S))
    if cfg.mrope_sections is not None:
        pos = np.broadcast_to(pos, (3, B, S))
    return np.ascontiguousarray(pos).astype(np.int32)


LAYER_CASES = [
    # (arch, layer, prefill S, cache max_seq)
    ("smollm-360m", 0, 12, 32),   # S <= size
    ("gemma3-1b", 0, 24, 32),     # local: 16-slot ring, S > size rolls
    ("gemma3-1b", 5, 12, 32),     # global
]


@pytest.mark.parametrize("arch,layer,S,max_seq", LAYER_CASES)
def test_attn_forward_prefill_into_cache_matches_jax(arch, layer, S, max_seq):
    cfg = JSMOKE[arch]
    spec = cfg.layer_specs()[layer]
    p = _attn_params(cfg, 3)
    x = np.random.default_rng(3).standard_normal((2, S, cfg.d_model), dtype=np.float32)
    pos = _positions(cfg, 2, S, 0)
    jcache = JL.attn_cache_init(cfg, spec, 2, max_seq, jnp.float32)
    cache = L.attn_cache_init(SMOKE_ARCHS[arch], spec, 2, max_seq, torch.float32, "cpu")
    assert cache["k"].shape == jcache["k"].shape
    exp, jnew = _jax_attn(p, cfg, spec, jnp.asarray(x), jnp.asarray(pos), cache=jcache, idx=0)
    got, new = L.attn_forward(_to_torch(p), SMOKE_ARCHS[arch], spec, t(x), t(pos), cache=cache, idx=0)
    assert new is cache  # written in place
    assert rel_err(got.numpy(), exp) < TOL["float32"]
    for name in ("k", "v"):
        assert rel_err(cache[name].numpy(), jnew[name]) < TOL["float32"]


@pytest.mark.parametrize("arch,layer,idx", [("smollm-360m", 0, 9), ("gemma3-1b", 0, 21), ("gemma3-1b", 5, 40)])
def test_attn_forward_decode_step_matches_jax(arch, layer, idx):
    """One token against a cache of random contents: the ring write on local
    layers (slot idx % 16), the clamped write at the end of a global one."""
    cfg = JSMOKE[arch]
    spec = cfg.layer_specs()[layer]
    p = _attn_params(cfg, 4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, cfg.d_model), dtype=np.float32)
    size = min(32, spec.window) if spec.window else 32
    kc, vc = (rng.standard_normal((2, size, cfg.n_kv_heads, cfg.hdim), dtype=np.float32) for _ in range(2))
    pos = _positions(cfg, 2, 1, idx)
    exp, jnew = _jax_attn(p, cfg, spec, jnp.asarray(x), jnp.asarray(pos),
                          cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, idx=idx)
    cache = {"k": t(kc.copy()), "v": t(vc.copy())}
    got, _ = L.attn_forward(_to_torch(p), SMOKE_ARCHS[arch], spec, t(x), t(pos), cache=cache, idx=idx)
    assert rel_err(got.numpy(), exp) < TOL["float32"]
    for name in ("k", "v"):
        assert rel_err(cache[name].numpy(), jnew[name]) < TOL["float32"]


# ------------------------------------------------------------------ models
_MODELS: dict = {}


def jax_model(arch):
    """One JAX Model.init(key 0) per architecture for the whole file, as numpy."""
    if arch not in _MODELS:
        jm = JModel(JSMOKE[arch])
        _MODELS[arch] = (jm, jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0))))
    return _MODELS[arch]


def port_model(arch):
    jm, tree = jax_model(arch)
    return load_jax_params(Model(SMOKE_ARCHS[arch], device="cpu"), tree)


def _jax_step(jm):
    """Jitted cached forward of the JAX model: (params, tokens, embeds, cache, idx)."""
    def fwd(params, tokens, embeds, cache, idx):
        out = jm.forward(params, tokens, embeds=embeds, cache=cache, idx=idx)
        return out.logits, out.cache

    return jax.jit(fwd)


def _inputs(cfg, B, S, seed):
    """(tokens, embeds) for S positions: one of them None, by the arch's input mode."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        return None, (0.1 * rng.standard_normal((B, S, cfg.d_model))).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32), None


def _cut(a, lo, hi):
    return None if a is None else a[:, lo:hi]


def _port_step(model, tokens, embeds, cache, idx):
    out = model(None if tokens is None else t(tokens).long(), embeds=None if embeds is None else t(embeds),
                cache=cache, idx=idx)
    return out.logits, out.cache


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma3-1b", "qwen2-vl-2b", "musicgen-medium"])
def test_model_prefill_then_decode_matches_jax(arch):
    jm, tree = jax_model(arch)
    model = port_model(arch)
    B, S = 2, 12
    toks, emb = _inputs(jm.cfg, B, S, 5)
    step = _jax_step(jm)
    jlog, jcache = step(tree, _cut(toks, 0, S - 1), _cut(emb, 0, S - 1), jm.init_cache(B, 32), 0)
    jlog, jcache = step(tree, _cut(toks, S - 1, S), _cut(emb, S - 1, S), jcache, S - 1)
    cache = model.init_cache(B, 32)
    _, got_cache = _port_step(model, _cut(toks, 0, S - 1), _cut(emb, 0, S - 1), cache, 0)
    assert got_cache is cache
    logits, _ = _port_step(model, _cut(toks, S - 1, S), _cut(emb, S - 1, S), cache, S - 1)
    assert logits.shape == (B, 1, jm.cfg.vocab_size)
    assert rel_err(logits.numpy(), jlog) < PREFILL_DECODE_TOL
    for ours, theirs in zip(cache, load_jax_cache(model, jax.tree.map(np.asarray, jcache))):
        for name in ("k", "v"):
            assert rel_err(ours[name].numpy(), theirs[name].numpy()) < PREFILL_DECODE_TOL


@pytest.mark.parametrize("arch,S,max_seq,n_dec", [
    ("smollm-360m", 8, 32, 5),
    ("gemma3-1b", 24, 26, 2),  # a 24-token prefill wraps the 16-slot rings of the local layers
])
def test_multistep_decode_matches_jax(arch, S, max_seq, n_dec):
    jm, tree = jax_model(arch)
    model = port_model(arch)
    toks, _ = _inputs(jm.cfg, 1, S + n_dec, 6)
    step = _jax_step(jm)
    jlog, jcache = step(tree, toks[:, :S], None, jm.init_cache(1, max_seq), 0)
    cache = model.init_cache(1, max_seq)
    _port_step(model, toks[:, :S], None, cache, 0)
    for i in range(n_dec):
        jlog, jcache = step(tree, toks[:, S + i : S + i + 1], None, jcache, S + i)
        logits, _ = _port_step(model, toks[:, S + i : S + i + 1], None, cache, S + i)
        assert rel_err(logits.numpy(), jlog) < MULTISTEP_TOL, i


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma3-1b", "qwen2-vl-2b", "musicgen-medium"])
def test_init_cache_shapes_match_jax(arch):
    jm = JModel(JSMOKE[arch])
    jcache = jax.eval_shape(lambda: jm.init_cache(3, 40))
    model = Model(SMOKE_ARCHS[arch], device="cpu")
    cache = model.init_cache(3, 40)
    # JAX stacks a repeated segment's layers on a leading axis, repeat-major
    flat = [
        {k: v.shape[1:] if repeats > 1 else v.shape for k, v in seg[j].items()}
        for seg, (pattern, repeats) in zip(jcache, jm.segments) for _ in range(repeats) for j in range(len(pattern))
    ]
    assert len(cache) == len(flat) == len(model.layers)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in cache] == [
        {k: tuple(s) for k, s in f.items()} for f in flat]
    assert all(v.dtype == model.cdtype and not v.any() for c in cache for v in c.values())


def test_prefill_and_decode_fns_match_jax_specs():
    jm, tree = jax_model("smollm-360m")
    model = port_model("smollm-360m")
    B, S = 2, 10
    toks, _ = _inputs(jm.cfg, B, S + 1, 7)
    jlast, jcache = jax.jit(jspecs.make_prefill_fn(jm, JInputShape("p", S, B, "prefill")))(
        tree, {"tokens": jnp.asarray(toks[:, :S])})
    last, cache = specs.make_prefill_fn(model, InputShape("p", S, B, "prefill"))({"tokens": t(toks[:, :S]).long()})
    assert last.shape == (B, jm.cfg.vocab_size)
    assert rel_err(last.numpy(), jlast) < PREFILL_DECODE_TOL
    jdec, _ = jax.jit(jspecs.make_decode_fn(jm))(
        tree, {"tokens": jnp.asarray(toks[:, S:]), "cache": jcache, "idx": S - 1})
    dec, new = specs.make_decode_fn(model)({"tokens": t(toks[:, S:]).long(), "cache": cache, "idx": S - 1})
    assert new is cache
    assert rel_err(dec.numpy(), jdec) < PREFILL_DECODE_TOL


# ------------------------------------------------------------------ profile
def test_profile_model_decode_on_cpu_smoke():
    reset_launch_counts()
    profile, executor = serve.profile_model("smollm-360m", batches=(1, 2, 4), smoke=True, device="cpu",
                                            reps=1, mode="decode", ctx=16)
    assert sorted(c.batch for c in profile.configs) == [1, 2, 4]
    assert {c.hardware for c in profile.configs} == {"cpu"} and all(c.duration > 0 for c in profile.configs)
    executor(3)
    with pytest.raises(ValueError, match="decode batch"):
        executor(5)
    assert flash_decode.launches == 0  # CPU tensors take the plain version
