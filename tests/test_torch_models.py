"""Port layers and models vs `repro.models` on the CPU, fed the same numpy
parameters and inputs (JAX-initialized parameters carried over by the bridge)."""
import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS, SMOKE_ARCHS as JSMOKE  # noqa: E402
from repro.models import Model as JModel, layers as JL, segmentize as jsegmentize  # noqa: E402
from repro_torch.configs import ARCHS, SMOKE_ARCHS  # noqa: E402
from repro_torch.models import Model, layers as L, load_jax_params, segmentize  # noqa: E402

F32_TOL = 2e-5  # as tests/test_kernels.py
MODEL_TOL = 1e-4  # whole forward: GEMM summation order differs across layers

# the JAX side jitted: one compile per function and shape instead of one per op
_jax_rope = jax.jit(JL.apply_rope, static_argnums=(2, 3))
_jax_mlp = jax.jit(JL.mlp_forward, static_argnums=(2,))
_jax_attn = jax.jit(JL.attn_forward, static_argnums=(1, 2))


def rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9)


def to_torch(tree):
    """A JAX parameter pytree as nested dicts of CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def positions(cfg, B, S):
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    if cfg.mrope_sections is not None:
        pos = np.broadcast_to(pos, (3, B, S))
    return np.ascontiguousarray(pos)


@pytest.mark.parametrize("mrope", [None, (2, 3, 3)])
def test_apply_rope_matches_jax(mrope):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32)
    shape = (2, 7) if mrope is None else (3, 2, 7)
    pos = rng.integers(0, 50, shape).astype(np.int32)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0, mrope)
    exp = _jax_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, mrope)
    assert rel_err(got.numpy(), exp) < F32_TOL


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_forward_matches_jax(act):
    p = JL.mlp_init(jax.random.key(1), 48, 80, jnp.float32)
    x = np.random.default_rng(1).standard_normal((2, 5, 48), dtype=np.float32)
    got = L.mlp_forward(to_torch(p), torch.from_numpy(x), act)
    exp = _jax_mlp(p, jnp.asarray(x), act)
    assert rel_err(got.numpy(), exp) < F32_TOL


@pytest.mark.parametrize(
    "arch,layer",
    [
        ("smollm-360m", 0),   # GQA g=3
        ("gemma3-1b", 0),     # local: window, qk-norm, (1+w) norm, own theta
        ("gemma3-1b", 5),     # global
        ("qwen2-vl-2b", 0),   # qkv bias, M-RoPE
    ],
)
def test_attn_forward_matches_jax(arch, layer):
    cfg = JSMOKE[arch]
    spec = cfg.layer_specs()[layer]
    p = JL.attn_init(jax.random.key(2), cfg, jnp.float32)
    if cfg.qkv_bias:  # non-zero biases, so the test sees them
        p = {k: ({**v, "b": v["b"] + 0.1} if "b" in v else v) for k, v in p.items()}
    if cfg.qk_norm:
        p["qn"] = {"w": p["qn"]["w"] + 0.3}
    x = np.random.default_rng(2).standard_normal((2, 24, cfg.d_model), dtype=np.float32)
    pos = positions(cfg, 2, 24)
    got, _ = L.attn_forward(to_torch(p), SMOKE_ARCHS[arch], spec, torch.from_numpy(x), torch.from_numpy(pos))
    exp, _ = _jax_attn(p, cfg, spec, jnp.asarray(x), jnp.asarray(pos))
    assert rel_err(got.numpy(), exp) < F32_TOL


@pytest.fixture(scope="module")
def smollm_jax():
    """JAX smollm-360m (smoke) with Model.init(key 0) parameters, as numpy."""
    jm = JModel(JSMOKE["smollm-360m"])
    return jm, jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0)))


def _logits_pair(jm, tree, model, seed=3):
    """Logits of the JAX model on ``tree`` and of the port ``model`` on one input."""
    cfg = jm.cfg
    fwd = jax.jit(lambda p, t, e: jm.forward(p, t, embeds=e).logits)
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        emb = (0.1 * rng.standard_normal((2, 16, cfg.d_model))).astype(np.float32)
        return fwd(tree, None, jnp.asarray(emb)), model(embeds=torch.from_numpy(emb)).logits
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return fwd(tree, jnp.asarray(toks), None), model(torch.from_numpy(toks).long()).logits


def test_smollm_logits_from_jax_init_match_jax(smollm_jax):
    """JAX Model.init(key 0) -> numpy -> load_jax_params -> the port."""
    jm, tree = smollm_jax
    model = load_jax_params(Model(SMOKE_ARCHS["smollm-360m"], device="cpu"), tree)
    exp, got = _logits_pair(jm, tree, model)
    assert got.shape == exp.shape
    assert rel_err(got.numpy(), exp) < MODEL_TOL


def _export(model):
    """The port's parameters in the JAX pytree layout (repeats stacked)."""
    def plain(mod):
        if isinstance(mod, torch.nn.ParameterDict):
            return {k: v.detach().numpy() for k, v in mod.items()}
        return {k: plain(v) for k, v in mod.items()}

    tree = {"embed": plain(model.embed), "final_norm": plain(model.final_norm), "segments": []}
    if hasattr(model, "head"):
        tree["head"] = plain(model.head)
    i = 0
    for pattern, repeats in model.segments:
        per_rep = [[plain(model.layers[i + r * len(pattern) + j]) for j in range(len(pattern))]
                   for r in range(repeats)]
        if repeats == 1:
            tree["segments"].append(tuple(per_rep[0]))
        else:
            tree["segments"].append(tuple(
                jax.tree.map(lambda *xs: np.stack(xs), *[per_rep[r][j] for r in range(repeats)])
                for j in range(len(pattern))))
        i += len(pattern) * repeats
    return tree


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-vl-2b", "musicgen-medium"])
def test_smoke_model_logits_match_jax(arch):
    """The port's seeded weights, carried to the JAX model in its layout."""
    model = Model(SMOKE_ARCHS[arch], seed=5, device="cpu")
    tree = _export(model)
    exp, got = _logits_pair(JModel(JSMOKE[arch]), tree, model)
    assert got.shape == exp.shape
    assert rel_err(got.numpy(), exp) < MODEL_TOL
    again = load_jax_params(Model(SMOKE_ARCHS[arch], seed=6, device="cpu"), tree)
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), model.parameters()))


def test_bridge_raises_on_keys_it_does_not_consume(smollm_jax):
    _, tree = smollm_jax
    fresh = lambda: Model(SMOKE_ARCHS["smollm-360m"], device="cpu")  # noqa: E731
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(fresh(), {**tree, "extra": {"w": np.zeros(3)}})
    blk = dict(tree["segments"][0][0])
    blk["mix"] = {**blk["mix"], "qn": {"w": np.ones((2, 64), np.float32)}}
    with pytest.raises(KeyError, match="qn"):
        load_jax_params(fresh(), {**tree, "segments": [(blk,)]})
    no_norm = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        load_jax_params(fresh(), no_norm)


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_apply_norm_matches_jax(norm):
    cfg = JSMOKE["musicgen-medium" if norm == "ln" else "gemma3-1b"]
    rng = np.random.default_rng(4)
    p = {k: (1.0 + 0.1 * rng.standard_normal(40)).astype(np.float32) for k in ("w", "b")}
    if norm == "rms":
        del p["b"]
    x = rng.standard_normal((3, 5, 40), dtype=np.float32)
    got = L.apply_norm(SMOKE_ARCHS[cfg.name], {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    exp = jax.jit(JL.apply_norm, static_argnums=0)(cfg, p, jnp.asarray(x))
    assert rel_err(got.numpy(), exp) < F32_TOL


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_segmentize_copy_matches_jax(arch):
    def plain(segments):
        return [(tuple(dataclasses.astuple(s) for s in pat), r) for pat, r in segments]

    assert plain(segmentize(ARCHS[arch].layer_specs())) == plain(jsegmentize(JARCHS[arch].layer_specs()))


@pytest.mark.parametrize("arch", ["deepseek-v3-671b"])
def test_unported_layers_name_their_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(SMOKE_ARCHS[arch], device="cpu")


def test_model_runs_on_cuda_by_default():
    assert inspect.signature(Model).parameters["device"].default == "cuda"
